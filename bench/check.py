"""What decides ``correct`` for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed with the longest
among them, goes through the plain reference (``bench/reference``) over
each prompt and its served tokens:

- ``target_gap``: the widest gap, over every served token, by which the
  token's reference logit lies below the reference's best at that
  position. It covers the admission prefill (the first token), the
  verify through the paged cache (every later one) and the committed
  greedy tokens.
- ``draft_gap``: the same for the drafts the program's P-EAGLE drafter
  proposed at steps of these requests (recorded as the window ran), against
  the reference drafter over the reference's own taps and context: it
  covers the drafter's ``extend`` (its cache) and ``draft_parallel``.

Greedy decoding only. The control (``prec="fp8"``) puts the reference
itself, its matrix products in float8, in the program's place (its
drafter reading its own float8 target's taps): the gap of the token the
control puts first at the same positions and anchors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.reference import model as R


def sample(requests: Sequence, n: int, seed: int) -> List:
    """Up to ``n`` finished requests: the longest (most served tokens)
    and the rest drawn from ``seed``."""
    done = [r for r in requests if r.finished and r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed), 0x5EED])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Best logit minus the chosen token's, per row."""
    return (logits.max(-1).values
            - logits.gather(-1, chosen.long()[..., None])[..., 0])


def served_readings(config: dict, tparams: dict, dparams: dict,
                    samples: Sequence, drafts: Dict[int, list], K: int,
                    seed: int, n_steps: int, device,
                    control: Optional[str] = None) -> dict:
    """The widest target and draft gaps over ``samples``. ``drafts``
    maps a request's rid to its recorded steps ``(c, program drafts (K,))``
    (c: the last committed position then); ``n_steps`` of them per request
    are drawn from ``seed``. With ``control``, the gaps are those of the
    tokens the reference in that precision puts first."""
    R.exact_matmuls()
    t, dr = config["target"], config["drafter"]
    rng = np.random.default_rng([int(seed), 0xD4AF])
    out = {"target_gap": 0.0, "draft_gap": 0.0, "served_tokens": 0,
           "drafts": 0, "requests": len(samples)}
    with torch.no_grad():
        for r in samples:
            seq = torch.as_tensor(np.concatenate([r.prompt, r.tokens]),
                                  dtype=torch.long, device=device)
            P, N = len(r.prompt), seq.shape[0]
            at = torch.arange(P - 1, N - 1, device=device)
            logits, taps = R.target_forward(t, tparams, seq, at)
            chosen = seq[P:]
            if control:
                c_logits, c_taps = R.target_forward(t, tparams, seq, at,
                                                    prec=control)
                chosen = c_logits.argmax(-1)
            out["target_gap"] = max(out["target_gap"],
                                    float(gaps(logits, chosen).max()))
            out["served_tokens"] += int(chosen.numel())
            steps = [s for s in drafts.get(r.rid, []) if 1 <= s[0] < N]
            if not steps:
                continue
            pick = rng.choice(len(steps), size=min(n_steps, len(steps)),
                              replace=False)
            steps = [steps[i] for i in sorted(pick)]
            anchors = [c - 1 for c, _ in steps]
            dl = R.draft_logits(dr, t, dparams, seq, taps, anchors, K)
            if control:
                dc = R.draft_logits(dr, t, dparams, seq, c_taps, anchors,
                                    K, prec=control)
                chosen_d = dc.argmax(-1)
            else:
                chosen_d = torch.stack([torch.as_tensor(d, device=device)
                                        for _, d in steps])
            out["draft_gap"] = max(out["draft_gap"],
                                   float(gaps(dl, chosen_d).max()))
            out["drafts"] += int(chosen_d.numel())
            del dl, taps, logits
    return out


def judge(readings: dict, limits: dict) -> Tuple[bool, dict]:
    """(correct, checks): each gap against its limit (a missing limit
    fails), at least one request and one draft compared."""
    checks = {
        "requests": {"value": readings["requests"], "limit": 1},
        "drafts": {"value": readings["drafts"], "limit": 1},
        "target_gap": {"value": readings["target_gap"],
                       "limit": limits.get("target_gap")},
        "draft_gap": {"value": readings["draft_gap"],
                      "limit": limits.get("draft_gap")},
    }
    ok = (readings["requests"] >= 1 and readings["drafts"] >= 1
          and all(checks[k]["limit"] is not None
                  and checks[k]["value"] <= checks[k]["limit"]
                  for k in ("target_gap", "draft_gap")))
    return ok, checks
