"""Batched speculative-decoding engine (PyTorch).

Counterpart of the JAX package's ``serving/engine.py``: whole-batch serving
(``prefill`` / ``step`` / ``run``, contiguous KV layout only) and the
per-slot primitives the continuous-batching scheduler drives
(``serving/scheduler.py``): ``blank_state``, ``prefill_into_slot`` (a
bucketed batch-1 admission prefill written into one slot of the live
batch), ``ensure_capacity`` (incremental page growth), ``free_slot`` and
``step`` under an active mask with per-slot budgets. Three drafter modes:

  "parallel" — P-EAGLE: one drafter forward drafts K tokens
  "ar"       — AR EAGLE-3 baseline: K sequential drafter forwards
  "none"     — vanilla autoregressive decoding (one target forward a token)

Verification policy is per request (``serving/sampling.py``): every slot
carries its own ``SamplingParams`` row in the decode state's
``"sampling"`` subtree, and one step runs the greedy prefix match for
``temperature == 0`` rows and seeded lossless rejection sampling against
the row-warped target for the rest (``core/spec_decode.mixed_verify``).
Greedy rows emit the target's greedy output in every mode: drafts only
decide how many tokens one verify forward commits. A sampled row's keys are
re-derived each step as ``fold_in(seed, position)``, so its stream is a
pure function of ``(seed, committed prefix)``, and equal to the JAX
engine's. When no slot samples, a step takes the greedy-only lane, which
launches no warp, sort or threefry op. KV caches inside the state are
updated in place by each step.

Two KV layouts: "contiguous" (every slot owns a max_len cache row) and
"paged" (every attention cache is a pool of ``page_size``-position pages
behind a per-slot ``block_table``, pages handed out by a
``cache_ops.BlockAllocator``). Unlike the JAX engine, whose paged step
gathers each slot's pages into a contiguous view and scatters it back, the
paged step reads and writes the pools through the table: phase 1 of every
decode attention against a pool runs the paged decode kernel. A local
layer's ring cache stays per slot in both layouts (and goes through the
decode kernel), and a target with rings or recurrent state admits a
prompt in power-of-two chunks instead of padding it (a pad would be
evicting live entries of a ring, or be folded into the recurrence).

A recurrent target (``models/ssm.py``, ``models/hybrid.py``) keeps its
conv window and state per slot in both layouts (an SSM target's drafter KV
is all that is paged; a hybrid's local layers are pooled beside it, or are
per-slot rings). Its verify returns the state after each token of the
block, and the commit writes the one at the last accepted token
(``cache_ops.commit``), in the same call that invalidates the attention
entries past it.

Two policies ride on the paged layout. The prefix cache
(``EngineConfig.prefix_cache``, ``serving/prefix_cache.py``) keeps the
pages of committed streams indexed by token-prefix chain; an admission
whose prompt walks a cached chain maps those pages into its table row
(refcount-shared), copies a partially matching page on write, and prefills
only the uncached suffix, in decode-mode chunks over a batch-1 view
gathered from the row's pages: token for token a cold prefill's output.
For a target with rings (local layers whose window is shorter than
max_len) or with recurrent state (the SSM and hybrid families) the cache
stays idle, no match and no insert: a page does not hold the per-slot ring
entries or the recurrent state a hit would need (for rings the JAX engine
maps the pages anyway, and its hit streams part from its cold ones; for
recurrent targets it stays idle too). So it does for an MoE target, as in
the JAX engine: expert capacity couples the tokens of a forward, so a
hit's suffix chunks would route other tokens than a cold prefill does.
Swap-to-host (``EngineConfig.swap = "host"``) parks a preempted slot's
exclusively owned pages and per-slot rows in pinned host memory
(``cache_ops.HostPagePool``) and restores them bitwise; pages shared with
the prefix cache stay resident under the handle's reference.

Model sharding (``EngineConfig(shard_model=True)``) shards *storage*, not
compute, over a 1-D ("model",) mesh of ``torch.distributed`` ranks, one
card each (``sharding.utils.serving_mesh``): weights rest as
``sharding.utils.Shard`` s under ``serve_param_specs`` and are gathered a
layer at a time on use; attention K/V (contiguous rows, page pools, rings,
an encoder-decoder target's cross K/V) rest as this rank's slice of their
trailing (KV, hd) axes under ``serve_state_specs``, each layer's gathered
right before its kernel and its new entries written into the slice.
Compute then runs at the unsharded engine's shapes on full tensors, so
tokens and the gathered state are bitwise the unsharded engine's (the JAX
package's ``docs/sharding.md``, "The serving profile"). Block tables,
positions, recurrent state, tokens, counters and sampling rows replicate;
every cache operation indexes batch, sequence or page dims only, so it
runs on the slices as it is, and a swap moves 1/N of a slot's K/V per
rank. Every rank runs the same calls in the same order (the scheduler's
host decisions are deterministic on its virtual clock; under
``AsyncEngine`` rank 0 decides and broadcasts), so their collectives
match. A one-rank mesh still gathers and writes slices. The engine cuts
each weight where the caller's tree lies and moves only its slice, so
trees given on the host cost each card its slices alone; trees given on
the card are the caller's, whole; trees drawn leaf by leaf into slices
(``sharding.rules.draw_sharded``, as ``launch/serve.build_engine`` draws
them) are kept as they are, so no card ever holds a whole model.

A VLM or encoder-decoder target takes per-request modality inputs,
``extras`` (``models/registry.make_extras``: ``vision_embeds`` or
``encoder_embeds``, leading batch axis the prefill's), through ``prefill``,
``run`` and ``prefill_into_slot`` into its prefill; no step reads them
again (an encoder-decoder target's cross K/V sits in its cache). A VLM
target's vision tokens take the first ``pos_offset`` (``vision_tokens``)
positions of every row: the prompt's tokens sit at ``pos_offset..``, the
first generated one at ``P + pos_offset``, the drafter extends over the
text region only, and pages and the bucket guard count the offset. The
prefix cache is built for the dense family alone, so neither of these
ever hits.
"""
from __future__ import annotations

import functools
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import DrafterConfig, ModelConfig
from repro_torch.core import drafter as D
from repro_torch.core import spec_decode as SD
from repro_torch.models.registry import extras_on, get_model
from repro_torch.serving import cache_ops
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.sharding import utils as SH
from repro_torch.sharding.rules import serve_param_specs
from repro_torch.sharding.utils import serving_mesh
from repro_torch.serving.sampling import (SamplingParams,
                                          batch_sampling_state,
                                          blank_sampling_state, draft_keys,
                                          step_keys)

Tensor = torch.Tensor
DRAFTER_MODES = ("parallel", "ar", "none")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. A missing card raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _in_mesh(method):
    """Run an ``Engine`` method under the engine's mesh (nothing without
    one): the K/V it allocates are slices, the weights it uses gathered."""
    @functools.wraps(method)
    def wrapped(self, *a, **kw):
        with SH.mesh_scope(self.mesh):
            return method(self, *a, **kw)
    return wrapped


@dataclass(frozen=True)
class EngineConfig:
    """Static configuration of an :class:`Engine`.

    Attributes:
      K: speculation depth, tokens drafted per iteration (ignored when
        ``drafter_mode == "none"``).
      max_new_tokens: default generation budget per row, the first token
        included (the scheduler passes per-request budgets).
      drafter_mode: "parallel", "ar" or "none".
      cache_dtype: KV cache and taps dtype ("bfloat16" on the card).
      max_len: cache positions per row; prompt + budget + K must fit.
      kv_layout: "contiguous" (a max_len row per slot) or "paged" (a shared
        pool of pages behind per-slot block tables; scheduler only).
      page_size: positions per page (paged).
      pool_pages: pages in the pool; 0 = batch * max_len / page_size.
      kv_growth: "incremental" (admission claims the prompt plus one
        speculative block; ``ensure_capacity`` grows a slot as it crosses
        page boundaries) or "upfront" (admission reserves the request's
        whole lifetime).
      bucket_prefill: pad admission prefills to the next power of two, so
        distinct prompt lengths share O(log2 max_len) shapes.
      sampling: the default ``SamplingParams`` of whole-batch ``prefill`` /
        ``run`` and of requests without their own; None is greedy.
      draft_sampling: sampled rows draw their K drafts from the row-warped
        drafter distribution (keys ``sampling.draft_keys``) and verify
        against it as the proposal q; off, drafts are the drafter argmax
        and q its one-hot. Greedy rows take the argmax either way.
      prefix_cache: index the pages of committed streams by token-prefix
        chain and admit a prompt that walks a cached chain by mapping those
        pages (paged only); token for token a cold prefill's output.
      swap: "none", or "host": a preempted slot's exclusively owned pages
        and per-slot rows move to pinned host memory and come back bitwise
        (paged only).
      host_pool_bytes: the host snapshot budget of ``swap="host"``; 0 is
        unbounded. A snapshot that does not fit falls back to recompute.
      greedy: deprecated alias (one ``DeprecationWarning``): True is
        ``SamplingParams.greedy()``, False a temperature-1.0 default.
      shard_model: rest the weights and the attention K/V sharded over
        ``mesh`` (storage sharding; compute gathers before use, so the
        output is bitwise the unsharded engine's). Needs an initialised
        process group; every rank of the mesh builds the same engine.
      mesh: a 1-D ("model",) ``sharding.utils.Mesh``; None is
        ``serving_mesh()`` over the whole world.
    """
    K: int = 5
    max_new_tokens: int = 64
    drafter_mode: str = "parallel"
    cache_dtype: str = "float32"
    max_len: int = 512
    kv_layout: str = "contiguous"
    page_size: int = 16
    pool_pages: int = 0
    kv_growth: str = "incremental"
    bucket_prefill: bool = True
    sampling: Optional[SamplingParams] = None
    draft_sampling: bool = False
    prefix_cache: bool = False
    swap: str = "none"
    host_pool_bytes: int = 0
    greedy: Optional[bool] = None
    shard_model: bool = False
    mesh: Any = None

    def __post_init__(self):
        if self.greedy is not None:
            warnings.warn(
                "EngineConfig(greedy=...) is deprecated: decoding policy is "
                "per request; pass SamplingParams (Request(sampling=...) or "
                "EngineConfig(sampling=...)) instead",
                DeprecationWarning, stacklevel=3)
            if self.sampling is None:
                object.__setattr__(
                    self, "sampling",
                    SamplingParams.greedy() if self.greedy
                    else SamplingParams(temperature=1.0))
        if self.sampling is None:
            object.__setattr__(self, "sampling", SamplingParams.greedy())
        if self.drafter_mode not in DRAFTER_MODES:
            raise ValueError(f"unknown drafter_mode {self.drafter_mode!r}")
        if self.kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {self.kv_layout!r}")
        if self.kv_growth not in ("incremental", "upfront"):
            raise ValueError(f"unknown kv_growth {self.kv_growth!r}")
        if self.swap not in ("none", "host"):
            raise ValueError(f"unknown swap {self.swap!r}")
        if self.kv_layout != "paged" and (self.prefix_cache
                                          or self.swap != "none"):
            raise ValueError("prefix_cache and swap='host' need "
                             "kv_layout='paged' (pages are the unit of both)")


def make_decode_state(model, tcfg: ModelConfig, dcfg: Optional[DrafterConfig],
                      ecfg: EngineConfig, batch: int, *, device,
                      new_count_fill: int = 1,
                      cache_rows: Optional[int] = None,
                      sampling: Optional[dict] = None) -> dict:
    """The decode-state skeleton: the JAX engine's leaves, on ``device``.
    ``new_count`` starts at ``new_count_fill`` (1: prefill commits the
    first generated token). The caches have ``cache_rows`` rows (default
    ``batch``). ``sampling`` is the per-slot policy subtree
    (``batch_sampling_state``); None fills every slot with
    ``ecfg.sampling``."""
    cdt = getattr(torch, ecfg.cache_dtype)
    rows = batch if cache_rows is None else cache_rows
    # a verify block (K + 1 positions) is the widest write that is rolled
    # back: it sizes the rings of local layers
    block = (ecfg.K if ecfg.drafter_mode != "none" else 0) + 1
    i32 = dict(dtype=torch.int32, device=device)
    state = {
        "tokens": torch.zeros((batch, ecfg.max_len), **i32),
        # log p(token) under the raw target softmax at each committed
        # position; prompt positions read 0
        "logprobs": torch.zeros((batch, ecfg.max_len), dtype=torch.float32,
                                device=device),
        "last": torch.zeros((batch,), **i32),
        "taps_last": torch.zeros((batch, 3 * tcfg.d_model), dtype=cdt,
                                 device=device),
        "tcache": model.make_cache(rows, ecfg.max_len, dtype=cdt,
                                   device=device, block=block),
        "new_count": torch.full((batch,), new_count_fill, **i32),
        "slot_iters": torch.zeros((batch,), **i32),
        "iters": torch.zeros((), **i32),
        "row_iters": torch.zeros((), **i32),
        "committed": torch.zeros((), **i32),
        "sampling": (sampling if sampling is not None else
                     batch_sampling_state(ecfg.sampling, batch,
                                          device=device)),
    }
    if ecfg.drafter_mode != "none":
        state["dcache"] = D.make_cache(dcfg, rows, ecfg.max_len, dtype=cdt,
                                       device=device)
    return state


def _token_logprob(logits: Tensor, tok: Tensor) -> Tensor:
    """log p(tok) under the raw softmax of ``logits``; broadcasts over
    leading axes: (B, V) + (B,) -> (B,), (B, K+1, V) + (B, K+1) -> (B, K+1)."""
    lp = torch.log_softmax(logits, dim=-1)
    return lp.gather(-1, tok[..., None].long())[..., 0]


def _scatter_drop(buf: Tensor, idx: Tensor, val: Tensor) -> Tensor:
    """Row-wise ``buf[b, idx[b, j]] = val[b, j]``, dropping indices past the
    end (the JAX scatter's ``mode="drop"``). Returns a new tensor."""
    B, W = buf.shape
    ext = torch.cat([buf, buf.new_zeros((B, 1))], dim=1)
    ext.scatter_(1, idx.long().clamp(0, W), val.to(buf.dtype))
    return ext[:, :W]


@dataclass
class _SwapHandle:
    """One swapped-out request's host snapshot (a ``HostPagePool`` entry).

    ``snap`` holds ``cache_ops.extract_slot`` of the slot over its
    exclusively owned pages only (paged leaves hold those pages end to end;
    per-slot rows in full), packed into one byte buffer, pinned host memory
    on the card; ``layout`` is the state's tree with each packed leaf's
    (dtype, shape, offset), None for global counters. ``page_row`` is the
    slot's page list at eviction; the pages not in ``host_idx`` stayed
    resident, and the handle keeps the slot's reference on them until
    swap-in maps them again or ``drop_swap`` releases them. ``ready`` marks
    the end of the copy that wrote ``snap`` (None on the CPU, where it is
    synchronous)."""
    snap: Tensor
    layout: dict
    page_row: List[int]
    host_idx: List[int]
    last: int
    sampled: bool
    nbytes: int
    ready: Optional[Any]


class Engine:
    """Speculative-decoding engine over ``batch`` slots.

    Args:
      tcfg / dcfg: target and drafter configs (dcfg None for mode "none").
      tparams / dparams: parameter trees (``models.transformer`` /
        ``core.drafter`` layout), moved to ``device``; under
        ``shard_model`` their leaves may be this rank's ``Shard`` slices
        for the engine's mesh already (``sharding.rules.draw_sharded``).
      ecfg: static engine configuration.
      batch: slots (rows of the decode state).
      device: "cuda" (the default) or "cpu"; a missing card raises.
    """

    def __init__(self, tcfg: ModelConfig, dcfg: Optional[DrafterConfig],
                 tparams: dict, dparams: Optional[dict], ecfg: EngineConfig,
                 batch: int, *, device="cuda"):
        self.device = resolve_device(device)
        if ecfg.drafter_mode != "none" and (dcfg is None or dparams is None):
            raise ValueError(f"drafter_mode {ecfg.drafter_mode!r} needs a "
                             f"drafter config and parameters")
        self.tcfg, self.dcfg, self.ecfg, self.batch = tcfg, dcfg, ecfg, batch
        # refuses, before any weight moves, what the device's kernels lack
        self.model = get_model(tcfg, self.device)
        # a VLM target's vision tokens precede every row's prompt
        self.pos_offset = tcfg.vision_tokens if tcfg.family == "vlm" else 0
        self.mesh = None
        if ecfg.shard_model:
            self.mesh = ecfg.mesh if ecfg.mesh is not None else serving_mesh()
            if self.mesh.axis_names != ("model",) or self.mesh.groups is None:
                raise ValueError(f"shard_model needs a 1-D ('model',) mesh "
                                 f"with process groups, got {self.mesh!r}")
            # each rank keeps its slice, cut where the caller's trees lie
            # and then moved: given trees on the host, the card never holds
            # a whole sharded weight; trees cut as they were drawn
            # (``rules.draw_sharded``) keep their slices, and a slice cut
            # for another mesh layout raises
            self.tparams, self.dparams = (
                None if tree is None else SH.shard_tree(
                    tree, serve_param_specs(tree, self.mesh), self.mesh,
                    device=self.device)
                for tree in (tparams, dparams))
        else:
            self.tparams = _to(tparams, self.device)
            self.dparams = _to(dparams, self.device)
        self.last_logprob = 0.0     # of the last admission's first token
        # host-side mirror of which slots hold a sampled policy: a step with
        # none takes the greedy-only lane (the same tokens, fewer launches)
        self._slot_sampled = [False] * batch
        self.paged = ecfg.kv_layout == "paged"
        self.incremental = self.paged and ecfg.kv_growth == "incremental"
        template = self._state_template(1, device="meta")   # no storage
        if self.paged:
            if ecfg.max_len % ecfg.page_size:
                raise ValueError(f"max_len {ecfg.max_len} must be a multiple "
                                 f"of page_size {ecfg.page_size}")
            self.pages_per_slot = ecfg.max_len // ecfg.page_size
            self.pool_pages = ecfg.pool_pages or batch * self.pages_per_slot
            self.allocator = cache_ops.BlockAllocator(self.pool_pages)
            self._slot_pages: List[List[int]] = [[] for _ in range(batch)]
            self.pspec = cache_ops.paged_spec(template)   # which leaves pool
        # a target with local layers' rings or with recurrent state is
        # pad-unsafe (the JAX engine's _chunk_only): admission chunks
        # instead of padding, and no prefix cache is built (pages hold
        # neither a ring's per-slot entries nor the recurrent state, so a
        # hit would lose them); nor for an MoE target, whose expert
        # capacity couples the tokens of a call (the JAX engine's
        # _hits_ok admits the dense family alone)
        self.ring = cache_ops.has_ring_cache(template["tcache"])
        self.chunk_only = self.ring or self.model.recurrent
        self.prefix_cache = (PrefixCache(ecfg.page_size)
                             if ecfg.prefix_cache and not self.chunk_only
                             and tcfg.family == "dense" else None)
        self.swap_enabled = ecfg.swap == "host"
        self.host_pool = (cache_ops.HostPagePool(ecfg.host_pool_bytes)
                          if self.swap_enabled else None)
        # read right after the call that sets them: the bytes the last
        # swap_out_slot / swap_in_slot moved, the positions the last
        # admission served from cached pages
        self.swap_last_bytes = 0
        self.last_hit_tokens = 0
        self._swap_sizes = None
        # the last serving session's final state: cached page content lives
        # in its pools, so the next session starts from it
        self._serve_state: Optional[dict] = None
        # host mirror of the lowest position each slot's steps write: set at
        # admission, and a slot's positions only grow
        self._slot_floor = [0] * batch

    @_in_mesh
    def _state_template(self, batch: int, *, device, **kw) -> dict:
        return make_decode_state(self.model, self.tcfg, self.dcfg, self.ecfg,
                                 batch, device=device, **kw)

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------
    def _prefill_rows(self, prompts: Tensor, true_len: int, samp: dict,
                      greedy: bool, extras: Optional[dict] = None) -> dict:
        """A fresh contiguous state for ``prompts`` (B, Pb), whose first
        ``true_len`` tokens are real and the rest right-padding (Pb ==
        true_len: none), under the policy rows ``samp``, with the target's
        ``extras``. Causal attention leaves the real positions blind to the
        pads; the head reads the last real position, which commits the
        first generated token at ``fused = true_len + pos_offset`` (the
        argmax for greedy rows, a draw from the warped target keyed by
        ``fold_in(seed, fused)`` for sampled ones; ``greedy`` says every
        row is greedy and skips the warp), and the pads' cache entries are
        invalidated afterwards."""
        B, Pb = prompts.shape
        off = self.pos_offset
        fused = true_len + off         # positions 0..fused-1 are real
        state = self._state_template(B, device=self.device, sampling=samp)
        hp = torch.full((B,), fused - 1, dtype=torch.int32,
                        device=self.device)
        with tracing.span("prefill.target", tokens=Pb):
            out = self.model.forward(self.tparams, prompts, mode="prefill",
                                     cache=state["tcache"], collect_taps=True,
                                     head_positions=hp, **(extras or {}))
        head = out.logits[:, 0]
        if greedy:
            first = head.argmax(-1).to(torch.int32)
        else:
            first = SD.sample_token(step_keys(samp, fused), head,
                                    samp["temperature"], samp["top_k"],
                                    samp["top_p"])
        state["tokens"][:, off:off + Pb] = prompts
        state["tokens"][:, fused] = first
        state["logprobs"][:, fused] = _token_logprob(head, first)
        state["last"].fill_(fused)
        state["taps_last"] = out.taps[:, fused - 1].contiguous()
        state["tcache"] = out.cache
        cp = torch.full((B,), fused - 1, dtype=torch.int32,
                        device=self.device)
        if Pb > true_len:
            cache_ops.commit(state["tcache"], cp)
        if self.ecfg.drafter_mode != "none" and Pb > 1:
            pos = off + torch.arange(Pb - 1, dtype=torch.int32,
                                     device=self.device)[None].repeat(B, 1)
            # drafter position p pairs taps[p] with token p + 1, over the
            # text region
            with tracing.span("prefill.drafter", tokens=Pb - 1):
                D.extend(self.dcfg, self.tcfg, self.dparams, state["dcache"],
                         prompts[:, 1:], out.taps[:, off:off + Pb - 1], pos)
            if Pb > true_len:
                cache_ops.commit(state["dcache"], cp - 1)
        return state

    @_in_mesh
    def prefill(self, prompts, extras: Optional[dict] = None,
                sampling: Optional[SamplingParams] = None) -> dict:
        """Whole-batch prefill of ``prompts`` (B, P) with the target's
        ``extras`` (leading axis B): a fresh contiguous decode state
        committing the first generated token per row, every row under
        ``sampling`` (default ``ecfg.sampling``)."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                  device=self.device)
        B, P = prompts.shape
        if B != self.batch:
            raise ValueError(f"{B} prompts for an engine of batch {self.batch}")
        K = self.ecfg.K if self.ecfg.drafter_mode != "none" else 0
        if P + self.pos_offset + self.ecfg.max_new_tokens + K \
                > self.ecfg.max_len:
            raise ValueError(
                f"prompt {P} + offset {self.pos_offset} + max_new_tokens "
                f"{self.ecfg.max_new_tokens} + K {K} exceeds max_len "
                f"{self.ecfg.max_len}")
        sp = sampling or self.ecfg.sampling
        samp = batch_sampling_state(sp, B, device=self.device)
        with torch.no_grad():
            return self._prefill_rows(prompts, P, samp, sp.is_greedy,
                                      extras_on(extras, self.device))

    def prefill_bucket(self, length: int) -> int:
        """Tokens the padded admission prefill of a ``length``-token prompt
        runs: the next power of two, or the exact length where bucketing is
        off or the bucket, after a VLM target's vision tokens, would reach
        max_len. (A pad-unsafe target chunks instead:
        ``_admission_prefill``.)"""
        pb = 1 << max(length - 1, 0).bit_length()
        if (not self.ecfg.bucket_prefill
                or self.pos_offset + pb >= self.ecfg.max_len):
            return length
        return pb

    def _admission_prefill(self, prompt: Tensor, sp: SamplingParams,
                           extras: Optional[dict] = None) -> dict:
        """The batch-1 state of an admission. Bucketed: padded to
        ``prefill_bucket``, or, for a pad-unsafe target (a pad past a ring's
        window would evict live prompt entries; a recurrent target would
        fold it into its state), cut into the MSB-first power-of-two chunks
        of ``prefill_buckets``: a prefill of the first, then decode-mode
        chunks (the JAX engine's ``_chunk_only`` path). Decode-mode chunks
        of a recurrent target build no per-token snapshots."""
        P = prompt.shape[1]
        samp = batch_sampling_state(sp, 1, device=self.device)
        if not (self.chunk_only and self.ecfg.bucket_prefill):
            padded = F.pad(prompt, (0, self.prefill_bucket(P) - P))
            return self._prefill_rows(padded, P, samp, sp.is_greedy, extras)
        sizes = self.prefill_buckets(P)
        src = self._prefill_rows(prompt[:, :sizes[0]], sizes[0], samp,
                                 sp.is_greedy, extras)
        start = sizes[0]
        for c in sizes[1:]:
            self._chunk(src, prompt[:, start:start + c], start, sp.is_greedy)
            start += c
        return src

    # ------------------------------------------------------------------
    # per-slot lifecycle (continuous batching; serving/scheduler.py)
    # ------------------------------------------------------------------
    @_in_mesh
    def blank_state(self) -> dict:
        """An all-idle state: empty caches (positions -1), zero tokens,
        every slot frozen (new_count == max_new_tokens). Paged: the caches
        are page pools (a local layer's ring stays per slot) and
        ``block_table`` (B, max_len / page_size) is all -1. Slots come alive
        through ``prefill_into_slot``."""
        if not self.paged:
            return self._state_template(
                self.batch, device=self.device,
                new_count_fill=self.ecfg.max_new_tokens,
                sampling=blank_sampling_state(self.batch, device=self.device))
        state = self._state_template(
            self.batch, device=self.device,
            new_count_fill=self.ecfg.max_new_tokens, cache_rows=1,
            sampling=blank_sampling_state(self.batch, device=self.device))
        state = cache_ops.paged_state(state, self.pspec, self.ecfg.page_size,
                                      self.pool_pages)

        def per_slot(_, leaf, tag):    # rings: one row per slot
            if tag == cache_ops.NOT_PAGED and isinstance(leaf, Tensor) \
                    and leaf.dim() > 0:
                return leaf.expand((self.batch,) + leaf.shape[1:]).clone()
            return leaf
        for key in ("tcache", "dcache"):
            if key in state:
                state[key] = cache_ops.map_tree(per_slot, state[key],
                                                self.pspec[key])
        state["block_table"] = torch.full(
            (self.batch, self.pages_per_slot), -1, dtype=torch.int32,
            device=self.device)
        return state

    @property
    def commit_stride(self) -> int:
        """Most positions one iteration writes past the last committed one
        (K drafted + 1 bonus; 1 for vanilla AR)."""
        return (self.ecfg.K if self.ecfg.drafter_mode != "none" else 0) + 1

    def pages_for(self, length: int) -> int:
        """Pages covering ``length`` cache positions (capped at max_len)."""
        if not self.paged:
            return 0
        return -(-min(max(length, 1), self.ecfg.max_len)
                 // self.ecfg.page_size)

    def pages_needed(self, prompt_len: int,
                     max_new: Optional[int] = None) -> int:
        """Pages one request occupies over its lifetime: prompt + budget +
        the worst speculative overshoot."""
        if not self.paged:
            return 0
        budget = self.ecfg.max_new_tokens if max_new is None else max_new
        return self.pages_for(prompt_len + self.pos_offset + budget
                              + self.ecfg.K + 1)

    def initial_pages(self, prompt_len: int,
                      max_new: Optional[int] = None, *,
                      resume: bool = False) -> int:
        """Pages an admission claims: the whole lifetime (upfront), or the
        prompt plus one speculative block (incremental). A sampled
        ``resume`` of a ``prompt_len`` stream commits nothing past its last
        token, so its next step writes one position less than a fresh
        admission's, and it claims one position less."""
        if not self.paged:
            return 0
        if not self.incremental:
            return self.pages_needed(prompt_len, max_new)
        return self.pages_for(prompt_len + self.pos_offset
                              + self.commit_stride - (1 if resume else 0))

    def can_admit(self, prompt_len: int, max_new: Optional[int] = None,
                  full: bool = False, tokens=None,
                  resume: bool = False) -> bool:
        """Whether the pool can take one more request of this shape now
        (always, contiguous). ``full`` gates on the whole-lifetime need, as
        the scheduler does for a preempted request's resume, so the same
        pressure cannot evict it again at once; ``resume`` mirrors
        ``prefill_into_slot(resume=)``. With a prefix cache, cache-only
        pages count as reclaimable, and the prompt ``tokens`` (when given)
        price the need after the hit: pages it maps from the cache come off
        no free list, and cannot be evicted to fund the rest."""
        if not self.paged:
            return True
        need = (self.pages_needed(prompt_len, max_new) if full
                else self.initial_pages(prompt_len, max_new, resume=resume))
        avail = self.allocator.n_free
        if self.prefix_cache is not None:
            pinned = []
            if tokens is not None:
                shared, cow = self.prefix_cache.probe(tokens)
                need -= len(shared)
                pinned = shared + ([cow] if cow is not None else [])
            avail += self.prefix_cache.evictable(self.allocator, pinned)
        return need <= avail

    def slot_capacity(self, slot: int) -> int:
        """Cache positions the slot's page allocation covers."""
        if not self.paged:
            return self.ecfg.max_len
        return len(self._slot_pages[slot]) * self.ecfg.page_size

    @staticmethod
    def _core(state: dict) -> dict:
        return {k: v for k, v in state.items() if k != "block_table"}

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """``allocator.alloc``; when the pool is short and a prefix cache
        holds pages no slot maps, evict those least recently used and
        retry once."""
        got = self.allocator.alloc(n)
        if got is None and self.prefix_cache is not None:
            self.prefix_cache.evict(n - self.allocator.n_free, self.allocator)
            got = self.allocator.alloc(n)
        return got

    def _table_row(self, pages: List[int]) -> Tensor:
        row = torch.full((self.pages_per_slot,), -1, dtype=torch.int32)
        row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        return row.to(self.device)

    def ensure_capacity(self, state: dict, slot: int, length: int):
        """Grow ``slot``'s pages to cover ``length`` positions, claiming
        pages only when its length crossed a page boundary. Returns
        ``(state, ok)``; ``ok`` False when the pool is exhausted (the
        caller preempts or stalls the slot). A claimed page is blanked
        before the table maps it: a recycled page may hold its previous
        owner's positions. No-op (ok) unless paged and incremental."""
        if not self.incremental:
            return state, True
        need = self.pages_for(length)
        have = len(self._slot_pages[slot])
        if need <= have:
            return state, True
        got = self._alloc_pages(need - have)
        if got is None:
            return state, False
        tracing.count("page_claims")
        tracing.count("pages_claimed", len(got))
        self._slot_pages[slot].extend(got)
        got_t = torch.tensor(got, dtype=torch.int32, device=self.device)
        cache_ops.blank_pages(self._core(state), got_t, self.pspec)
        state["block_table"][slot, have:need] = got_t
        return state, True

    @tracing.spanned("engine.admit")
    @_in_mesh
    def prefill_into_slot(self, state: dict, prompt, slot: int,
                          max_new: Optional[int] = None,
                          sampling: Optional[SamplingParams] = None,
                          resume: bool = False,
                          extras: Optional[dict] = None):
        """Admit one request into slot ``slot`` of a live state: prefill
        ``prompt`` (1-D) as a batch-1 state (bucketed) under the request's
        policy ``sampling`` (default ``ecfg.sampling``) with the target's
        ``extras`` (leading axis 1), then write its row,
        the policy row included, into the slot, in place; other slots are
        untouched. Paged: the slot first claims ``initial_pages`` pages
        (callers gate on ``can_admit``) and the prefilled caches are
        scattered into them.

        With a prefix cache the prompt is first matched against it: cached
        pages are mapped into the slot's row, a partially matching page is
        copied on write, and only the uncached suffix is prefilled
        (``_hit_admission``); ``last_hit_tokens`` says how many positions
        came from the cache (0 when cold).

        A fresh admission (``resume=False``) commits the first generated
        token and returns ``(state, first_token, last_position)``, leaving
        its logprob in ``last_logprob``. A preempted request resumes by
        admitting prompt + the tokens it generated. A greedy stream simply
        continues from that prefix. A sampled one passes ``resume=True``:
        the engine prefills ``prompt[:-1]``, forces the committed token to
        ``prompt[-1]`` and starts the slot's count at 0, so the slot holds
        the uninterrupted run's step-boundary state and the next step
        re-derives the same ``fold_in(seed, position)`` keys; it returns
        ``(state, None, last_position)``."""
        prompt = torch.as_tensor(np.asarray(prompt, np.int32).reshape(1, -1),
                                 device=self.device)
        tracing.annotate(tokens=prompt.shape[1])
        tracing.count("admissions")
        tracing.count("admitted_prompt_tokens", prompt.shape[1])
        res_tok = None
        if resume:
            prompt, res_tok = prompt[:, :-1], prompt[0, -1]
        sp = sampling or self.ecfg.sampling
        self._slot_sampled[slot] = not sp.is_greedy
        self.last_hit_tokens = 0
        extras = extras_on(extras, self.device)
        with torch.no_grad():
            if not self.paged:
                src = self._admission_prefill(prompt, sp, extras)
                with tracing.span("admit.write"):
                    cache_ops.write_slot(state, _resume_fixup(src, res_tok),
                                         slot)
            else:
                if self._slot_pages[slot]:
                    raise RuntimeError(f"slot {slot} still holds pages; "
                                       "free_slot it before re-admission")
                n = self.initial_pages(prompt.shape[1] + (1 if resume else 0),
                                       max_new, resume=resume)
                ptoks = tracing.to_host(prompt[0]).numpy()
                shared, cow = [], None
                if self.prefix_cache is not None:
                    shared, cow = self.prefix_cache.match(ptoks)
                if shared or cow is not None:
                    src = self._hit_admission(state, prompt, slot, n, shared,
                                              cow, sp, res_tok)
                else:
                    pages = self._alloc_pages(n)
                    if pages is None:
                        raise RuntimeError(
                            f"page pool exhausted ({n} needed, "
                            f"{self.allocator.n_free} free); gate on "
                            "can_admit")
                    self._slot_pages[slot] = pages
                    row = self._table_row(pages)
                    src = self._admission_prefill(prompt, sp, extras)
                    with tracing.span("admit.write"):
                        cache_ops.admit_pages(self._core(state),
                                              _resume_fixup(src, res_tok),
                                              slot, row, self.pspec)
                        state["block_table"][slot] = row
                    if self.prefix_cache is not None:
                        self.prefix_cache.insert_stream(ptoks, pages,
                                                        self.allocator)
                        self.prefix_cache.note_admission(0, False)
        last = int(tracing.to_host(src["last"][0]))
        self._slot_floor[slot] = last - (1 if self.ecfg.drafter_mode
                                         != "none" else 0)
        if resume:
            self.last_logprob = 0.0
            return state, None, last
        self.last_logprob = float(tracing.to_host(src["logprobs"][0, last]))
        return state, int(tracing.to_host(src["tokens"][0, last])), last

    # ------------------------------------------------------------------
    # prefix caching (serving/prefix_cache.py; EngineConfig.prefix_cache)
    # ------------------------------------------------------------------
    @staticmethod
    def prefill_buckets(length: int) -> List[int]:
        """The most-significant-bit-first power-of-two decomposition of a
        length: the chunk sizes of a hit's suffix prefill."""
        return [1 << b for b in range(length.bit_length() - 1, -1, -1)
                if length >> b & 1]

    def _hit_admission(self, state: dict, prompt: Tensor, slot: int, n: int,
                       shared: List[int], cow: Optional[int],
                       sp: SamplingParams, res_tok) -> dict:
        """Admission of a prompt that matched cached pages: map the shared
        pages into the slot's row (the cache and the slot co-own them),
        copy the partially matching page on write, and prefill only the
        uncached suffix in decode-mode chunks. The matched pages and the
        copy's source are pinned before the fresh allocation, so the
        eviction it may trigger cannot reclaim them. Returns the batch-1
        state it admitted."""
        ps = self.ecfg.page_size
        self.allocator.incref(shared + ([cow] if cow is not None else []))
        fresh = self._alloc_pages(n - len(shared))
        if fresh is None:
            self.allocator.free(shared + ([cow] if cow is not None else []))
            raise RuntimeError(
                f"page pool exhausted ({n - len(shared)} needed, "
                f"{self.allocator.n_free} free); gate on can_admit")
        start = len(shared) * ps
        if cow is not None:
            # fresh[0] becomes the slot's copy: all of it is valid but the
            # final drafter entry, so the suffix restarts one position early
            cache_ops.copy_page(self._core(state), cow, fresh[0], self.pspec)
            self.allocator.free([cow])
            start += ps - 1
        pages = shared + fresh
        self._slot_pages[slot] = pages
        row = self._table_row(pages)
        scatter = row.clone()
        scatter[:len(shared)] = -1      # never write a page others map
        P = prompt.shape[1]
        src = self._hit_seed(state, row, prompt, start, sp)
        pos, first = start, True
        for c in self.prefill_buckets(P - start):
            self._chunk(src, prompt[:, pos:pos + c], pos, sp.is_greedy,
                        hit=first)
            pos, first = pos + c, False
        with tracing.span("admit.write"):
            cache_ops.admit_pages(self._core(state),
                                  _resume_fixup(src, res_tok), slot, row,
                                  self.pspec, scatter_row=scatter)
            state["block_table"][slot] = row
        # index the verifiable prompt prefix, a diverged copy included (its
        # full key now carries this prompt's lookahead)
        ptoks = tracing.to_host(prompt[0]).numpy()
        self.prefix_cache.insert_stream(ptoks, pages, self.allocator)
        self.last_hit_tokens = start
        self.prefix_cache.note_admission(start, cow is not None)
        return src

    def _hit_seed(self, state: dict, row: Tensor, prompt: Tensor, start: int,
                  sp: SamplingParams) -> dict:
        """The batch-1 contiguous state a hit's suffix chunks run on: the
        slot's row of pages gathered into the view, every position >=
        ``start`` emptied (fresh pages may hold a previous owner's
        positions, and a copied page's last drafter entry belongs to
        another lookahead token). Positions below ``start`` are cached
        content, valid by the full-key scheme (``prefix_cache.py``)."""
        src = self._state_template(
            1, device=self.device,
            sampling=batch_sampling_state(sp, 1, device=self.device))
        beyond = torch.arange(self.ecfg.max_len, device=self.device) >= start

        def seed(_, blank, pool, tag):
            if tag == cache_ops.NOT_PAGED:
                return blank
            view = cache_ops.gather_pages(pool, row[None], tag)
            if tag == cache_ops.PAGED_POS:
                view.masked_fill_(beyond[None], -1)
            return view

        for key in ("tcache", "dcache"):
            if key in src:
                src[key] = cache_ops.map_tree(seed, src[key], state[key],
                                              self.pspec[key])
        src["tokens"][0, :prompt.shape[1]] = prompt[0]
        src["last"].fill_(start)
        return src

    def _chunk(self, src: dict, chunk: Tensor, start: int, greedy: bool,
               hit: bool = False) -> None:
        """Prefill ``chunk`` (1, c) at positions ``start..start+c-1`` of the
        batch-1 state ``src``, in place, through a decode-mode forward
        against its cache, committing the token after the chunk as an
        admission does. The drafter pairs (taps[p], token[p+1]): a chunk
        supplies tokens start..start+c-1, so its pairs take the previous
        chunk's last tap and this chunk's first c-1. The first chunk of a
        hit (``hit``) skips the pair at start-1: the cached page already
        holds it (the lookahead is part of its key), and its tap was never
        recomputed here."""
        c = chunk.shape[1]
        positions = (start + torch.arange(c, dtype=torch.int32,
                                          device=self.device))[None]
        with tracing.span("prefill.target", tokens=c):
            out = self.model.forward(self.tparams, chunk, mode="decode",
                                     positions=positions, cache=src["tcache"],
                                     collect_taps=True, head_last_only=True)
        fused = start + c
        head = out.logits[:, -1]
        samp = src["sampling"]
        if greedy:
            first = head.argmax(-1).to(torch.int32)
        else:
            first = SD.sample_token(step_keys(samp, fused), head,
                                    samp["temperature"], samp["top_k"],
                                    samp["top_p"])
        src["tokens"][:, start:fused] = chunk
        src["tokens"][:, fused] = first
        src["logprobs"][:, start:fused] = 0       # prompt positions read 0
        src["logprobs"][:, fused] = _token_logprob(head, first)
        src["last"].fill_(fused)
        src["tcache"] = out.cache
        if self.ecfg.drafter_mode != "none":
            with tracing.span("prefill.drafter", tokens=c):
                if hit and c > 1:
                    D.extend(self.dcfg, self.tcfg, self.dparams,
                             src["dcache"], chunk[:, 1:], out.taps[:, :-1],
                             positions[:, :-1])
                elif not hit:
                    taps = torch.cat([src["taps_last"][:, None],
                                      out.taps[:, :-1]], dim=1)
                    D.extend(self.dcfg, self.tcfg, self.dparams,
                             src["dcache"], chunk, taps, positions - 1)
        src["taps_last"] = out.taps[:, -1].contiguous()

    def serve_state(self) -> dict:
        """The state a serving session starts from: blank, or with a prefix
        cache the previous session's final state, whose pools hold the
        cached pages' content (every slot of it freed)."""
        if self.prefix_cache is None or self._serve_state is None:
            return self.blank_state()
        return self._serve_state

    def retain_state(self, state: dict) -> None:
        """Keep a session's final state for the next one (with a prefix
        cache; otherwise nothing is kept)."""
        if self.prefix_cache is not None:
            self._serve_state = state

    def free_slot(self, state: dict, slot: int,
                  final_tokens=None) -> dict:
        """Blank slot ``slot`` in place and refreeze it (new_count =
        max_new_tokens) until its next admission; paged, its page
        references are dropped (a page shared with the prefix cache or
        another slot survives) and its table row becomes -1.
        ``final_tokens``, with a prefix cache: the request's committed
        stream (prompt + emitted tokens), whose verifiable full pages are
        indexed before the release, so a later request sharing the prefix,
        or this one's resume, admits against them. It is ``free_pages``
        (host state) then ``release_slot`` (the state's rows)."""
        self.free_pages(slot, final_tokens)
        return self.release_slot(state, slot)

    def free_pages(self, slot: int, final_tokens=None) -> None:
        """The host half of ``free_slot``: index ``final_tokens``' full
        pages (with a prefix cache) and drop the slot's page references.
        The slot's rows keep naming those pages until ``release_slot``,
        which must come before the next step or admission."""
        self._slot_sampled[slot] = False
        if not self.paged:
            return
        pages = self._slot_pages[slot]
        if final_tokens is not None and pages and self.prefix_cache is not None:
            self.prefix_cache.insert_stream(
                np.asarray(final_tokens, np.int32).reshape(-1), pages,
                self.allocator)
        self.allocator.free(pages)
        self._slot_pages[slot] = []

    def release_slot(self, state: dict, slot: int) -> dict:
        """The state half of ``free_slot``: blank the slot's rows, in place,
        and refreeze it; paged, its table row becomes -1."""
        if not self.paged:
            return cache_ops.reset_slot(
                state, slot, fills={"new_count": self.ecfg.max_new_tokens})
        return self._release_slot(state, slot)

    def _release_slot(self, state: dict, slot: int) -> dict:
        """Reset a paged slot's rows and table row; its page references are
        the caller's to drop. No page is blanked: a freed page may still be
        mapped by the cache or another slot (growth blanks pages when it
        claims them)."""
        self._slot_pages[slot] = []
        self._slot_sampled[slot] = False
        cache_ops.reset_slot(self._core(state), slot, self.pspec,
                             {"new_count": self.ecfg.max_new_tokens})
        state["block_table"][slot] = -1
        return state

    def _check_shared_pages(self) -> None:
        """The paged step invalidates, in every page a row names, positions
        above that row's bound (``layers.paged_invalidate``, a scatter with
        duplicate indices when rows share pages), then writes from the
        row's first position on. Both are safe only while every shared page
        (refcount > 1) lies below each sharer's first write, which the
        full-key scheme implies. Checked on the host mirror; raises on a
        violation."""
        ps = self.ecfg.page_size
        for s, pages in enumerate(self._slot_pages):
            for i in range(self._slot_floor[s] // ps, len(pages)):
                if self.allocator.refcount(pages[i]) > 1:
                    raise AssertionError(
                        f"slot {s} writes from position {self._slot_floor[s]}"
                        f" into its page {i} (pool page {pages[i]}), which "
                        f"{self.allocator.refcount(pages[i])} owners share")

    # ------------------------------------------------------------------
    # swap-to-host preemption (EngineConfig.swap = "host")
    # ------------------------------------------------------------------
    def _swap_layout(self):
        """``(row_bytes, page_bytes)``: host bytes of one slot's per-slot
        rows, and of one page's payload over every paged leaf."""
        if self._swap_sizes is None:
            sizes = [0, 0]
            ps = self.ecfg.page_size

            def add(_, leaf, tag):
                if not (isinstance(leaf, Tensor) and leaf.dim() > 0):
                    return
                n = leaf.numel() * leaf.element_size()
                if tag == cache_ops.NOT_PAGED:
                    sizes[0] += n
                else:
                    w = leaf.shape[cache_ops.view_width_axis(leaf.dim(), tag)]
                    sizes[1] += n // w * ps
            cache_ops.map_tree(add, self._state_template(1, device="meta"),
                               self.pspec)
            self._swap_sizes = tuple(sizes)
        return self._swap_sizes

    @_in_mesh
    def swap_bytes_estimate(self, slot: int) -> int:
        """Host bytes swapping ``slot`` out would store now: its per-slot
        rows plus one page payload per page it alone owns (refcount 1;
        shared pages stay resident)."""
        row_b, page_b = self._swap_layout()
        return row_b + page_b * sum(1 for p in self._slot_pages[slot]
                                    if self.allocator.refcount(p) == 1)

    @_in_mesh
    def swap_out_slot(self, state: dict, slot: int, rid):
        """Preempt ``slot`` by copying its state to the host pool under
        ``rid``. Returns ``(state, ok)``: on ``ok`` the slot is freed (its
        own pages recycled, shared ones left resident under the handle's
        reference) and ``swap_last_bytes`` holds the bytes parked; ``ok``
        False means the host pool cannot take the snapshot and nothing
        changed (the caller recomputes instead). Called at a sync boundary,
        where the slot's state is a step boundary: restored bitwise it
        continues the stream token for token. The committed counters are
        zeroed in the snapshot, the scheduler's resume convention."""
        if not self.swap_enabled:
            return state, False
        pages = self._slot_pages[slot]
        host_idx = [i for i, p in enumerate(pages)
                    if self.allocator.refcount(p) == 1]
        nbytes = self.swap_bytes_estimate(slot)
        if not self.host_pool.can_store(nbytes):
            return state, False
        last = int(tracing.to_host(state["last"][slot]))
        host_pages = torch.tensor([pages[i] for i in host_idx],
                                  dtype=torch.int32, device=self.device)
        with torch.no_grad():
            src = cache_ops.extract_slot(self._core(state), slot, host_pages,
                                         self.pspec)
            src["new_count"].zero_()
            src["slot_iters"].zero_()
        flat, layout = _pack(src)
        snap, ready = flat, None
        if self.device.type == "cuda":
            # one copy into pinned memory, on the stream; ``ready`` marks its
            # end, and whoever reads or releases the buffer on the host
            # (swap_in_slot, drop_swap) synchronizes on it first
            snap = torch.empty(flat.numel(), dtype=torch.uint8,
                               pin_memory=True)
            snap.copy_(flat, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        nbytes = flat.numel()           # the estimate, now stored
        h = _SwapHandle(snap=snap, layout=layout, page_row=list(pages),
                        host_idx=host_idx, last=last,
                        sampled=self._slot_sampled[slot], nbytes=nbytes,
                        ready=ready)
        if not self.host_pool.put(rid, h, nbytes):
            return state, False
        self.allocator.free([pages[i] for i in host_idx])
        self.swap_last_bytes = nbytes
        return self._release_slot(state, slot), True

    def has_swap(self, rid) -> bool:
        """Whether a host snapshot is parked under ``rid``."""
        return self.swap_enabled and rid in self.host_pool

    def can_swap_in(self, rid, prompt_len: Optional[int] = None,
                    max_new: Optional[int] = None,
                    full: bool = False) -> bool:
        """Admission gate of a swapped resume, priced at its device-page
        need: fresh pages for the host spans (resident pages are on the
        device), plus with ``full`` the growth of its remaining lifetime
        beyond what the restore maps (``can_admit(full=True)``'s rule)."""
        h = self.host_pool.get(rid) if self.swap_enabled else None
        if h is None:
            return False
        need = len(h.host_idx)
        if full and prompt_len is not None:
            need += max(0, self.pages_needed(prompt_len, max_new)
                        - len(h.page_row))
        avail = self.allocator.n_free
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable(self.allocator, h.page_row)
        return need <= avail

    @_in_mesh
    def swap_in_slot(self, state: dict, slot: int, rid):
        """Resume a swapped-out request into (empty) ``slot``: fresh pages
        for the host spans, the snapshot written back into them and into
        the slot's rows, the resident pages mapped again. Returns ``(state,
        last)``; the slot then holds bitwise the state it had at eviction.
        Callers gate on ``can_swap_in``."""
        h = self.host_pool.get(rid) if self.swap_enabled else None
        if h is None:
            raise KeyError(f"no swap handle for request {rid!r}")
        if self._slot_pages[slot]:
            raise RuntimeError(f"slot {slot} still holds pages; "
                               "free_slot it before swap-in")
        fresh = self._alloc_pages(len(h.host_idx))
        if fresh is None:
            raise RuntimeError(
                f"page pool exhausted ({len(h.host_idx)} needed, "
                f"{self.allocator.n_free} free); gate on can_swap_in")
        pages = list(h.page_row)
        for i, p in zip(h.host_idx, fresh):
            pages[i] = p
        if h.ready is not None:
            h.ready.synchronize()
        src = _unpack(h.snap.to(self.device, non_blocking=True), h.layout)
        with torch.no_grad():
            cache_ops.admit_pages(
                self._core(state), src, slot,
                torch.tensor(fresh, dtype=torch.int32, device=self.device),
                self.pspec)
        state["block_table"][slot] = self._table_row(pages)
        # the copies out of the handle's pinned buffers must be complete
        # before the pages are handed back and the buffers released
        self._sync()
        self._slot_pages[slot] = pages
        self._slot_sampled[slot] = h.sampled
        self._slot_floor[slot] = h.last - (1 if self.ecfg.drafter_mode
                                           != "none" else 0)
        self.host_pool.pop(rid)
        self.swap_last_bytes = h.nbytes
        return state, h.last

    def drop_swap(self, rid) -> bool:
        """Release ``rid``'s host snapshot without resuming it: its bytes
        leave the host pool and the handle's references on its resident
        pages are dropped (the request then resumes by recompute). False
        when nothing was parked."""
        if not self.has_swap(rid):
            return False
        h = self.host_pool.pop(rid)
        if h.ready is not None:
            h.ready.synchronize()       # the buffers' copies end first
        on_host = set(h.host_idx)
        resident = [p for i, p in enumerate(h.page_row) if i not in on_host]
        if resident:
            self.allocator.free(resident)
        return True

    def reset_stats(self) -> None:
        """Restart the allocator's and the host pool's ``peak_used``
        high-water marks at current usage."""
        if self.paged:
            self.allocator.reset_stats()
        if self.host_pool is not None:
            self.host_pool.reset_stats()

    @_in_mesh
    def full_state(self, state: dict) -> dict:
        """``state`` with every K/V leaf at its full trailing axes: the
        slices gathered under a mesh (a collective: every rank calls it),
        ``state`` itself without one. For checks, not for serving."""
        if self.mesh is None:
            return state

        def full(path, leaf):
            if (path.rsplit("/", 1)[-1] in ("k", "v")
                    and isinstance(leaf, Tensor) and leaf.dim() >= 4):
                cfg = self.dcfg if path.startswith("/dcache") else self.tcfg
                return SH.kv_full([leaf], cfg.n_kv_heads, cfg.head_dim)[0]
            return leaf
        return cache_ops.map_tree(full, state)

    # ------------------------------------------------------------------
    # one speculative iteration
    # ------------------------------------------------------------------
    def _mixed_policy(self) -> bool:
        """Whether a step needs the sampled lane: an admitted slot samples,
        or the engine default does (whole-batch prefill fills every row
        with it). False selects the greedy-only lane: the same tokens, no
        warp, sort or threefry launch."""
        return any(self._slot_sampled) or not self.ecfg.sampling.is_greedy

    @tracing.spanned("engine.step")
    @_in_mesh
    def step(self, state: dict, active=None, max_new=None,
             k_row=None, greedy_only: Optional[bool] = None) -> dict:
        """One speculative iteration. The scheduler passes ``active`` (B,)
        bool, per-slot budgets ``max_new`` (B,) and draft caps ``k_row``
        (B,); without them every row is live under the engine's budget and
        full K. ``greedy_only`` picks the lane (default: greedy-only unless
        ``_mixed_policy``). A paged state needs its block table."""
        if self.paged and "block_table" not in state:
            raise ValueError("a paged Engine steps a paged state "
                             "(blank_state + prefill_into_slot)")
        tracing.count("steps")
        if self.prefix_cache is not None:
            self._check_shared_pages()

        def dev(x, dtype):
            return None if x is None else torch.as_tensor(
                x, dtype=dtype, device=self.device)
        if greedy_only is None:
            greedy_only = not self._mixed_policy()
        with torch.no_grad():
            return speculative_step(
                self.model, self.tcfg, self.dcfg, self.ecfg, self.tparams,
                self.dparams, state, active_mask=dev(active, torch.bool),
                max_new=dev(max_new, torch.int32),
                k_row=dev(k_row, torch.int32), greedy_only=greedy_only)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, prompts, extras: Optional[dict] = None,
            sampling: Optional[SamplingParams] = None,
            max_iters: int = 10_000) -> Dict[str, Any]:
        """Prefill (with the target's ``extras``, leading axis B), then step
        until every row has its ``max_new_tokens`` (checked every 8 steps,
        as the JAX engine does), every row under
        ``sampling`` (default ``ecfg.sampling``; a greedy policy takes the
        greedy-only lane). ``steps`` counts the step calls, ``iterations``
        those in which some row was live. Contiguous only: a paged engine
        serves through the scheduler."""
        if self.paged:
            raise ValueError("Engine.run is the whole-batch contiguous loop; "
                             "drive a paged engine through "
                             "serving.scheduler.Scheduler")
        sp = sampling or self.ecfg.sampling
        t0 = time.perf_counter()
        state = self.prefill(prompts, extras, sampling=sp)
        self._sync()
        t_prefill = time.perf_counter() - t0

        steps = 0
        t0 = time.perf_counter()
        while steps < max_iters:
            state = self.step(state, greedy_only=sp.is_greedy)
            steps += 1
            if steps % 8 == 0 or steps < 2:
                if bool((state["new_count"] >= self.ecfg.max_new_tokens).all()):
                    break
        self._sync()
        t_decode = time.perf_counter() - t0

        new_tok = int(state["new_count"].sum())
        row_iters = max(int(state["row_iters"]), 1)
        return {
            "state": state,
            "tokens": state["tokens"].cpu().numpy(),
            "new_tokens": new_tok,
            "iterations": max(int(state["iters"]), 1),
            "steps": steps,
            "acceptance_length": int(state["committed"]) / row_iters,
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "otps": new_tok / max(t_decode, 1e-9),
        }


def _resume_fixup(src: dict, res_tok: Optional[Tensor]) -> dict:
    """Turn a batch-1 admission prefill into a step-boundary resume when
    ``res_tok`` is given: the token committed at ``last`` becomes
    ``res_tok`` (the prefix's final, already emitted token; the prefill's
    own draw is discarded) and the committed count starts at 0, so nothing
    is harvested twice and the next step verifies the true continuation.
    In place; returns ``src``."""
    if res_tok is not None:
        src["tokens"][0, src["last"][0]] = res_tok
        src["new_count"].zero_()
    return src


def _pack(tree: dict):
    """The tensor leaves of ``tree`` (0-dim counters and flags left out)
    laid end to end in one byte buffer, widest element type first so every
    leaf's offset is aligned for its type. Returns ``(buffer, layout)``,
    ``layout`` shaped like ``tree`` with (dtype, shape, offset) per packed
    leaf and None elsewhere."""
    leaves = []
    cache_ops.map_tree(lambda p, t: leaves.append((p, t))
                       if isinstance(t, Tensor) and t.dim() > 0 else None,
                       tree)
    leaves.sort(key=lambda pt: -pt[1].element_size())
    where, off = {}, 0
    for path, t in leaves:
        where[path] = (t.dtype, tuple(t.shape), off)
        off += t.numel() * t.element_size()
    flat = torch.cat([t.reshape(-1).view(torch.uint8) for _, t in leaves])
    return flat, cache_ops.map_tree(lambda p, _: where.get(p), tree)


def _unpack(flat: Tensor, layout: dict) -> dict:
    """The tree ``_pack`` packed, its leaves views of ``flat``."""
    def leaf(_, spec):
        if spec is None:
            return None
        dtype, shape, off = spec
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return flat[off:off + n].view(dtype).view(shape)
    return cache_ops.map_tree(leaf, layout)


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def speculative_step(model, tcfg: ModelConfig, dcfg: Optional[DrafterConfig],
                     ecfg: EngineConfig, tparams, dparams, state: dict,
                     active_mask: Optional[Tensor] = None,
                     max_new: Optional[Tensor] = None,
                     k_row: Optional[Tensor] = None,
                     # eager PyTorch: no trace to specialize
                     greedy_only: bool = False,  # repro-lint: disable=TRACE01
                     ) -> dict:
    """One iteration: draft K -> verify K+1 -> accept -> commit.

    ``active_mask`` (B,) bool masks out free or stalled slots and
    ``max_new`` (B,) gives per-slot budgets (default: every row, the
    engine's budget); a row out of budget or masked is frozen: it commits
    nothing and keeps last/taps/counters. ``k_row`` (B,) caps each row's
    accepted drafts (a greedy row's correction token is then the target
    argmax at the cap, so its stream is unchanged; a sampled row
    force-rejects past it, losslessly). With ``state["block_table"]`` the
    caches are page pools read and written through it. The caches of
    ``state`` are updated in place; the returned state holds them.

    Verification is per row (``state["sampling"]``): greedy rows take the
    argmax prefix match on the raw target logits; sampled rows run seeded
    rejection sampling against the row-warped target with the keys
    ``fold_in(seed, c + 1)``, c + 1 being the first position the step
    determines. With ``ecfg.draft_sampling`` sampled rows draw their drafts
    from the row-warped drafter distribution (``draft_keys``) and hand it
    to the verifier as q; otherwise q is the one-hot of the argmax drafts.
    ``greedy_only`` skips the sampled lane altogether (no warp, sort or
    threefry op); for greedy rows both lanes give the same tokens."""
    B = state["tokens"].shape[0]
    K = ecfg.K if ecfg.drafter_mode != "none" else 0
    c = state["last"]
    tok_next = state["tokens"].gather(1, c[:, None].long())[:, 0]
    dcache = state.get("dcache")
    table = state.get("block_table")
    samp = state["sampling"]

    policy = None
    if ecfg.draft_sampling and not greedy_only and K > 0:
        policy = (draft_keys(samp, c + 1, K), samp["temperature"],
                  samp["top_k"], samp["top_p"])
    dlogits = None
    with tracing.span("step.draft"):
        if ecfg.drafter_mode == "parallel":
            drafts, dlogits, dcache = D.draft_parallel(
                dcfg, tcfg, dparams, dcache, tok_next, state["taps_last"],
                c - 1, K, block_table=table, policy=policy)
        elif ecfg.drafter_mode == "ar":
            drafts, dlogits, dcache = D.draft_ar(
                dcfg, tcfg, dparams, dcache, tok_next, state["taps_last"],
                c - 1, K, block_table=table, policy=policy)
        else:
            drafts = torch.zeros((B, 0), dtype=torch.int32, device=c.device)

    # target verify over [t_last, d_1..d_K] at positions c..c+K
    with tracing.span("step.verify"):
        vt = torch.cat([tok_next[:, None], drafts], dim=1)
        positions = c[:, None] + torch.arange(K + 1, dtype=torch.int32,
                                              device=c.device)[None]
        tout = model.forward(tparams, vt, mode="decode", positions=positions,
                             cache=state["tcache"],
                             collect_taps=ecfg.drafter_mode != "none",
                             block_table=table, snapshots=model.recurrent)
    with tracing.span("step.accept"):
        if K == 0:
            accept_len = torch.zeros((B,), dtype=torch.int32,
                                     device=c.device)
            if greedy_only:
                t_star = tout.logits.argmax(-1).to(torch.int32)
            else:
                t_star = SD.sample_token(
                    step_keys(samp, c + 1), tout.logits[:, 0],
                    samp["temperature"], samp["top_k"],
                    samp["top_p"])[:, None]
        elif greedy_only:
            accept_len, t_star = SD.greedy_verify(drafts, tout.logits)
            if k_row is not None:
                accept_len = torch.minimum(accept_len, k_row)
        else:
            V = tout.logits.shape[-1]
            q = F.one_hot(drafts.long(), V).to(tout.logits.dtype)
            if policy is not None:
                q = torch.where((samp["temperature"] > 0)[:, None, None],
                                SD.warp_probs(dlogits, samp["temperature"],
                                              samp["top_k"], samp["top_p"]),
                                q)
            accept_len, t_star = SD.mixed_verify(
                step_keys(samp, c + 1), drafts, q, tout.logits,
                samp["temperature"], samp["top_k"], samp["top_p"], k_row)

        budget = ecfg.max_new_tokens if max_new is None else max_new
        active = state["new_count"] < budget
        if active_mask is not None:
            active &= active_mask
        accept_len = torch.where(active, accept_len, 0)

    with tracing.span("step.commit"):
        # roll the target cache back to the last accepted token: invalidate
        # attention entries past it, write a recurrent target's snapshot at
        # it (a frozen or masked row keeps its state: it commits nothing)
        tcache = cache_ops.commit(
            tout.cache, c + accept_len, table,
            snapshots=(tout.aux or {}).get("snapshots"),
            accept_idx=torch.where(active, accept_len, -1))

        # append committed tokens t_star[0..accept_len]
        ar = torch.arange(K + 1, dtype=torch.int32, device=c.device)[None]
        idx = c[:, None] + 1 + ar
        keep = (ar <= accept_len[:, None]) & active[:, None]
        safe_idx = torch.where(keep, idx, state["tokens"].shape[1])
        tokens = _scatter_drop(state["tokens"], safe_idx, t_star)
        logprobs = _scatter_drop(state["logprobs"], safe_idx,
                                 _token_logprob(tout.logits, t_star))
        new_last = torch.where(active, c + accept_len + 1, c)

    taps_last = state["taps_last"]
    new_state = {}
    if ecfg.drafter_mode != "none":
        with tracing.span("step.extend"):
            taps_new = tout.taps[torch.arange(B, device=c.device),
                                 accept_len.long()]
            taps_last = torch.where(active[:, None], taps_new, taps_last)
            # extend the drafter cache across the verified block; the stale
            # tail is invalidated by the next positional write
            new_state["dcache"] = D.extend(dcfg, tcfg, dparams, dcache,
                                           t_star, tout.taps, positions,
                                           block_table=table)

    ncommit = torch.where(active, accept_len + 1, 0)
    act = active.to(torch.int32)
    new_state.update(
        tokens=tokens,
        logprobs=logprobs,
        last=new_last,
        taps_last=taps_last,
        tcache=tcache,
        new_count=state["new_count"] + ncommit,
        slot_iters=state["slot_iters"] + act,
        iters=state["iters"] + act.max(),
        row_iters=state["row_iters"] + act.sum(dtype=torch.int32),
        committed=state["committed"] + ncommit.sum(dtype=torch.int32),
        sampling=samp,
    )
    if table is not None:
        new_state["block_table"] = table
    return new_state
