"""Drafter training: the paper's scalable MTP training loop (PyTorch).

Counterpart of the JAX package's ``training/trainer.py``. One trainer covers
both regimes:
- whole-sequence MTP training: one forward/backward over the batch;
- *segmented* training (paper §3.2): the pipeline emits Algorithm-1
  segments; the target taps are computed once per sequence, each segment
  runs its own forward/backward, and the GradAccumulator sums the
  valid-token-weighted grads into one optimizer step. Each query appears in
  exactly one segment with its full attention context, so the summed
  gradient equals the unpartitioned one.

The AR EAGLE-3 baseline trains through ``losses.ttt_forward_loss``.

A step is four stages, each a method, in this order: ``taps`` (the target
forward under ``torch.no_grad()``, the counterpart of ``stop_gradient``;
its attention is the flash kernel on the card), ``loss`` (the drafter
forward; its attention is the MTP kernel on the card), ``grads`` (the
backward) and ``apply`` (AdamW). The first three are the module's free
functions ``target_taps``, ``drafter_loss`` and ``param_grads``, which the
sharded train step (``launch/steps.py``) runs too. The drafter parameters
stay float32.

A VLM or encoder-decoder target's taps forward takes the trainer's
``extras`` (its modality inputs, leading axis the batch's); a VLM
target's taps cover [vision, text], and the drafter's positions index the
text region, so they are sliced to it.

The regularized variant's dropout keys are the JAX trainer's: the stream
starts at ``fold_in(PRNGKey(seed), 7)`` and is split once per forward (a
whole batch, or each segment), so its masks are the reference's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import DrafterConfig, ModelConfig
from repro_torch.core import drafter as D
from repro_torch.core import losses
from repro_torch.data.pipeline import MTPBatch, MTPPipeline
from repro_torch.models.registry import extras_on, get_model
from repro_torch.optim import (GradAccumulator, adamw_init, adamw_update,
                               apply_updates, linear_warmup_schedule)
from repro_torch.serving.engine import resolve_device
from repro_torch.tree import leaves, tree_map, unflatten

Tensor = torch.Tensor


@dataclass
class TrainConfig:
    lr: float = 1e-4                  # paper §5.1
    total_steps: int = 1000
    warmup_ratio: float = 0.0025
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    depth_weight_decay: float = 1.0
    hca_weight: float = 0.1


# -- the stages of a step, shared with the sharded step (launch/steps.py) --

def target_taps(model, tparams: dict, tokens: Tensor,
                extras: Optional[dict] = None) -> Tensor:
    """Target taps (B, n, 3·D_t) of the text region, no gradient. Only the
    taps are used, so the LM head runs on the last position alone."""
    with torch.no_grad():
        taps = model.forward(tparams, tokens, mode="train",
                             collect_taps=True, head_last_only=True,
                             **(extras or {})).taps
    return taps[:, -tokens.shape[1]:]


def drafter_loss(dcfg: DrafterConfig, tcfg: ModelConfig, tc: TrainConfig,
                 params: dict, tokens: Tensor, taps: Tensor, pos: Tensor,
                 depth: Tensor, labels: Tensor,
                 rng: Optional[Tensor] = None):
    """The drafter forward and its loss: (loss, metrics); ``rng`` keys the
    regularized variant's dropout."""
    if dcfg.parallel:
        logits, _ = D.mtp_forward(dcfg, tcfg, params, tokens, taps, pos,
                                  depth, rng=rng)
        return losses.mtp_loss(logits, labels, depth,
                               depth_weight_decay=tc.depth_weight_decay)
    return losses.ttt_forward_loss(dcfg, tcfg, params, tokens, taps,
                                   hca_weight=tc.hca_weight)


def param_grads(loss: Tensor, params: dict) -> dict:
    """d loss / d params; a leaf the loss does not reach (a frozen
    embedding) gets zeros."""
    flat = leaves(params)
    g = torch.autograd.grad(loss, flat, allow_unused=True)
    return unflatten(params, [torch.zeros_like(p) if gi is None else gi
                              for p, gi in zip(flat, g)])


class Trainer:
    """Epoch loop over an MTPPipeline; handles both whole-sequence and
    segmented (within-sequence accumulation) batches.

    Args:
      tcfg / dcfg: target and drafter configs.
      tparams: target parameters (``models.transformer`` layout).
      tc: optimizer and loss settings.
      seed: seeds the drafter init (when ``dparams`` is None) and the
        regularized variant's dropout key stream.
      dparams: initial drafter parameters; drawn from ``seed`` if None.
      device: "cuda" (the default) or "cpu"; a missing card raises.
      extras: the target's modality inputs for every batch (a VLM or
        encoder-decoder target), leading axis the batch's.
    """

    def __init__(self, tcfg: ModelConfig, dcfg: DrafterConfig, tparams: dict,
                 tc: TrainConfig, *, seed: int = 0,
                 dparams: Optional[dict] = None, device="cuda",
                 extras: Optional[dict] = None):
        self.device = resolve_device(device)
        self.tcfg, self.dcfg, self.tc = tcfg, dcfg, tc
        self.model = get_model(tcfg)
        self.tparams = tree_map(lambda t: t.to(self.device), tparams)
        self.extras = extras_on(extras, self.device)
        if dparams is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            dparams = D.init_params(dcfg, tcfg, gen, device=self.device)
        self.dparams = tree_map(lambda t: t.to(self.device), dparams)
        self.opt_state = adamw_init(self.dparams)
        self.rng = prng.fold_in(prng.PRNGKey(seed, device=self.device), 7)
        self.sched = linear_warmup_schedule(tc.lr, tc.total_steps,
                                            tc.warmup_ratio)
        self.metrics_log: List[dict] = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a) -> Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _advance_rng(self) -> Tensor:
        """The next dropout key: split the carried key, keep the first half
        (the JAX trainer's sequential data-order stream)."""
        self.rng, sub = prng.split(self.rng, 2)
        return sub

    # -- the four stages of a step ------------------------------------------

    def taps(self, tokens: Tensor) -> Tensor:
        return target_taps(self.model, self.tparams, tokens, self.extras)

    def loss(self, params: dict, tokens: Tensor, taps: Tensor, pos: Tensor,
             depth: Tensor, labels: Tensor, rng: Optional[Tensor] = None):
        return drafter_loss(self.dcfg, self.tcfg, self.tc, params, tokens,
                            taps, pos, depth, labels, rng=rng)

    def grads(self, loss: Tensor, params: dict) -> dict:
        return param_grads(loss, params)

    def apply(self, grads: dict) -> dict:
        """One AdamW step on the drafter; returns {"grad_norm", "lr"}."""
        with torch.no_grad():
            updates, self.opt_state, om = adamw_update(
                grads, self.opt_state, self.dparams, lr=self.sched,
                weight_decay=self.tc.weight_decay,
                max_grad_norm=self.tc.max_grad_norm)
            self.dparams = apply_updates(self.dparams, updates)
        return om

    # -- steps --------------------------------------------------------------

    def _loss_and_grads(self, tokens, taps, batch: MTPBatch):
        params = tree_map(lambda p: p.detach().requires_grad_(True),
                          self.dparams)
        loss, metrics = self.loss(params, tokens, taps,
                                  self._tensor(batch.pos),
                                  self._tensor(batch.depth),
                                  self._tensor(batch.labels),
                                  rng=self._advance_rng())
        return self.grads(loss, params), metrics

    def batch_grads(self, batch: Union[MTPBatch, List[MTPBatch]]):
        """(grads, metrics) of one batch without applying them: a whole
        batch, or the segments of one (their valid-token-weighted mean;
        metrics of the last segment)."""
        if isinstance(batch, MTPBatch):
            tokens = self._tensor(batch.tokens)
            return self._loss_and_grads(tokens, self.taps(tokens), batch)
        # segmented: within-sequence gradient accumulation (paper §3.2)
        tokens = self._tensor(batch[0].tokens)
        taps = self.taps(tokens)
        acc = GradAccumulator(self.dparams).init()
        metrics = {}
        for sg in batch:
            g, metrics = self._loss_and_grads(self._tensor(sg.tokens), taps,
                                              sg)
            acc = GradAccumulator.add(acc, g, float(metrics["valid_tokens"]))
            del g
        return GradAccumulator.mean(acc), metrics

    def train_batch(self, batch) -> dict:
        grads, metrics = self.batch_grads(batch)
        metrics = dict(metrics, **self.apply(grads))
        return {k: float(v) for k, v in metrics.items()}

    def train(self, pipeline: MTPPipeline, epochs: int = 1,
              log_every: int = 0) -> list:
        """Run ``epochs`` passes over ``pipeline``. Each step's metrics go
        into ``metrics_log`` with its ``epoch``, its wall ``seconds``
        (synchronized on the card) and its ``label_tokens`` (labels >= 0
        over all segments)."""
        step = 0
        for ep in range(epochs):
            for batch in pipeline:
                segs = batch if isinstance(batch, list) else [batch]
                self._sync()
                t0 = time.perf_counter()
                m = self.train_batch(batch)
                self._sync()
                m["seconds"] = time.perf_counter() - t0
                m["label_tokens"] = sum(int((s.labels >= 0).sum())
                                        for s in segs)
                m["epoch"] = ep
                self.metrics_log.append(m)
                step += 1
                if log_every and step % log_every == 0:
                    print(f"step {step}: loss={m['loss']:.4f} "
                          f"acc={m.get('acc', 0):.3f} "
                          f"mtp_acc={m.get('mtp_acc', 0):.3f}", flush=True)
        return self.metrics_log
