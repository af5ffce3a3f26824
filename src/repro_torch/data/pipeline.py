"""Training data pipeline for P-EAGLE.

Corpora
-------
``markov_corpus``          — seeded synthetic token sequences with learnable
                             bigram structure (offline stand-in for UltraChat
                             etc.; the drafter-vs-target distillation is what
                             matters, not the text).
``self_generated_corpus``  — greedy rollouts *from the target model itself*:
                             the paper trains drafters on target-generated
                             reasoning traces, which makes labels == target
                             argmax. This is what lets a drafter reach AL > 1
                             against a frozen random target in benchmarks.

Batching
--------
``MTPPipeline`` packs sequences to fixed length, samples COD positions
(chain-closed, fixed-count — core/cod.py), pads to the static expanded
length, attaches labels (token[p+2], the EAGLE-shifted pairing), and — when
``segments > 1`` — applies Algorithm 1 to emit within-sequence
gradient-accumulation segments (paper §3.2).

Counterpart of the JAX package's ``data/pipeline.py``: the corpora and the
batches are numpy and equal to the JAX package's for the same seeds;
``self_generated_corpus`` rolls out through the port's ``Engine``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from repro_torch.core import cod, partition


@dataclass
class MTPBatch:
    tokens: np.ndarray          # (B, n) original sequences
    pos: np.ndarray             # (B, M) expanded rope positions (-1 pad)
    depth: np.ndarray           # (B, M) prediction depths (-1 pad)
    labels: np.ndarray          # (B, M) target token ids (-1 ignore)
    weight: float = 1.0         # segment weight (valid-label count share)


def markov_corpus(seed: int, n_seqs: int, seq_len: int, vocab: int,
                  branch: int = 4) -> np.ndarray:
    """Sparse-transition Markov chain: each token has `branch` plausible
    successors — compressible structure a small model can learn."""
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branch))
    seqs = np.zeros((n_seqs, seq_len), np.int32)
    state = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        seqs[:, t] = state
        pick = rng.integers(0, branch, size=n_seqs)
        state = succ[state, pick]
    return seqs


def self_generated_corpus(model, params, *, seed: int, n_seqs: int,
                          seq_len: int, prompt_len: int = 4,
                          batch: int = 8, device="cuda") -> np.ndarray:
    """Greedy rollouts from the target model (the paper's data regime:
    drafters train on target-generated traces), through the port's
    ``Engine`` in "none" mode on ``device``. The KV cache takes the
    target's dtype."""
    from repro_torch.serving.engine import Engine, EngineConfig

    rng = np.random.default_rng(seed)
    out = []
    vocab = model.cfg.vocab_size
    ecfg = EngineConfig(K=0, max_new_tokens=seq_len - prompt_len,
                        drafter_mode="none", cache_dtype=model.cfg.dtype,
                        max_len=seq_len + 8)
    eng = Engine(model.cfg, None, params, None, ecfg, batch, device=device)
    while len(out) * batch < n_seqs:
        prompts = rng.integers(0, vocab - 2,
                               size=(batch, prompt_len)).astype(np.int32)
        out.append(eng.run(prompts)["tokens"][:, :seq_len])
    return np.concatenate(out, axis=0)[:n_seqs].astype(np.int32)


class MTPPipeline:
    """Yields MTPBatch (full sequences) or lists of segment MTPBatches."""

    def __init__(self, corpus: np.ndarray, *, k_train: int, cod_rate: float,
                 batch: int, seed: int = 0, segments: int = 1,
                 shuffle: bool = True):
        self.corpus = corpus
        self.K = k_train
        self.r = cod_rate
        self.batch = batch
        self.segments = segments
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.n = corpus.shape[1]
        self.M = cod.expanded_length(self.n, k_train, cod_rate)

    def _expand_row(self, row: np.ndarray):
        pos, depth = cod.sample_cod(self.rng, self.n, self.K, self.r)
        pos, depth = cod.pad_to(pos, depth, self.M)
        # EAGLE pairing: position p predicts token[p+2]
        tgt = pos + 2
        ok = (pos >= 0) & (tgt < self.n)
        labels = np.where(ok, row[np.clip(tgt, 0, self.n - 1)], -1)
        return pos, depth, labels

    def __iter__(self) -> Iterator:
        idx = np.arange(len(self.corpus))
        if self.shuffle:
            self.rng.shuffle(idx)
        for s in range(0, len(idx) - self.batch + 1, self.batch):
            rows = self.corpus[idx[s:s + self.batch]]
            pos = np.zeros((self.batch, self.M), np.int32)
            dep = np.zeros((self.batch, self.M), np.int32)
            lab = np.zeros((self.batch, self.M), np.int32)
            for b in range(self.batch):
                pos[b], dep[b], lab[b] = self._expand_row(rows[b])
            if self.segments <= 1:
                yield MTPBatch(rows, pos, dep, lab)
            else:
                yield self._segment_batch(rows, pos, dep, lab)

    def _segment_batch(self, rows, pos, dep, lab) -> List[MTPBatch]:
        """Algorithm 1 per row; segments are padded to a common static shape
        so one jitted segment-step serves all of them."""
        per_row = [partition.build_segments(
            pos[b][dep[b] >= 0], dep[b][dep[b] >= 0], self.n, self.segments)
            for b in range(self.batch)]
        n_seg = max(len(sr) for sr in per_row)
        kv_max = max(len(sg.kv_pos) for sr in per_row for sg in sr)
        kv_max = int(np.ceil(kv_max / 64) * 64)
        out: List[MTPBatch] = []
        total_valid = max(int((lab >= 0).sum()), 1)
        for si in range(n_seg):
            spos = np.full((self.batch, kv_max), -1, np.int32)
            sdep = np.full((self.batch, kv_max), -1, np.int32)
            slab = np.full((self.batch, kv_max), -1, np.int32)
            for b, sr in enumerate(per_row):
                if si >= len(sr):
                    continue
                sg = sr[si]
                m = len(sg.kv_pos)
                spos[b, :m] = sg.kv_pos
                sdep[b, :m] = sg.kv_depth
                # loss only on this segment's own queries
                row_lab = np.full(m, -1, np.int32)
                qsel = sg.q_in_kv
                full_lab = dict(zip(
                    zip(dep[b].tolist(), pos[b].tolist()), lab[b].tolist()))
                for j in qsel.tolist():
                    key = (int(sg.kv_depth[j]), int(sg.kv_pos[j]))
                    row_lab[j] = full_lab.get(key, -1)
                slab[b, :m] = row_lab
            w = float((slab >= 0).sum()) / total_valid
            out.append(MTPBatch(rows, spos, sdep, slab, weight=w))
        return out
