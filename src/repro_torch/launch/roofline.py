"""Roofline accounting for the port on H100s.

Counterpart of the JAX package's ``launch/roofline.py``. Three terms a
step, per GPU, in seconds, against one H100 SXM's published constants:

    compute    = FLOPs / 989e12          (bf16 dense tensor-core peak)
    memory     = bytes / 3.35e12         (HBM3)
    collective = model-axis bytes / 450e9 + data/pod-axis bytes / 50e9

Sources: NVIDIA H100 Tensor Core GPU datasheet (SXM5: 989 TFLOPS bf16
dense, 3.35 TB/s HBM3, NVLink 900 GB/s, i.e. 450 GB/s each way) and the
DGX H100 system (one 400 Gb/s ConnectX-7 NDR link per GPU between nodes:
50 GB/s). The "model" axis is one node's NVLink domain (8 GPUs,
``launch/mesh.py``); "data" and "pod" cross nodes. These are estimates
from the constants, not measurements.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over a step
run on the meta device (``launch/dryrun.py``), bytes from the same run's
operand traffic, collective bytes from the counters of
``sharding.utils`` (the output bytes of every gather and reduce, per
axis): for a dry-run they are counted analytically, the meta run making
the same collective calls a real run makes (``collective_stats``).
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core import cod
from repro_torch.sharding import utils as SH

H100 = dict(
    peak_flops=989e12,       # bf16 dense FLOP/s per GPU (H100 SXM5)
    hbm_bw=3.35e12,          # B/s per GPU (HBM3)
    nvlink_bw=450e9,         # B/s each way per GPU within a node
    internode_bw=50e9,       # B/s per GPU between nodes (400 Gb/s NDR)
    hbm_bytes=80e9,          # bytes of device memory per GPU
)

# the bandwidth an axis's collectives cross
AXIS_BW = {"model": H100["nvlink_bw"], "data": H100["internode_bw"],
           "pod": H100["internode_bw"]}


def collective_stats(counts: Optional[dict] = None) -> Dict[str, dict]:
    """Per collective kind {count, bytes, by_axis: {axis: bytes}}, from
    ``sharding.utils.counters()`` (the counters since its last reset) or
    the given ``counts``."""
    counts = SH.counters() if counts is None else counts
    out = {}
    for kind, c in counts.items():
        if kind == "use":
            continue
        out[kind] = {"count": c["calls"], "bytes": c["bytes"],
                     "by_axis": {a: v["bytes"] for a, v in
                                 c["by_axis"].items()}}
    return out


def roofline_terms(flops: float, nbytes: float, coll: Dict[str, dict],
                   n_gpus: int, model_flops: float = 0.0) -> dict:
    """The three terms per GPU from the per-GPU FLOPs and bytes of a step
    and its collective statistics; ``bottleneck`` names the largest, and
    ``useful_flops_ratio`` is ``model_flops`` over all GPUs' FLOPs."""
    by_axis: Dict[str, float] = {}
    for c in coll.values():
        for a, b in c["by_axis"].items():
            by_axis[a] = by_axis.get(a, 0.0) + b
    t_coll = sum(b / AXIS_BW.get(a, H100["internode_bw"])
                 for a, b in by_axis.items())
    terms = {"compute_s": flops / H100["peak_flops"],
             "memory_s": nbytes / H100["hbm_bw"],
             "collective_s": t_coll,
             "flops_per_gpu": flops, "bytes_per_gpu": nbytes,
             "collective_bytes_per_gpu": sum(by_axis.values()),
             "collective_bytes_by_axis": by_axis}
    terms["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                              key=lambda k: terms[k])
    if model_flops:
        terms["model_flops"] = model_flops
        terms["useful_flops_ratio"] = model_flops / max(flops * n_gpus, 1.0)
    return terms


def model_flops_estimate(tcfg, shape, dcfg=None, k_infer: int = 5) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) 'useful' FLOPs for the workload."""
    n_params = param_count(tcfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        flops = 2.0 * n_params * tokens          # frozen target fwd only
        if dcfg is not None:
            d_params = drafter_param_count(dcfg, tcfg)
            m = cod.expanded_length(shape.seq_len, dcfg.k_train,
                                    dcfg.cod_rate)
            flops += 6.0 * d_params * shape.global_batch * m
        return flops
    if shape.kind == "prefill":
        return 2.0 * n_params * shape.global_batch * shape.seq_len
    # decode: one speculative iteration = K+1 target tokens + K drafter slots
    flops = 2.0 * n_params * shape.global_batch * (k_infer + 1)
    if dcfg is not None:
        flops += 2.0 * drafter_param_count(dcfg, tcfg) * \
            shape.global_batch * k_infer
    return flops


def param_count(cfg, active_only: bool = False) -> float:
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":
        di = cfg.ssm.expand * d
        per = d * (2 * di + 2 * cfg.ssm.d_state +
                   di // cfg.ssm.head_dim) + di * d
        return emb + L * per
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d
    glu = cfg.mlp_variant in ("swiglu", "geglu")
    mlp = d * cfg.d_ff * (3 if glu else 2)
    total = emb
    for li in range(L):
        total += attn
        if cfg.is_moe_layer(li):
            e = (cfg.moe.top_k if active_only else cfg.moe.n_experts)
            total += mlp * (e + cfg.moe.n_shared_experts)
        else:
            total += mlp
    if cfg.family == "hybrid":
        W = cfg.hybrid.lru_width or d
        total += L * (2 * d * W + 2 * W * W + W * d) * 2 // 3  # rec slots
    if cfg.n_encoder_layers:
        total += cfg.n_encoder_layers * (attn + mlp)
    return float(total)


def drafter_param_count(dcfg, tcfg) -> float:
    d = dcfg.d_model
    per = d * (dcfg.n_heads + 2 * dcfg.n_kv_heads) * dcfg.head_dim \
        + dcfg.n_heads * dcfg.head_dim * d + 3 * d * dcfg.d_ff
    return float(tcfg.vocab_size * d * 2 + dcfg.num_taps * tcfg.d_model * d
                 + 2 * d * d + dcfg.n_layers * per)
