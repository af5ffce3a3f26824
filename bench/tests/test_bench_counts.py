"""The count functions against shapes worked by hand, and the trace's
reductions on synthetic kernel lists.

    PYTHONPATH=src python -m pytest -q bench/tests
"""
import math

import pytest

from bench.lib import counts as C
from bench.lib import trace as T

QWEN = {"n_layers": 28, "d_model": 1536, "n_heads": 12, "n_kv_heads": 2,
        "head_dim": 128, "d_ff": 8960, "vocab_size": 151936}
DRAFTER = {"n_layers": 4, "d_model": 1536, "n_heads": 12, "n_kv_heads": 12,
           "head_dim": 128, "d_ff": 5376, "num_taps": 3}


def test_paged_decode_by_hand():
    # 2 rows of 6 queries, 12 heads of 128, 2 KV heads; rows hold 100 and
    # 50 live keys, tables of 8 pages
    w = C.paged_decode_attention(2, 6, 12, 2, 128, 8, [100, 50])
    assert w.flops == 4 * 6 * 12 * 128 * 150
    kv = 150 * (2 * 2 * 128 * 2 + 4)          # K, V and positions
    qo = 2 * (2 * 6 * 12 * 128 * 2)           # q read, out written
    stats = 2 * 2 * 12 * 6 * 4                # m and l, float32
    assert w.bytes == kv + qo + stats + 2 * 8 * 4 + 2 * 6 * 4
    # memory bound: the least time is bytes at 3.35 TB/s
    assert w.least_s() == pytest.approx(w.bytes / 3.35e12)


def test_flash_causal_by_hand():
    # 1 x 4 queries over 4 keys, causal: 1 + 2 + 3 + 4 = 10 pairs
    w = C.flash_attention(1, 4, 4, 2, 1, 32)
    assert w.flops == 4 * 2 * 32 * 10
    assert w.bytes == (2 * 4 * 2 * 32 + 2 * 4 * 1 * 32) * 2
    # queries aligned to the end of 6 keys see 3, 4, 5, 6 of them
    assert C.flash_attention(1, 4, 6, 2, 1, 32).flops == 4 * 2 * 32 * 18
    # kv_len masks keys past it; not causal sees them all
    assert C.flash_attention(1, 4, 4, 2, 1, 32, causal=False,
                             kv_len=3).flops == 4 * 2 * 32 * 12


def test_flash_prefill_bucket_is_compute_bound():
    w = C.flash_attention(1, 8192, 8192, 12, 2, 128)
    assert w.flops == 4 * 12 * 128 * 8192 * 8193 / 2
    assert w.flops / C.PEAK_FLOPS["bfloat16"] > w.bytes / C.PEAK_BYTES_PER_S


def test_target_linear_by_hand():
    per_layer = (2 * 1536 * 128 * (2 * 12 + 2 * 2)     # q, k, v, o
                 + 2 * 3 * 1536 * 8960)                 # SwiGLU
    assert C.target_linear_flops(QWEN) == 28 * per_layer
    # about 2 x 1.31 B non-embedding parameters
    assert C.target_linear_flops(QWEN) / 2 == pytest.approx(1.31e9, rel=0.01)


def test_dbrx_moe_layer_counts_routed_experts_only():
    dbrx = {"n_layers": 1, "d_model": 6144, "n_heads": 48, "n_kv_heads": 8,
            "head_dim": 128, "d_ff": 10752,
            "moe": {"n_experts": 16, "top_k": 4}}
    attn = 2 * 6144 * 128 * (2 * 48 + 2 * 8)
    experts = 4 * 2 * 3 * 6144 * 10752                  # top-4 of 16
    router = 2 * 6144 * 16
    assert C.target_linear_flops(dbrx) == attn + experts + router


def test_serve_step_by_hand():
    cfg = {"target": QWEN, "drafter": DRAFTER}
    f = C.ServeFlops(cfg, K=5)
    t_lin, t_head = C.target_linear_flops(QWEN), 2 * 1536 * 151936
    d_fc = 2 * 3 * 1536 * 1536
    d_lin = C.drafter_linear_flops(DRAFTER)
    c = 1000
    want = (6 * (t_lin + t_head)
            + 4 * 28 * 12 * 128 * (6 * c + 21)          # verify
            + d_fc + 5 * (d_lin + t_head)               # draft
            + 4 * 4 * 12 * 128 * (5 * (c - 1) + 15)
            + 6 * (d_fc + d_lin)                        # extend
            + 4 * 4 * 12 * 128 * (6 * c + 21))
    assert f.step([c]) == pytest.approx(want)
    assert f.step([]) == 0
    # a P-token admission: prefill, head at one position, extend P - 1
    P = 512
    want = (P * t_lin + t_head + 4 * 28 * 12 * 128 * P * (P + 1) / 2
            + (P - 1) * (d_fc + d_lin)
            + 4 * 4 * 12 * 128 * (P - 1) * P / 2)
    assert f.admission(P) == pytest.approx(want)


def test_busy_union_counts_overlap_once():
    ks = [("a", 0.0, 1.0), ("b", 0.5, 1.0), ("c", 3.0, 0.5),
          ("d", 3.1, 0.1)]
    assert T.busy_intervals(ks) == [(0.0, 1.5), (3.0, 3.5)]
    assert T.busy_seconds(ks) == pytest.approx(2.0)


def test_kernel_seconds_by_name_with_combine():
    paged = "void repro_decode_tc::decode_tc_attention_kernel<128, true>(P)"
    plain = "void repro_decode_tc::decode_tc_attention_kernel<128, false>(P)"
    comb = "void repro_decode_tc::decode_combine_attention_kernel<128>(P)"
    ks = [(paged, 0.0, 2e-3), (comb, 2e-3, 1e-4), ("nvjet_gemm", 3e-3, 1e-3),
          (plain, 5e-3, 1e-3), (comb, 6e-3, 2e-4),
          ("void flash_tc_attention_kernel<128>(P)", 7e-3, 4e-3)]
    assert T.kernel_seconds(ks, "paged_decode_attention") == (
        pytest.approx(2.1e-3), 1)
    assert T.kernel_seconds(ks, "decode_attention") == (
        pytest.approx(1.2e-3), 1)
    assert T.kernel_seconds(ks, "flash_attention") == (pytest.approx(4e-3), 1)
    assert T.gemm_seconds(ks) == pytest.approx(1e-3)
    assert T.launches(ks + [("Memcpy DtoH", 0.0, 1.0)]) == 6


def test_roofline_share_and_silence():
    paged = "decode_tc_attention_kernel<128, true>"
    w = C.paged_decode_attention(128, 6, 12, 2, 128, 193, [1500] * 128)
    share = T.roofline_share([(paged, 0.0, 2 * w.least_s())],
                             [("paged_decode_attention", w)],
                             "paged_decode_attention")
    assert share == pytest.approx(50.0)
    # no kernel or no call: nothing to read
    assert T.roofline_share([], [("paged_decode_attention", w)],
                            "paged_decode_attention") is None
    assert T.roofline_share([(paged, 0.0, 1.0)], [],
                            "paged_decode_attention") is None


def test_idle_gaps_by_innermost_span():
    ks = [("k", 0.0, 1.0), ("k", 2.0, 1.0), ("k", 5.0, 1.0)]
    spans = [("bench.engine.step", 0.5, 4.0),
             ("bench.sched.grow", 1.2, 1.9), ("bench.sched.admit", 4.5, 5.5)]
    gaps = T.idle_gaps(ks, spans)
    # the gap at 3-5 s has its middle in the step, not yet in the admit
    assert gaps == [["bench.engine.step", pytest.approx(2.0)],
                    ["bench.sched.grow", pytest.approx(1.0)]]
    assert T.idle_gaps(ks, []) == [["outside the harness's spans",
                                    pytest.approx(3.0)]]


def test_top_ops_sums_by_name():
    ks = [("a", 0, 1.0), ("b", 0, 3.0), ("a", 0, 2.5)]
    assert T.top_ops(ks, top=1) == [["a", 3.5]]
    assert math.isclose(sum(v for _, v in T.top_ops(ks)), 6.5)
