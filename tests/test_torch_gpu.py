"""Card-only tests of the port: each CUDA kernel against its plain version
on the card, the engine's greedy losslessness through the kernels, paged
scheduler serving through the paged decode kernel, greedy and sampled,
the threefry PRNG's words on the card against the CPU's, the chi-square
losslessness of rejection verification on the card, the flash training
attention's gradients, and reduced training steps through the MTP kernel.

Marked ``gpu``; each test decides inside the ``card`` fixture whether a
card exists and skips without one. The card's machine has no JAX, which
``tests/conftest.py`` imports, so run them there without the conftest:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

Inputs: q ~ 2 N(0, 1), k, v ~ N(0, 1), so scores have a std of 2 and
attention is peaked, as in a trained model. Tolerances, elementwise
|kernel - plain| <= atol + rtol |plain|: in bfloat16 atol 1e-4, rtol 2^-6
(both compute in float32 and round the output once, so they differ by at
most one rounding step of the output; two are allowed); in float32 atol
1e-4 (sums in another order)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(g, q_shape, kv_shape, dtype, device):
    return tuple((scale * torch.randn(s, generator=g, device=device)).to(dtype)
                 for scale, s in ((2.0, q_shape), (1.0, kv_shape),
                                  (1.0, kv_shape)))


def _tol(dtype):
    """(atol, rtol) of the kernel against its plain version."""
    return (1e-4, 2 ** -6) if dtype == torch.bfloat16 else (1e-4, 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KV,hd,S,valid,window", [
    (8, 6, 12, 2, 128, 1024, 600, 0),      # target verify, phase 1
    (8, 5, 12, 12, 128, 1024, 600, 0),     # drafter draft, phase 1
    (8, 511, 12, 12, 128, 511, 511, 0),    # drafter prefill extend, phase 2
    (8, 511, 12, 12, 128, 1024, 0, 0),     # ... phase 1: empty cache
    (2, 6, 4, 2, 64, 256, 192, 64),        # window
    (1, 8, 2, 1, 128, 96, 72, 0),          # ragged key tail
    (1, 1, 4, 4, 32, 512, 384, 0),
    (8, 6, 12, 2, 128, 1000, 600, 0),      # S not a multiple of the chunk
    (8, 6, 12, 2, 128, 1024, 0, 0),        # every key empty: zeros, l 0
    (8, 6, 12, 2, 128, 1024, 600, 100),    # window across chunk edges
    (8, 6, 12, 12, 128, 1024, 600, 0),     # drafter extend, phase 1
    # batch-1 admission extend: several row tiles, each split 4 ways
    (1, 511, 12, 12, 128, 1024, 0, 0),     # phase 1: empty cache
    (1, 511, 12, 12, 128, 511, 511, 0),    # phase 2, bucket 512
    (1, 255, 12, 12, 128, 255, 255, 0),    # phase 2, bucket 256
    (1, 638, 12, 12, 128, 638, 638, 0),    # phase 2, exact length
    (1, 200, 12, 2, 128, 1024, 600, 0),    # row tiles x splits, live keys
    (1, 200, 12, 2, 128, 1024, 600, 150),  # ... and a window
])
def test_decode_kernel_matches_plain(card, dtype, B, T, H, KV, hd, S, valid,
                                     window):
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = _qkv(g, (B, T, H, hd), (B, S, KV, hd), dtype, card)
    kpos = torch.arange(S, dtype=torch.int32, device=card)[None].repeat(B, 1)
    kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32).contiguous()
    qpos = (max(valid, T) - T + torch.arange(T, dtype=torch.int32,
                                             device=card))[None].repeat(B, 1)
    before = ops.launches["decode_attention"]
    out, m, l = ops.decode_attention(q, k, v, kpos, qpos, scale=hd ** -0.5,
                                     window=window, return_stats=True)
    torch.cuda.synchronize()
    assert ops.launches["decode_attention"] == before + 1
    po, pm, pl = ops.decode_attention_plain(q, k, v, kpos, qpos,
                                            scale=hd ** -0.5, window=window,
                                            return_stats=True)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)
    dead = (l == 0).permute(0, 3, 1, 2).reshape(B, T, H)   # rows seeing no key
    if dead.any():
        assert out[dead].abs().max().item() == 0.0


@pytest.mark.parametrize("T,H,KV,valid", [
    (6, 12, 2, 576),       # target verify, phase 1
    (5, 12, 12, 575),      # drafter draft, phase 1
    (6, 12, 12, 576),      # drafter extend, phase 1
])
def test_decode_serving_shapes_split_and_count_once(card, T, H, KV, valid):
    """At the serving path's phase-1 shapes the bfloat16 kernel splits the
    1024 cache slots across blocks, and a call (pass 1 and its combine)
    still moves the launch counter by one."""
    B, hd, S = 8, 128, 1024
    n_sm = torch.cuda.get_device_properties(card).multi_processor_count
    row_blocks = -(-(H // KV) * T // ops.DECODE_ROW_TILE) * B * KV
    splits, _ = ops.decode_split(S, row_blocks, n_sm)
    assert splits > 1
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = _qkv(g, (B, T, H, hd), (B, S, KV, hd), torch.bfloat16, card)
    kpos = torch.arange(S, dtype=torch.int32, device=card)[None].repeat(B, 1)
    kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32).contiguous()
    qpos = (valid + torch.arange(T, dtype=torch.int32, device=card))[
        None].repeat(B, 1)
    before = ops.launches["decode_attention"]
    out = ops.decode_attention(q, k, v, kpos, qpos, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert ops.launches["decode_attention"] == before + 1
    want = ops.decode_attention_plain(q, k, v, kpos, qpos, scale=hd ** -0.5)
    torch.testing.assert_close(out.float(), want.float(), atol=1e-4,
                               rtol=2 ** -6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,causal,window,cap,kv_len", [
    (8, 512, 512, 12, 2, 128, True, 0, 0.0, 0),    # target prefill
    (2, 128, 128, 4, 2, 64, True, 0, 0.0, 0),
    (1, 256, 256, 4, 4, 32, True, 64, 0.0, 0),
    (1, 64, 192, 2, 1, 128, False, 0, 0.0, 0),
    (2, 96, 96, 6, 2, 64, True, 0, 50.0, 0),
    (8, 500, 500, 12, 2, 128, True, 0, 0.0, 0),    # ragged query and key tiles
    (1, 1, 1, 12, 2, 128, True, 0, 0.0, 0),
    (1, 2048, 2048, 12, 2, 128, True, 0, 0.0, 0),  # training tap
    (2, 100, 300, 4, 2, 64, True, 0, 0.0, 0),      # Sq < Skv
    (2, 300, 100, 4, 2, 64, True, 0, 0.0, 0),      # Sq > Skv
    (2, 256, 256, 4, 2, 64, True, 0, 0.0, 200),    # kv_len < Skv
    (2, 200, 256, 4, 2, 128, False, 0, 0.0, 150),
    (2, 160, 160, 4, 2, 32, True, 64, 0.0, 0),     # window, each head dim
    (2, 160, 160, 4, 2, 64, True, 64, 0.0, 0),
    (2, 160, 160, 4, 2, 128, True, 64, 0.0, 0),
    (2, 160, 160, 4, 2, 32, True, 0, 50.0, 0),     # softcap, each head dim
    (2, 160, 160, 4, 2, 128, True, 0, 50.0, 0),
    (2, 160, 160, 4, 2, 32, False, 0, 0.0, 0),     # non-causal
    (2, 160, 160, 4, 2, 64, False, 0, 0.0, 0),
])
def test_flash_kernel_matches_plain(card, dtype, B, Sq, Skv, H, KV, hd,
                                    causal, window, cap, kv_len):
    g = torch.Generator(device=card).manual_seed(1)
    q, k, v = _qkv(g, (B, Sq, H, hd), (B, Skv, KV, hd), dtype, card)
    kw = dict(scale=hd ** -0.5, causal=causal, window=window, softcap=cap,
              kv_len=kv_len)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(),
                               ops.flash_attention_plain(q, k, v, **kw).float(),
                               atol=atol, rtol=rtol)


def test_cuda_tensor_never_takes_the_plain_path(card):
    q = torch.zeros((1, 2, 2, 48), device=card)       # hd 48: no kernel
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, q[:, :, :1].contiguous(),
                            q[:, :, :1].contiguous(), scale=1.0)


def _paged_inputs(card, dtype, B, T, H, KV, hd, NP, page, nb, seed=0):
    """q, pools and a fragmented table: each row owns a random set of pool
    pages (later table entries -1) holding positions 0..length-1; pages of
    other rows and free pages hold positions the row must not see."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=card).manual_seed(seed)
    q, k, v = _qkv(g, (B, T, H, hd), (NP, page, KV, hd), dtype, card)
    table = np.full((B, nb), -1, np.int32)
    pos_pool = rng.integers(0, nb * page, (NP, page)).astype(np.int32)
    qpos = np.zeros((B, T), np.int32)
    perm, used = rng.permutation(NP), 0
    for b in range(B):
        n_alloc = int(rng.integers(1, min(nb, (NP - used) // (B - b)) + 1))
        pages = perm[used:used + n_alloc]
        used += n_alloc
        table[b, :n_alloc] = pages
        length = int(rng.integers(1, n_alloc * page + 1))
        for i, p in enumerate(pages):
            fill = int(np.clip(length - i * page, 0, page))
            pos_pool[p] = -1
            pos_pool[p, :fill] = i * page + np.arange(fill)
        qpos[b] = length + np.arange(T)
    as_t = lambda a: torch.as_tensor(a, device=card).contiguous()
    return q, k, v, as_t(pos_pool), as_t(table), as_t(qpos)


def _paged_check(inp, dtype):
    """One kernel call (one launch count, combine included) against the
    plain version, output and stats."""
    hd = inp[0].shape[-1]
    before = ops.launches["paged_decode_attention"]
    out, m, l = ops.paged_decode_attention(*inp, scale=hd ** -0.5,
                                           return_stats=True)
    torch.cuda.synchronize()
    assert ops.launches["paged_decode_attention"] == before + 1
    po, pm, pl = ops.paged_decode_attention_plain(*inp, scale=hd ** -0.5,
                                                  return_stats=True)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)
    return out, m, l


# splits on a 132-SM H100 (ops.decode_split) in the comments: the bfloat16
# kernel's 64-key tiles span 8, 4 or 2 pages at page 8, 16 or 32
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KV,hd,NP,page,nb", [
    (8, 6, 12, 2, 128, 513, 16, 64),    # target verify, phase 1 (16)
    (8, 5, 12, 12, 128, 513, 16, 64),   # drafter draft, phase 1 (4)
    (8, 6, 12, 12, 128, 513, 16, 64),   # drafter extend, phase 1 (4)
    (2, 6, 4, 2, 64, 12, 16, 4),        # the JAX kernel sweep's shapes (1)
    (1, 1, 4, 4, 32, 8, 32, 3),         # (2)
    (3, 4, 2, 1, 128, 16, 8, 6),        # (1)
    (8, 6, 12, 2, 128, 1025, 8, 128),   # page 8 (16)
    (8, 6, 12, 2, 128, 257, 32, 32),    # page 32 (16)
    (8, 6, 12, 2, 128, 600, 16, 37),    # nb * page 592, not a multiple of 64
    (4, 200, 12, 2, 128, 160, 16, 40),  # row tiles fill the card (1)
])
def test_paged_kernel_matches_plain(card, dtype, B, T, H, KV, hd, NP, page,
                                    nb):
    _paged_check(_paged_inputs(card, dtype, B, T, H, KV, hd, NP, page, nb),
                 dtype)


def test_paged_holes_inside_live_tiles_are_never_read(card):
    """-1 and out-of-pool page ids inside a row's live range read as empty
    pages (the plain version's view), never as another row's page; and a
    batch whose tables are all -1 gives zeros with l 0, m -1e30."""
    B, T, H, KV, hd, NP, page, nb = 8, 6, 12, 2, 128, 513, 16, 64
    q, k, v, pos, table, qpos = _paged_inputs(card, torch.bfloat16, B, T, H,
                                              KV, hd, NP, page, nb, seed=3)
    holes = table.clone()
    for b in range(B):
        n = int((table[b] >= 0).sum())
        holes[b, 0] = -1
        if n > 2:
            holes[b, n // 2] = NP + 7          # past the pool
            holes[b, n - 1] = 2 ** 30
    _paged_check((q, k, v, pos, holes, qpos), torch.bfloat16)
    empty = torch.full_like(table, -1)
    out, m, l = _paged_check((q, k, v, pos, empty, qpos), torch.bfloat16)
    assert out.abs().max().item() == 0.0
    assert (l == 0).all() and (m == -1e30).all()


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_f32_decode_and_paged_each_opt_in(card, hd):
    """The float32 decode and paged kernels, two libraries holding the same
    FMA-body instantiation, load side by side in one process and each
    matches its plain version at every head dim. These shapes stay under
    the 48 KB opt-in threshold, so this does not pin the opt-in flag's
    internal linkage: test_torch_structure.py does."""
    B, T, H, KV, S = 2, 6, 4, 2, 256
    g = torch.Generator(device=card).manual_seed(hd)
    q, k, v = _qkv(g, (B, T, H, hd), (B, S, KV, hd), torch.float32, card)
    kpos = torch.arange(S, dtype=torch.int32, device=card)[None].repeat(B, 1)
    kpos = torch.where(kpos < 200, kpos, -1).to(torch.int32).contiguous()
    qpos = (200 + torch.arange(T, dtype=torch.int32, device=card))[
        None].repeat(B, 1)
    out = ops.decode_attention(q, k, v, kpos, qpos, scale=hd ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out, ops.decode_attention_plain(q, k, v, kpos, qpos,
                                        scale=hd ** -0.5), atol=1e-4, rtol=0)
    _paged_check(_paged_inputs(card, torch.float32, B, T, H, KV, hd, 40, 16,
                               16, seed=hd), torch.float32)


def test_paged_cuda_tensor_never_takes_the_plain_path(card, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ops, "paged_decode_attention_plain", refuse)
    monkeypatch.setattr(ops, "decode_attention_plain", refuse)
    inp = _paged_inputs(card, torch.bfloat16, 2, 6, 4, 2, 64, 12, 16, 4)
    ops.paged_decode_attention(*inp, scale=0.125)
    torch.cuda.synchronize()
    q, k, v, pos, table, qpos = inp
    with pytest.raises(ValueError, match="block_table"):
        ops.paged_decode_attention(q, k, v, pos, table.long(), qpos,
                                   scale=0.125)


def test_paged_scheduler_matches_contiguous_engine(card):
    """Reduced width: a paged Scheduler.serve under pool pressure gives the
    contiguous Engine.run's tokens per request, through the paged kernel."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW = 3, 20, 12
    eng = build_engine(reduced=True, mode="parallel", K=3, max_new=NEW,
                       max_len=64, batch=B, seed=0, device=card)
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    want = eng.run(prompts)["tokens"][:, P:P + NEW]
    peng = Engine(eng.tcfg, eng.dcfg, eng.tparams, eng.dparams,
                  dataclasses.replace(eng.ecfg, kv_layout="paged",
                                      page_size=8, pool_pages=9), B,
                  device=card)
    ops.reset_launches()
    rep = Scheduler(peng).serve([Request(p, max_new_tokens=NEW)
                                 for p in prompts])
    assert rep["preemptions"] > 0 and peng.allocator.n_used == 0
    assert ops.launches["paged_decode_attention"] == (
        (eng.tcfg.n_layers + 2 * eng.dcfg.n_layers) * rep["iterations"])
    for r, w in zip(rep["results"], want):
        np.testing.assert_array_equal(r["tokens"], w)


def test_engine_lossless_through_kernels(card):
    from repro_torch.launch.serve import build_engine, random_prompts
    toks = {}
    for mode in ("parallel", "ar", "none"):
        eng = build_engine(reduced=True, mode=mode, K=3, max_new=12,
                           max_len=64, batch=2, seed=0, device=card)
        prompts = random_prompts(eng.tcfg.vocab_size, 2, 16, seed=0)
        ops.reset_launches()
        toks[mode] = eng.run(prompts)["tokens"]
        assert ops.launches["flash_attention"] == eng.tcfg.n_layers
        assert ops.launches["decode_attention"] > 0
    np.testing.assert_array_equal(toks["parallel"], toks["none"])
    np.testing.assert_array_equal(toks["ar"], toks["none"])


@pytest.mark.parametrize("shape", [(5,), (3, 70001), (2, 8, 151936)],
                         ids=str)
def test_prng_on_card_equals_cpu(card, shape):
    """Threefry words, uniforms and Bernoulli masks from keys on the card
    equal the CPU's bit for bit (both hold 32-bit words in int64)."""
    from repro_torch import prng
    keys = prng.split(prng.fold_in(prng.PRNGKey(2 ** 40 + 7), 517), 3)
    for k in (keys, keys[1]):
        for fn in (lambda k: prng.bits(k, shape),
                   lambda k: prng.uniform(k, shape).view(torch.int32),
                   lambda k: prng.bernoulli(k, 0.9, shape),
                   lambda k: prng.split(k, 5)):
            assert torch.equal(fn(k.to(card)).cpu(), fn(k))


def _first_token_chi2(device, sampled_drafts, N=2 ** 14):
    """tests/test_torch_sampling.py's losslessness check: (statistic,
    threshold, draws outside the support) of the first committed token
    over N seeded rows against the warped target."""
    from scipy.stats import chi2
    from repro_torch import prng
    from repro_torch.core import spec_decode as SD
    V, Kc = 8, 3
    g = np.random.default_rng(0)
    logits = torch.from_numpy((1.5 * g.standard_normal((1, Kc + 1, V)))
                              .astype(np.float32)).to(device)
    p = SD.warp_probs(logits, torch.tensor([0.8], device=device),
                      torch.tensor([6], device=device),
                      torch.tensor([1.0], device=device))[0]
    q = torch.softmax(torch.from_numpy(g.standard_normal((Kc, V)).astype(
        np.float32)).to(device), -1)
    keys = prng.split(prng.PRNGKey(0, device=device), N)
    kd, kv = prng.split(keys, 2).unbind(1)
    if sampled_drafts:
        drafts = prng.categorical(prng.split(kd, Kc), torch.log(q)[None])
        dprobs = q.expand(N, Kc, V)
    else:
        drafts = q.argmax(-1).expand(N, Kc)
        dprobs = torch.nn.functional.one_hot(drafts, V).float()
    _, committed = SD.rejection_verify_rows(
        kv, drafts.to(torch.int32), dprobs, p.expand(N, Kc + 1, V))
    obs = torch.bincount(committed[:, 0].long(), minlength=V).cpu().numpy()
    exp = p[0].cpu().numpy().astype(np.float64) * N
    live = exp > 0
    stat = float((((obs - exp) ** 2)[live] / exp[live]).sum())
    return stat, chi2.ppf(0.999, live.sum() - 1), int(obs[~live].sum())


@pytest.mark.parametrize("sampled_drafts", [False, True],
                         ids=["one-hot drafts", "sampled drafts"])
def test_rejection_verify_lossless_on_card(card, sampled_drafts):
    stat, threshold, outside = _first_token_chi2(card, sampled_drafts)
    assert outside == 0
    assert stat < threshold, (stat, threshold)


def test_sampled_paged_serve_matches_contiguous_engine(card):
    """Reduced width, sampled: each request served by a paged scheduler
    under pool pressure (preempting sampled requests) emits what the
    contiguous engine's run emits for its row, except after a decision
    whose margin is below 1e-4; the kernels' launch counts are the greedy
    path's."""
    import dataclasses
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.margins import MarginLog
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.scheduler import Request, Scheduler
    B, P, NEW = 3, 20, 12
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95, seed=4)
    eng = build_engine(reduced=True, mode="parallel", K=3, max_new=NEW,
                       max_len=64, batch=1, seed=0, device=card, sampling=sp)
    prompts = random_prompts(eng.tcfg.vocab_size, B, P, seed=0)
    with MarginLog() as log:
        want = [eng.run(p[None])["tokens"][0, P:P + NEW] for p in prompts]
        peng = Engine(eng.tcfg, eng.dcfg, eng.tparams, eng.dparams,
                      dataclasses.replace(eng.ecfg, kv_layout="paged",
                                          page_size=8, pool_pages=9), B,
                      device=card)
        ops.reset_launches()
        rep = Scheduler(peng).serve([Request(p, max_new_tokens=NEW)
                                     for p in prompts])
    assert rep["preemptions"] > 0 and peng.allocator.n_used == 0
    assert ops.launches["paged_decode_attention"] == (
        (eng.tcfg.n_layers + 2 * eng.dcfg.n_layers) * rep["iterations"])
    for r, w in zip(rep["results"], want):
        diff = np.flatnonzero(r["tokens"] != w)
        if len(diff):
            assert log.min_margin(sp.seed, P, P + int(diff[0])) < 1e-4


def _mtp_inputs(card, dtype, B, H, KV, hd, n, K, r, mult=64):
    """q, k, v and per-row (B, M) COD metadata, padded with -1 rows."""
    from repro_torch.core import cod
    layouts = []
    for b in range(B):
        pos, dep = cod.sample_cod(np.random.default_rng(b), n, K, r)
        M = int(np.ceil(len(pos) / mult) * mult)
        layouts.append(cod.pad_to(pos, dep, M))
    g = torch.Generator(device=card).manual_seed(2)
    q, k, v = _qkv(g, (B, M, H, hd), (B, M, KV, hd), dtype, card)
    pos = torch.as_tensor(np.stack([p for p, _ in layouts]), device=card)
    dep = torch.as_tensor(np.stack([d for _, d in layouts]), device=card)
    return q, k, v, pos.contiguous(), dep.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,K,r,B,H,KV,hd", [
    (48, 4, 0.7, 2, 4, 2, 64), (32, 8, 0.8, 1, 2, 2, 32),
    (24, 2, 0.5, 2, 4, 2, 64),          # the JAX kernel sweep's shapes
    (16, 3, 0.6, 1, 2, 2, 32),          # mostly pad rows
    (512, 8, 0.8, 1, 12, 12, 128),      # the drafter's heads, M 2180
])
def test_mtp_kernel_matches_plain(card, dtype, n, K, r, B, H, KV, hd):
    q, k, v, pos, dep = _mtp_inputs(card, dtype, B, H, KV, hd, n, K, r)
    before = ops.launches["mtp_attention"]
    out, m, l = ops.mtp_attention(q, k, v, pos, dep, scale=hd ** -0.5,
                                  return_stats=True)
    torch.cuda.synchronize()
    assert ops.launches["mtp_attention"] == before + 1
    po, pm, pl = ops.mtp_attention_plain(q, k, v, pos, dep, scale=hd ** -0.5,
                                         return_stats=True)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(m, pm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, pl, atol=1e-4, rtol=1e-4)
    pad = dep < 0
    if pad.any():
        assert out[pad].abs().max().item() == 0.0


def _mtp_layout(kind, seed=0):
    """(pos, depth) of one row, padded with -1 to a multiple of 64:
    "shuffled" a COD layout in random order (pad rows among the real ones),
    "segment" the largest Algorithm-1 segment of n 1024 in 4 (its depth-0
    context first, then an interleaved block), "no chains" a layout of
    depth-0 keys only (K 1: every chain pass is empty)."""
    from repro_torch.core import cod, partition
    rng = np.random.default_rng(seed)
    if kind == "segment":
        p, d = cod.sample_cod(rng, 1024, 8, 0.8)
        seg = max(partition.build_segments(p, d, 1024, 4),
                  key=lambda sg: len(sg.kv_pos))
        p, d = seg.kv_pos, seg.kv_depth
    else:
        p, d = cod.sample_cod(rng, 700, 1 if kind == "no chains" else 8, 0.8)
    p, d = cod.pad_to(p, d, int(np.ceil(len(p) / 64) * 64))
    if kind == "shuffled":
        perm = rng.permutation(len(p))
        p, d = p[perm], d[perm]
    return p, d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,H,KV,hd", [
    ("shuffled", 4, 2, 64), ("shuffled", 12, 12, 128),
    ("segment", 12, 12, 128), ("segment", 4, 2, 32),
    ("no chains", 4, 2, 64),
])
def test_mtp_kernel_layouts_match_plain(card, dtype, kind, H, KV, hd):
    """The depth-split walk gives the predicate's function for any layout:
    rows in random order, a segment's context before its interleaved block,
    and rows that have no chain keys."""
    from repro_torch.core import cod
    layouts = [_mtp_layout(kind, seed=b) for b in range(2)]
    M = max(len(p) for p, _ in layouts)
    layouts = [cod.pad_to(p, d, M) for p, d in layouts]
    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = _qkv(g, (2, M, H, hd), (2, M, KV, hd), dtype, card)
    pos = torch.as_tensor(np.stack([p for p, _ in layouts]), device=card)
    dep = torch.as_tensor(np.stack([d for _, d in layouts]), device=card)
    before = ops.launches["mtp_attention"]
    out, m, l = ops.mtp_attention(q, k, v, pos, dep, scale=hd ** -0.5,
                                  return_stats=True)
    torch.cuda.synchronize()
    assert ops.launches["mtp_attention"] == before + 1
    po, pm, pl = ops.mtp_attention_plain(q, k, v, pos, dep, scale=hd ** -0.5,
                                         return_stats=True)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), po.float(), atol=atol, rtol=rtol)
    for got, want in ((m, pm), (l, pl)):    # STATS_TOL: 1e-4 of 1 + |want|
        assert ((got - want).abs() / (1 + want.abs())).max().item() <= 1e-4
    pad = dep < 0
    assert out[pad].abs().max().item() == 0.0


def test_mtp_flash_grads_match_plain_autograd(card, monkeypatch):
    from repro_torch.core.flash_train import mtp_flash_attention
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v, pos, dep = _mtp_inputs(card, torch.float32, 2, 4, 2, 64, 200, 4,
                                    0.8)
    cot = torch.randn(q.shape, generator=torch.Generator(
        device=card).manual_seed(3), device=card)
    grads = []
    for fn in (mtp_flash_attention, ops.mtp_attention_plain):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, pos, dep, scale=64 ** -0.5)
        grads.append(torch.autograd.grad(out, leaves, cot))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-4 * want.abs().max(),
                                   rtol=0)


def test_trainer_steps_through_kernels(card):
    """A whole and a segmented reduced training step on the card: every
    drafter layer's attention launches the MTP kernel once per forward, the
    target's taps 2 flash launches."""
    from repro_torch.configs import DrafterConfig, get_config
    from repro_torch.data import MTPPipeline, markov_corpus
    from repro_torch.models.registry import get_model
    from repro_torch.training import TrainConfig, Trainer
    tcfg = get_config("qwen2-1.5b").reduced()
    dcfg = DrafterConfig(n_layers=2).resolve(tcfg)
    tparams = get_model(tcfg).init(
        torch.Generator(device=card).manual_seed(0), device=card)
    corpus = markov_corpus(0, 2, 64, tcfg.vocab_size)
    for segments in (1, 2):
        tr = Trainer(tcfg, dcfg, tparams, TrainConfig(), device=card)
        batch = next(iter(MTPPipeline(corpus, k_train=8, cod_rate=0.8,
                                      batch=2, segments=segments)))
        ops.reset_launches()
        m = tr.train_batch(batch)
        torch.cuda.synchronize()
        assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
        assert ops.launches == {"decode_attention": 0,
                                "paged_decode_attention": 0,
                                "flash_attention": tcfg.n_layers,
                                "mtp_attention": dcfg.n_layers * segments}
