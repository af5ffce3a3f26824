"""The port's paged KV layout against the JAX package on the CPU.

- ``ops.paged_decode_attention`` (its plain version here) against the JAX
  package's paged Pallas kernel in interpret mode and its gather-then-dense
  oracle, on ``tests/test_kernels.py``'s sweep shapes: rows of different
  lengths, unallocated (-1) table entries and pool pages holding other
  rows' positions. Tolerances 3e-5 in float32, 2e-2 in bfloat16 (the JAX
  sweep's: both sides accumulate in float32, in another order).
- The cache operations (admission, growth, gather/scatter, blank, commit)
  and one paged engine step on states converted from the JAX engine's,
  leaf by leaf: positions, tokens and tables exact, K/V, taps and logprobs
  within 3e-5 (float32, sums in another order).
- ``BlockAllocator``: refcounts, LIFO reuse, the raises on a double free
  and a foreign id, and a seeded churn that never leaks or aliases a page.

The reduced qwen2-1.5b (2 layers, d 256) in float32 with a 1-layer
drafter, weights converted from the JAX package's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.core import drafter as JD
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import cache_ops as jcache_ops
from repro_torch import convert
from repro_torch.configs import DrafterConfig, get_config
from repro_torch.kernels import ops, ref
from repro_torch.serving import cache_ops
from repro_torch.serving.engine import Engine, EngineConfig, speculative_step

DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TOL = 3e-5


def _sweep_inputs(B, T, H, KV, hd, NP, page, nb, seed):
    """The JAX sweep's layout: each row owns a distinct prefix of pages
    (later entries -1) holding positions 0..length-1, queries at
    length-1.., other pages holding other rows' positions."""
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((B, T, H, hd))).astype(np.float32)
    kp = (0.5 * rng.standard_normal((NP, page, KV, hd))).astype(np.float32)
    vp = (0.5 * rng.standard_normal((NP, page, KV, hd))).astype(np.float32)
    table = np.full((B, nb), -1, np.int32)
    pos_pool = np.full((NP, page), -1, np.int32)
    qpos = np.zeros((B, T), np.int32)
    perm, used = rng.permutation(NP), 0
    for b in range(B):
        n_alloc = int(rng.integers(1, nb + 1))
        pages = perm[used:used + n_alloc]
        used += n_alloc
        table[b, :n_alloc] = pages
        length = int(rng.integers(1, n_alloc * page + 1))
        for i, p in enumerate(pages):
            fill = int(np.clip(length - i * page, 0, page))
            pos_pool[p, :fill] = i * page + np.arange(fill)
        qpos[b] = length - 1 + np.arange(T)
    return q, kp, vp, pos_pool, table, qpos


@pytest.mark.parametrize("B,T,H,KV,hd,NP,page,nb", [
    (2, 6, 4, 2, 64, 12, 16, 4),
    (1, 1, 4, 4, 32, 8, 32, 3),
    (3, 4, 2, 1, 128, 16, 8, 6),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_jax(B, T, H, KV, hd, NP, page, nb, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, kp, vp, pos, table, qpos = _sweep_inputs(B, T, H, KV, hd, NP, page,
                                                nb, seed=B * 100 + nb)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(pos), jnp.asarray(table), jnp.asarray(qpos))
    targs = (torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt),
             torch.from_numpy(vp).to(tdt), torch.from_numpy(pos),
             torch.from_numpy(table), torch.from_numpy(qpos))
    out = ops.paged_decode_attention(*targs, scale=hd ** -0.5)
    assert out.dtype == tdt and out.shape == (B, T, H, hd)
    for want in (jops.paged_decode_attention(*jargs, scale=hd ** -0.5),
                 jref.paged_decode_reference(*jargs, scale=hd ** -0.5)):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    np.testing.assert_allclose(
        ref.paged_decode_reference(*targs, scale=hd ** -0.5).float().numpy(),
        np.asarray(jref.paged_decode_reference(*jargs, scale=hd ** -0.5),
                   np.float32), atol=tol, rtol=tol)


def test_identity_table_equals_contiguous_decode():
    """Pages laid out row after row (an identity table) give the contiguous
    decode's output and stats."""
    B, T, H, KV, hd, S, page = 2, 5, 4, 2, 64, 128, 32
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy((0.5 * rng.standard_normal(s))
                                .astype(np.float32))
               for s in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    valid = S // 2
    kpos = torch.arange(S, dtype=torch.int32)[None].repeat(B, 1)
    kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32)
    qpos = (valid - 1 + torch.arange(T, dtype=torch.int32))[None].repeat(B, 1)
    want = ops.decode_attention(q, k, v, kpos, qpos, scale=hd ** -0.5,
                                return_stats=True)
    nb = S // page
    table = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    got = ops.paged_decode_attention(
        q, k.reshape(B * nb, page, KV, hd), v.reshape(B * nb, page, KV, hd),
        kpos.reshape(B * nb, page), table, qpos, scale=hd ** -0.5,
        return_stats=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL)


def test_all_masked_row_is_zero_with_empty_stats():
    """A row whose table is all -1, and one whose pages hold only later
    positions, see no key: out 0, l 0, m -1e30."""
    q, kp, vp, pos, table, qpos = _sweep_inputs(2, 3, 4, 2, 32, 6, 8, 2,
                                                seed=3)
    table[0] = -1
    qpos[1] = -1 + np.arange(3) * 0         # before every stored position
    out, m, l = ops.paged_decode_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, pos, table, qpos)),
        scale=0.2, return_stats=True)
    for b in (0, 1):
        assert out[b].abs().max().item() == 0.0
        assert (l[b] == 0).all() and (m[b] == -1e30).all()


# ---------------------------------------------------------------------------
# cache operations and the paged step against the JAX engine's
# ---------------------------------------------------------------------------

B, K, MAX_LEN, PAGE, POOL = 3, 3, 64, 8, 14
PROMPTS = {0: 13, 2: 6}                     # slot -> prompt length


@pytest.fixture(scope="module")
def engines():
    jcfg = jget_config("qwen2-1.5b").reduced()
    tcfg = get_config("qwen2-1.5b").reduced()
    jdcfg = JDrafterConfig(n_layers=1).resolve(jcfg)
    dcfg = DrafterConfig(n_layers=1).resolve(tcfg)
    jp = jget_model(jcfg).init(jax.random.PRNGKey(11))
    jdp = JD.init_params(jdcfg, jcfg, jax.random.PRNGKey(12))
    tp = convert.target_params(jax.tree.map(np.asarray, jp), tcfg)
    dp = convert.drafter_params(jax.tree.map(np.asarray, jdp))
    ek = dict(K=K, max_new_tokens=16, drafter_mode="parallel",
              max_len=MAX_LEN, kv_layout="paged", page_size=PAGE,
              pool_pages=POOL)
    je = JEngine(jcfg, jdcfg, jp, jdp, JEngineConfig(**ek), B)
    te = Engine(tcfg, dcfg, tp, dp, EngineConfig(**ek), B, device="cpu")
    return je, te, tcfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _assert_state(got: dict, want_np: dict, tcfg, what: str):
    """The port's state against a converted JAX state, leaf by leaf; page
    pools compared without the port's sink page (a core state, without its
    block table, converts without one)."""
    want = convert.decode_state(want_np, tcfg)
    assert set(got) == set(want), what
    for name in got:
        if name in ("tcache", "dcache"):
            for i, (g, w) in enumerate(zip(got[name]["blocks"],
                                           want[name]["blocks"])):
                # pools: the JAX package's NP pages; the sink is garbage
                n = w["positions"].shape[0] - ("block_table" in want)
                assert g["positions"].shape[0] in (n, n + 1)
                np.testing.assert_array_equal(
                    g["positions"][:n].numpy(), w["positions"][:n].numpy(),
                    f"{what} {name} layer {i} positions")
                for kv in ("k", "v"):
                    np.testing.assert_allclose(
                        g[kv][:n].numpy(), w[kv][:n].numpy(), atol=TOL,
                        rtol=TOL, err_msg=f"{what} {name} layer {i} {kv}")
        elif name == "sampling":
            assert set(got[name]) == set(want[name]), what
            for k, v in got[name].items():
                np.testing.assert_array_equal(v.numpy(), want[name][k].numpy(),
                                              f"{what} sampling {k}")
        elif got[name].dtype.is_floating_point:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(got[name].numpy(),
                                          want[name].numpy(),
                                          f"{what} {name}")


@pytest.fixture(scope="module")
def admitted(engines):
    """Both engines' paged states after two admissions (one bucketed from 13
    to 16 tokens, one from 6 to 8) and a page of incremental growth."""
    je, te, tcfg = engines
    rng = np.random.default_rng(4)
    js, ts = je.blank_state(), te.blank_state()
    firsts = []
    for slot, P in PROMPTS.items():
        prompt = rng.integers(1, tcfg.vocab_size - 1, P).astype(np.int32)
        js, jfirst, jlast = je.prefill_into_slot(js, prompt, slot, max_new=12)
        ts, tfirst, tlast = te.prefill_into_slot(ts, prompt, slot, max_new=12)
        firsts.append(((jfirst, jlast), (tfirst, tlast)))
    js, jok = je.ensure_capacity(js, 2, 6 + 2 * 8)
    ts, tok = te.ensure_capacity(ts, 2, 6 + 2 * 8)
    assert jok and tok
    return js, ts, firsts


def test_admission_and_growth_match_jax(engines, admitted):
    je, te, tcfg = engines
    js, ts, firsts = admitted
    for want, got in firsts:
        assert got == want
    assert te._slot_pages == je._slot_pages
    assert te.allocator.n_used == je.allocator.n_used
    _assert_state(ts, _np(js), tcfg, "after admission")


def test_cache_ops_match_jax(engines, admitted):
    """gather_state, blank_pages, commit through the table and
    scatter_state on the converted state equal the JAX ops leaf by leaf."""
    je, te, tcfg = engines
    js, ts, _ = admitted
    jtable, ttable = js["block_table"], ts["block_table"]
    jcore = {k: v for k, v in js.items() if k != "block_table"}
    tcore = {k: v for k, v in _clone(ts).items() if k != "block_table"}

    jview = jcache_ops.gather_state(jcore, jtable, je.pspec)
    tview = cache_ops.gather_state(tcore, ttable, te.pspec)
    _assert_state(tview, _np(jview), tcfg, "gather_state")

    cp = np.array([9, 0, 4], np.int32)
    jv2 = dict(jview)
    for name in ("tcache", "dcache"):
        jv2[name] = jcache_ops.commit(jview[name], None, jnp.asarray(cp),
                                      jnp.zeros(3, jnp.int32))
    jback = jcache_ops.scatter_state(jcore, jv2, jtable, je.pspec)
    tcommitted = _clone(tcore)
    for name in ("tcache", "dcache"):
        cache_ops.commit(tcommitted[name], torch.from_numpy(cp), ttable)
    _assert_state(tcommitted, _np(jback), tcfg, "commit through the table")
    tback = cache_ops.scatter_state(
        _clone(tcore), cache_ops.gather_state(tcommitted, ttable, te.pspec),
        ttable, te.pspec)
    _assert_state(tback, _np(jback), tcfg, "scatter_state")

    row = np.full((MAX_LEN // PAGE,), -1, np.int32)
    row[:2] = je._slot_pages[0][:2]
    jb = jcache_ops.blank_pages(jcore, jnp.asarray(row), je.pspec)
    tb = cache_ops.blank_pages(_clone(tcore), torch.from_numpy(row), te.pspec)
    _assert_state(tb, _np(jb), tcfg, "blank_pages")


def test_paged_step_matches_jax_and_the_gathered_step(engines, admitted):
    """One scheduler-style step (slot 1 free) on the pools equals the JAX
    engine's gather -> step -> scatter, and the port's own gather ->
    contiguous step -> scatter."""
    je, te, tcfg = engines
    js, ts, _ = admitted
    active = np.array([True, False, True])
    max_new = np.array([12, 16, 12], np.int32)
    k_row = np.full(3, K, np.int32)
    jout = je.step(js, jnp.asarray(active), jnp.asarray(max_new),
                   jnp.asarray(k_row))
    tout = te.step(_clone(ts), active, max_new, k_row)
    _assert_state(tout, _np(jout), tcfg, "paged step")

    table = ts["block_table"]
    core = {k: v for k, v in _clone(ts).items() if k != "block_table"}
    view = cache_ops.gather_state(core, table, te.pspec)
    with torch.no_grad():
        view = speculative_step(
            te.model, te.tcfg, te.dcfg, te.ecfg, te.tparams, te.dparams,
            view, active_mask=torch.from_numpy(active),
            max_new=torch.from_numpy(max_new), k_row=torch.from_numpy(k_row))
    ref_state = cache_ops.scatter_state(core, view, table, te.pspec)
    ref_state["block_table"] = table
    _assert_state(tout, _np(jout), tcfg, "gathered step (JAX)")
    for name in ("tokens", "last", "new_count", "logprobs"):
        torch.testing.assert_close(tout[name], ref_state[name], atol=TOL,
                                   rtol=TOL)
    for name in ("tcache", "dcache"):
        for g, w in zip(tout[name]["blocks"], ref_state[name]["blocks"]):
            torch.testing.assert_close(g["positions"][:-1],
                                       w["positions"][:-1])
            torch.testing.assert_close(g["k"][:-1], w["k"][:-1], atol=TOL,
                                       rtol=TOL)


def test_paged_forwards_match_the_contiguous_view(engines, admitted):
    """After a step the drafter's pages hold entries at and past the next
    draft's anchor (extend wrote the whole verified block): the paged
    draft and target verify must not see them, and give the logits of the
    same forwards on the gathered contiguous view."""
    from repro_torch.core import drafter as D
    _, te, tcfg = engines
    _, ts, _ = admitted
    B_ = ts["last"].shape[0]
    state = te.step(_clone(ts), np.array([True, False, True]),
                    np.array([12, 16, 12], np.int32), np.full(3, K, np.int32))
    table = state["block_table"]
    core = {k: v for k, v in state.items() if k != "block_table"}
    view = cache_ops.gather_state(core, table, te.pspec)
    c = state["last"]
    tok = state["tokens"].gather(1, c[:, None].long())[:, 0]
    verify = torch.from_numpy(np.random.default_rng(2).integers(
        1, tcfg.vocab_size - 1, (B_, K + 1)).astype(np.int32))
    positions = c[:, None] + torch.arange(K + 1, dtype=torch.int32)[None]
    out = {}
    with torch.no_grad():
        for name, st, bt in (("paged", _clone(core), table),
                             ("view", _clone(view), None)):
            _, dlogits, _ = D.draft_parallel(
                te.dcfg, tcfg, te.dparams, st["dcache"], tok,
                st["taps_last"], c - 1, K, block_table=bt)
            tlogits = te.model.forward(te.tparams, verify, mode="decode",
                                       positions=positions,
                                       cache=st["tcache"], collect_taps=False,
                                       block_table=bt).logits
            out[name] = (dlogits, tlogits)
    for got, want in zip(out["paged"], out["view"]):
        torch.testing.assert_close(got[[0, 2]], want[[0, 2]], atol=TOL,
                                   rtol=TOL)


def test_recycled_page_reads_empty(engines):
    """A page freed by one slot and taken by another's growth holds no
    attendable entry until the new owner writes it."""
    _, te, tcfg = engines
    eng = Engine(te.tcfg, te.dcfg, te.tparams, te.dparams,
                 dataclasses.replace(te.ecfg, pool_pages=4), 2, device="cpu")
    state = eng.blank_state()
    state, _, _ = eng.prefill_into_slot(state, np.arange(1, 14), 0,
                                        max_new=4)
    freed = list(eng._slot_pages[0])
    state = eng.free_slot(state, 0)
    state, _, _ = eng.prefill_into_slot(state, np.arange(1, 4), 1,
                                        max_new=20)
    state, ok = eng.ensure_capacity(state, 1, 30)
    assert ok and eng.slot_capacity(1) == 4 * PAGE
    grown = eng._slot_pages[1][1:]
    assert len(set(grown) & set(freed)) >= 2
    for c in state["tcache"]["blocks"] + state["dcache"]["blocks"]:
        assert (c["positions"][grown] == -1).all()
    eng.free_slot(state, 1)
    assert eng.allocator.n_used == 0


# ---------------------------------------------------------------------------
# the block allocator
# ---------------------------------------------------------------------------

def test_block_allocator_refcounts_and_raises():
    a = cache_ops.BlockAllocator(4)
    with pytest.raises(ValueError):
        cache_ops.BlockAllocator(0)
    p = a.alloc(3)
    assert p == [0, 1, 2] and a.n_free == 1 and a.peak_used == 3
    assert a.alloc(2) is None and a.n_free == 1       # all or nothing
    a.incref([p[0]])
    a.free([p[0]])
    assert a.n_used == 3                              # one owner left
    a.free(p)
    assert a.n_used == 0 and a.n_free == 4
    assert a.alloc(1) == [p[-1]]                      # LIFO reuse
    for bad in ([p[0]], [7]):                         # double free, foreign
        with pytest.raises(ValueError):
            a.free(bad)
    with pytest.raises(ValueError):
        a.incref([3])
    with pytest.raises(ValueError):
        a.alloc(-1)
    a.reset_stats()
    assert a.peak_used == 1


def test_block_allocator_churn_never_leaks_or_aliases():
    rng = np.random.default_rng(0)
    a = cache_ops.BlockAllocator(32)
    owners = []                                 # page lists held
    for _ in range(2000):
        if owners and rng.random() < 0.45:
            a.free(owners.pop(int(rng.integers(len(owners)))))
        else:
            got = a.alloc(int(rng.integers(0, 6)))
            if got is not None:
                owners.append(got)
        held = [p for o in owners for p in o]
        assert len(held) == len(set(held)) == a.n_used     # no aliasing
        assert a.n_used + a.n_free == 32                   # no leak
        assert a.peak_used >= a.n_used
    for o in owners:
        a.free(o)
    assert a.n_used == 0 and sorted(a._free) == list(range(32))
