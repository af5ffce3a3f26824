"""Multi-process helpers of the port's sharding tests (a helper, not a test
file): ``spawn`` runs a function on ``world`` spawned ranks joined by a
``gloo`` process group (``nccl`` for the card tests, one card a rank) over
a file in the test's temporary directory, one torch thread each, and kills them at a deadline of its own, so a
mismatched collective fails the test instead of hanging the run. The
children import this module and the port, never ``jax`` nor ``repro``:
the JAX references are computed by the parent and passed in."""
from __future__ import annotations

import contextlib
import hashlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, path, backend, args):
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{path}", rank=rank,
                            world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_path, *args, timeout: float = 120.0,
          backend: str = "gloo") -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks (``nccl``: rank r
    on card r); a rank's exception fails the caller, and so does the
    deadline (the ranks are killed)."""
    path = os.path.join(str(tmp_path), f"pg_{time.monotonic_ns()}")
    ctx = mp.start_processes(_entry, args=(fn, world, path, backend, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def digest(tree) -> str:
    """A hash of every tensor leaf of ``tree`` (dicts and lists, in key
    order): equal digests mean bitwise equal trees."""
    h = hashlib.sha1()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        elif isinstance(t, torch.Tensor):
            h.update(path.encode())
            h.update(str((t.dtype, tuple(t.shape))).encode())
            h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).numpy()
                     .tobytes() if t.numel() else b"")
        else:
            h.update(f"{path}={t!r}".encode())
    walk(tree, "")
    return h.hexdigest()


def kv_bytes(state) -> int:
    """Bytes of the K/V leaves (named k / v, rank >= 4) of a state."""
    total = 0

    def walk(t, name):
        nonlocal total
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, k)
        elif isinstance(t, list):
            for v in t:
                walk(v, name)
        elif (isinstance(t, torch.Tensor) and name in ("k", "v")
              and t.dim() >= 4):
            total += t.numel() * t.element_size()
    walk(state, "")
    return total


# ---------------------------------------------------------------------------
# the sharded engine against the unsharded one
# ---------------------------------------------------------------------------

def _recording(eng, log):
    """Wrap ``eng.step`` to append the digest of its gathered state (a
    collective under a mesh: every rank records) to ``log``."""
    step = eng.step

    def wrapped(state, *a, **kw):
        out = step(state, *a, **kw)
        log.append(digest(eng.full_state(out)))
        return out
    eng.step = wrapped
    return eng


def serving_child(rank, world, setup, expected):
    """The checks of ``test_sharded_serving_is_bitwise_unsharded``:
    ``setup`` = (tcfg, dcfg, tparams, dparams, engine kwargs, run prompts,
    workload); ``expected`` = the JAX engine's run tokens and serve
    streams."""
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.scheduler import Request, Scheduler
    from repro_torch.serving.verify_graph import eager
    from repro_torch.sharding import utils as SH

    tcfg, dcfg, tp, dp, kw, prompts, work = setup
    jrun, jserve = expected
    P = prompts.shape[1]
    new = kw["max_new_tokens"]

    def engine(shard, mode="parallel", batch=len(prompts), **extra):
        cfg = dict(kw, drafter_mode=mode, shard_model=shard)
        cfg.update(extra)
        if mode == "none":
            cfg["K"] = 0
        use_d = mode != "none"
        return Engine(tcfg, dcfg if use_d else None, tp,
                      dp if use_d else None, EngineConfig(**cfg), batch,
                      device="cpu")

    # Engine.run's loop, both engines in lockstep, the gathered state after
    # the prefill and after every step bitwise the unsharded state
    for mode in ("parallel", "ar", "none"):
        e1 = engine(True, mode)
        e0 = engine(False, mode) if rank == 0 else None
        SH.reset_counters()
        s1 = e1.prefill(prompts)
        s0 = e0.prefill(prompts) if e0 else None
        steps = 0
        while True:
            f1 = e1.full_state(s1)
            if e0:
                assert digest(f1) == digest(s0), (mode, steps)
            if bool((s1["new_count"] >= new).all()) or steps > 64:
                break
            s1 = e1.step(s1, greedy_only=True)
            if e0:
                s0 = e0.step(s0, greedy_only=True)
            steps += 1
        if rank == 0:
            np.testing.assert_array_equal(
                s1["tokens"][:, :P + new].numpy(), jrun[:, :P + new],
                err_msg=mode)
        # a meshed engine runs every verify eagerly, never a graph
        assert e1.verify is eager, mode
        # (iii): no use() gathered more than one layer (or the top-level
        # leaves); each rank holds 1/world of the K/V bytes
        top = max(_unit_bytes(tp), _unit_bytes(dp))
        assert SH.counters()["use"]["max_bytes"] <= top, mode
        assert 0 < SH.counters()["use"]["calls"]
        if e0:
            assert kv_bytes(s1) * world == kv_bytes(s0), mode

    # Scheduler.serve over paged KV: a tight pool that preempts by
    # recompute, then the same with swap to host; streams equal the JAX
    # scheduler's, the gathered state after every step bitwise the
    # unsharded serve's
    for swap in ("none", "host"):
        extra = dict(batch=3, kv_layout="paged", pool_pages=7, swap=swap,
                     max_new_tokens=16)
        l1, l0 = [], []
        e1 = _recording(engine(True, **extra), l1)
        reqs = [Request(p, max_new_tokens=b, arrival_time=t, rid=i)
                for i, (p, b, t) in enumerate(work)]
        r1 = Scheduler(e1).serve(reqs)
        key = "preempt_recompute" if swap == "none" else "preempt_swap"
        assert r1[key] >= 1, (swap, r1[key])
        blank1 = e1.blank_state()
        if rank == 0:
            e0 = _recording(engine(False, **extra), l0)
            r0 = Scheduler(e0).serve(
                [Request(p, max_new_tokens=b, arrival_time=t, rid=i)
                 for i, (p, b, t) in enumerate(work)])
            assert l1 == l0, swap
            assert r1["events"] == r0["events"]
            for a, b, j in zip(r1["results"], r0["results"], jserve):
                np.testing.assert_array_equal(a["tokens"], b["tokens"])
                np.testing.assert_array_equal(a["tokens"], j, err_msg=swap)
            assert kv_bytes(blank1) * world == kv_bytes(e0.blank_state())
            if swap == "host":
                assert r1["host_pool"]["peak_bytes"] < \
                    r0["host_pool"]["peak_bytes"]


def _unit_bytes(params) -> int:
    """The most bytes one gather unit holds: one layer of a layer stack,
    or the top-level leaves together."""
    def size(t):
        if isinstance(t, dict):
            return sum(size(v) for v in t.values())
        if isinstance(t, list):
            return sum(size(v) for v in t)
        return t.numel() * t.element_size()
    units = [sum(size(v) for v in params.values()
                 if not isinstance(v, list))]
    for v in params.values():
        if isinstance(v, list):
            units += [size(layer) for layer in v]
    return max(units)


# ---------------------------------------------------------------------------
# the ops boundary and the one-rank mesh
# ---------------------------------------------------------------------------

def boundary_child(rank, world):
    from repro_torch.kernels import ops
    from repro_torch.serving import cache_ops
    from repro_torch.sharding import utils as SH

    one = SH.serving_mesh(1)        # every rank makes every group
    wide = SH.serving_mesh()
    # gathered K/V are contiguous, as the kernels take them: two KV heads
    # split one a rank, a size-1 dim beside the rank axis
    B, S, KV, hd = 2, 8, 2, 32
    k, v = torch.randn(2, B, S, KV, hd,
                       generator=torch.Generator().manual_seed(1)).unbind(0)
    with SH.mesh_scope(wide):
        spec = SH.kv_spec(k.shape, wide)
        ks, vs = SH.shard(k, spec, wide), SH.shard(v, spec, wide)
        for full, want in zip(SH.kv_full([ks, vs], KV, hd), (k, v)):
            assert full.is_contiguous() and torch.equal(full, want)
        # kv_full takes this rank's slice and nothing else
        for bad in (k, ks[..., :hd // 2]):
            try:
                SH.kv_full([bad], KV, hd)
            except ValueError as e:
                assert "is not the slice" in str(e)
            else:
                raise AssertionError(f"kv_full took {tuple(bad.shape)}")
        # one KV head over two ranks: head_dim is cut, and the wrappers
        # refuse such a slice against q's head_dim
        g = torch.Generator().manual_seed(2)
        q1 = torch.randn(B, 1, 2, hd, generator=g)
        k1 = torch.randn(B, S, 1, hd, generator=g)
        spec1 = SH.kv_spec(k1.shape, wide)
        assert spec1 == (None, None, None, "model")
        k1s = SH.shard(k1, spec1, wide)
        kpos = torch.arange(S, dtype=torch.int32).expand(B, S)
        qpos = torch.full((B, 1), S, dtype=torch.int32)
        try:
            ops.decode_attention(q1, k1s, k1s, kpos, qpos, scale=hd ** -0.5)
        except ValueError as e:
            assert "head_dim" in str(e)
        else:
            raise AssertionError("a head_dim slice reached decode attention")
        # shard_tree cuts a leaf where it lies and moves the slice alone
        tree = {"w": torch.arange(8.0).reshape(4, 2), "b": torch.ones(3)}
        placed = SH.shard_tree(tree, {"w": ("model", None), "b": (None,)},
                               wide, device="meta")
        assert isinstance(placed["w"], SH.Shard)
        assert placed["w"].local.device.type == "meta"
        assert tuple(placed["w"].local.shape) == (2, 2)
        assert placed["b"].device.type == "meta"
        # a page pool made from a K/V slice keeps its trailing axes
        pool = cache_ops.paged_pool(ks, cache_ops.PAGED_KV, 4, 3)
        assert pool.shape == (4, 4) + tuple(ks.shape[2:])
    if rank != 0:
        return
    mesh = one
    g = torch.Generator().manual_seed(0)
    B, T, H, KV, hd, NP, page = 2, 3, 4, 2, 32, 5, 8
    q = torch.randn(B, T, H, hd, generator=g)
    kpool = torch.randn(NP + 1, page, KV, hd, generator=g)
    vpool = torch.randn(NP + 1, page, KV, hd, generator=g)
    pos = torch.arange((NP + 1) * page, dtype=torch.int32).reshape(NP + 1,
                                                                  page)
    table = torch.tensor([[0, 2], [1, 3]], dtype=torch.int32)
    qpos = torch.full((B, T), 40, dtype=torch.int32)
    want = ops.paged_decode_attention(q, kpool, vpool, pos, table, qpos,
                                      scale=hd ** -0.5)
    with SH.mesh_scope(mesh):
        spec = SH.kv_spec(kpool.shape, mesh)
        ks = SH.shard(kpool, spec, mesh)
        vs = SH.shard(vpool, spec, mesh)
        SH.reset_counters()
        kf, vf = SH.kv_full([ks, vs], KV, hd)
        got = ops.paged_decode_attention(q, kf, vf, pos, table, qpos,
                                         scale=hd ** -0.5)
        assert torch.equal(got, want)
        # a one-rank mesh gathers all the same: K and V in one call
        assert SH.counters()["all_gather"]["calls"] == 1
    try:
        SH.serving_mesh(world + 1)
    except ValueError:
        pass
    else:
        raise AssertionError("a mesh larger than the world was built")


# ---------------------------------------------------------------------------
# the sharded train step and the launch tooling
# ---------------------------------------------------------------------------

def train_child(rank, world, setup, n_data, n_model, on_card=False):
    """The train step on a (data, model) debug mesh against the step on
    one process over the whole batch: grads (through the first moment)
    within atol 2e-5 rtol 2e-4, the second moment and the weights too
    (``on_card``: each rank's tensors on its card)."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_train_step, shard_train_inputs
    from repro_torch.sharding import utils as SH
    from repro_torch.tree import tree_map

    if on_card:
        dev = torch.device("cuda", rank)
        setup = tuple(tree_map(lambda t: t.to(dev), x)
                      if isinstance(x, (dict, torch.Tensor)) else x
                      for x in setup)
    tcfg, dcfg, tp, dp, tokens, pos, depth, labels, n_micro = setup
    mesh = make_debug_mesh(n_data, n_model)
    fn, _ = build_train_step(tcfg, dcfg, "train_4k", n_micro=n_micro)
    rng = torch.zeros(2, dtype=torch.int64, device=tokens.device)
    tps, dps, opt, toks, labs, ex = shard_train_inputs(mesh, tp, dp, tokens,
                                                       labels)
    with SH.mesh_scope(mesh):
        new_d, new_opt, met = fn(tps, dps, opt, toks, pos, depth, labs, rng,
                                 ex)
        full_d = SH.full_tree(new_d)
        m, v = SH.full_tree(new_opt.m), SH.full_tree(new_opt.v)
    if rank != 0:
        return
    fn1, _ = build_train_step(tcfg, dcfg, "train_4k",
                              n_micro=n_micro * n_data)
    from repro_torch.optim import adamw_init
    ref_d, ref_opt, ref_met = fn1(tp, dp, adamw_init(dp), tokens, pos, depth,
                                  labels, rng, {})
    from repro_torch.tree import leaves_with_paths
    torch.testing.assert_close(met["loss"], ref_met["loss"], atol=2e-5,
                               rtol=2e-4)
    b1 = 0.9
    for (path, a), (_, b) in zip(leaves_with_paths(m),
                                 leaves_with_paths(ref_opt.m)):
        # one step from zero moments: m = (1 - b1) g
        torch.testing.assert_close(a / (1 - b1), b / (1 - b1), atol=2e-5,
                                   rtol=2e-4, msg=f"grads {path}")
    for (path, a), (_, b) in zip(leaves_with_paths(v),
                                 leaves_with_paths(ref_opt.v)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-4,
                                   msg=f"v {path}")
    for (path, a), (_, b) in zip(leaves_with_paths(full_d),
                                 leaves_with_paths(ref_d)):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-4,
                                   msg=f"weights {path}")


def launch_child(rank, world, tcfg, shapes, n_micro, out_file):
    """Each step of ``launch/steps.py`` at the scaled-down ``shapes`` on a
    (data 2, model 2) mesh with real tensors: rank 0 writes the collective
    counters of each, for the dry-run's analytic count to match."""
    import json

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, build_train_step,
                                          resolve_drafter)
    from repro_torch.sharding import utils as SH

    mesh = make_debug_mesh(2, 2)
    dcfg = resolve_drafter(tcfg)
    out = {}
    for shape in shapes:
        if shape.kind == "train":
            fn, mk = build_train_step(tcfg, dcfg, shape, n_micro=n_micro)
        elif shape.kind == "prefill":
            fn, mk = build_prefill_step(tcfg, shape)
        else:
            fn, mk = build_serve_step(tcfg, dcfg, shape)
        args, extras = mk(mesh, device="cpu")
        SH.reset_counters()
        with SH.mesh_scope(mesh):
            if shape.kind == "decode":
                fn(**args)
            else:
                fn(**args, extras=extras)
        out[shape.name] = {k: v for k, v in SH.counters().items()
                           if k != "use"}
    if rank == 0:
        with open(out_file, "w") as f:
            json.dump(out, f)


def card_serving_child(rank, world):
    """Full-width qwen2-1.5b on 2 of its layers in bfloat16, one card a
    rank over nccl: the sharded Engine.run and a paged serve with swap
    against the unsharded engine on each rank's card: tokens, streams and
    the gathered state equal; every serving kernel launched."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request, Scheduler

    dev = torch.device("cuda", rank)
    e0 = build_engine(mode="parallel", K=5, max_new=32, max_len=512, batch=4,
                      seed=0, device=dev, n_layers=2)

    def sharded(e):
        return Engine(e.tcfg, e.dcfg, e.tparams, e.dparams,
                      dataclasses.replace(e.ecfg, shard_model=True), e.batch,
                      device=dev)
    prompts = random_prompts(e0.tcfg.vocab_size, 4, 128, seed=0)
    ops.reset_launches()
    r1 = sharded(e0).run(prompts)
    launched = dict(ops.launches)
    r0 = e0.run(prompts)
    np.testing.assert_array_equal(r1["tokens"], r0["tokens"])
    assert launched["decode_attention"] > 0 and launched["flash_attention"] > 0
    p0 = Engine(e0.tcfg, e0.dcfg, e0.tparams, e0.dparams, dataclasses.replace(
        e0.ecfg, kv_layout="paged", pool_pages=40, swap="host",
        max_new_tokens=64), 4, device=dev)
    rng = np.random.default_rng(1)
    work = [(rng.integers(0, e0.tcfg.vocab_size - 1, int(m)).astype(np.int32),
             int(b)) for m, b in zip(rng.integers(64, 200, 8),
                                     rng.integers(32, 64, 8))]
    reps = {}
    for name, e in (("sharded", sharded(p0)), ("unsharded", p0)):
        ops.reset_launches()
        reps[name] = Scheduler(e).serve([Request(p, max_new_tokens=b)
                                         for p, b in work])
        if name == "sharded":
            assert ops.launches["paged_decode_attention"] > 0
    assert reps["sharded"]["preempt_swap"] >= 1
    for a, b in zip(reps["sharded"]["results"], reps["unsharded"]["results"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---------------------------------------------------------------------------
# the leaf-by-leaf build and AsyncEngine over several ranks
# ---------------------------------------------------------------------------

def same_tree(a, b, what):
    """Trees of equal paths whose :class:`Shard` leaves hold bitwise equal
    slices under equal specs and whose tensors are bitwise equal."""
    from repro_torch.sharding import utils as SH
    from repro_torch.tree import leaves_with_paths
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (path, x), (_, y) in zip(la, lb):
        assert type(x) is type(y), (what, path, type(x), type(y))
        if isinstance(x, SH.Shard):
            assert x.spec == y.spec, (what, path, x.spec, y.spec)
            x, y = x.local, y.local
        assert x.dtype == y.dtype and torch.equal(x, y), (what, path)


def leafwise_child(rank, world, kw, prompts, expected):
    """``build_engine(shard_model=True)`` against the whole draw: every
    slice bitwise ``shard_tree`` of the unsharded build's tree (same seed),
    at least one leaf sharded, every full leaf the build drew freed once
    its slice was cut, a layer's gathered weights freed once dropped; with ``expected``, the sharded engine's tokens for
    ``prompts``, every slice gathered through the reused buffer of large
    gathers, equal to it (the JAX engine's)."""
    import gc
    import weakref

    from repro_torch.launch.serve import build_engine
    from repro_torch.sharding import rules
    from repro_torch.sharding import utils as SH
    from repro_torch.tree import leaves

    drawn, cut = [], rules.shard

    def shard(t, spec, mesh):
        drawn.append(weakref.ref(t))
        return cut(t, spec, mesh)
    rules.shard = shard
    try:
        sharded = build_engine(shard_model=True, device="cpu", **kw)
    finally:
        rules.shard = cut
    gc.collect()
    assert drawn and not any(r() is not None for r in drawn), \
        "a full leaf outlived its cut"
    whole = build_engine(device="cpu", **kw)
    mesh = sharded.mesh
    # a layer's gathered weights die with the caller's reference, not at
    # the garbage collector's next pass
    gc.disable()
    try:
        layer = sharded.tparams["blocks"][-1]
        with SH.mesh_scope(mesh):
            got = SH.use(layer)
        held = [weakref.ref(t) for t, raw in zip(leaves(got), leaves(layer))
                if isinstance(raw, SH.Shard)]
        del got
        assert not any(r() is not None for r in held), "use() leaked"
    finally:
        gc.enable()
    for name in ("tparams", "dparams"):
        tree = getattr(whole, name)
        same_tree(getattr(sharded, name), SH.shard_tree(
            tree, rules.serve_param_specs(tree, mesh), mesh), name)
        assert any(isinstance(t, SH.Shard)
                   for t in leaves(getattr(sharded, name))), name
    if expected is not None:
        # every slice gathered alone through the mesh's reused buffer, as
        # a full-width MoE layer's experts are
        SH.GATHER_ALONE_BYTES = 0
        got = sharded.run(prompts)["tokens"]
        np.testing.assert_array_equal(got, expected)
        assert len(mesh.scratch) == 1


async def stream_ranks(aeng, work, gaps, abort_at):
    """Rank 0's clients: request i submitted ``gaps[i]`` s after the one
    before it, its tokens drained; request ``abort_at`` aborted after its
    second token. Returns the token lists and the report."""
    import asyncio

    async def drain(i, h):
        toks = []
        async for tok, _ in h:
            toks.append(tok)
            if i == abort_at and len(toks) == 2:
                h.abort()
        return toks
    tasks = []
    for i, ((p, sp, b), gap) in enumerate(zip(work, gaps)):
        await asyncio.sleep(gap)
        tasks.append(asyncio.ensure_future(
            drain(i, await aeng.submit(p, sp, max_new_tokens=b))))
    got = await asyncio.gather(*tasks)
    return got, await aeng.close()


def _sharded_engine(setup):
    from repro_torch.serving.engine import Engine, EngineConfig
    tcfg, dcfg, tp, dp, kw, batch = setup
    return Engine(tcfg, dcfg, tp, dp, EngineConfig(**kw, shard_model=True),
                  batch, device="cpu")


def async_child(rank, world, setup, work, gaps, abort_at, expected):
    """AsyncEngine over the sharded engine: rank 0 streams ``work`` at the
    wall-clock ``gaps``, the other ranks follow. Every rank's session
    holds the same tokens; rank 0's streams equal its report and
    ``expected`` (the JAX twin's), the aborted one a prefix of it; one
    record went out a pass plus the closing one, each counted."""
    import asyncio

    from repro_torch.serving.streaming import AsyncEngine
    from repro_torch.sharding import utils as SH

    aeng = AsyncEngine(_sharded_engine(setup))
    SH.reset_counters()
    if rank == 0:
        got, rep = asyncio.run(asyncio.wait_for(
            stream_ranks(aeng, work, gaps, abort_at), 60))
        assert rep["aborted"] == 1
        for i, (g, w) in enumerate(zip(got, expected)):
            if i == abort_at:
                assert 2 <= len(g) < len(w) and g == list(w[:len(g)]), i
            else:
                assert g == list(w), i
        by_rid = {r["rid"]: r["tokens"].tolist() for r in rep["results"]}
        assert sorted(map(len, got)) == sorted(map(len, by_rid.values()))
    else:
        rep = aeng.follow()
        assert rep["aborted"] == 1
    mine = [(r["rid"], r["tokens"].tolist(), r["aborted"])
            for r in rep["results"]]
    every = [None] * world
    dist.all_gather_object(every, mine)
    assert all(e == every[0] for e in every), "ranks' sessions differ"
    records = [None] * world
    dist.all_gather_object(records, aeng.records)
    assert len(set(records)) == 1 and records[0] >= 2
    assert SH.counters()["broadcast"]["calls"] == aeng.records


def failing_child(rank, world, setup, work):
    """Rank 0's front end fails mid-session (its fourth delivery of
    tokens raises): its streams and ``close`` raise that error, and every
    follower's ``follow()`` raises on the record that carries it."""
    import asyncio

    from repro_torch.serving.streaming import AsyncEngine

    aeng = AsyncEngine(_sharded_engine(setup))
    if rank != 0:
        try:
            aeng.follow()
        except RuntimeError as e:
            assert "rank 0 failed" in str(e) and "front end" in str(e), e
        else:
            raise AssertionError("a follower outlived rank 0's failure")
        return
    inner, calls = aeng._deliver, [0]

    def deliver():
        calls[0] += 1
        if calls[0] == 4:
            raise RuntimeError("front end failed")
        inner()
    aeng._deliver = deliver

    async def go():
        async def drain(p, sp, b):
            return [t async for t, _ in aeng.generate(p, sp,
                                                      max_new_tokens=b)]
        got = await asyncio.gather(*(drain(*w) for w in work),
                                   return_exceptions=True)
        try:
            await aeng.close()
        except RuntimeError as e:
            return got, e
        return got, None
    got, err = asyncio.run(asyncio.wait_for(go(), 60))
    assert err is not None and "front end failed" in str(err)
    assert any(isinstance(g, RuntimeError) for g in got)


# ---------------------------------------------------------------------------
# llama4-maverick at full width and AsyncEngine, one card a rank
# ---------------------------------------------------------------------------

LLAMA4 = "llama4-maverick-400b-a17b"
# two bfloat16 runs of one model (chip_smoke.py's rules): a greedy token
# may part where the reference's top-2 logit gap is below BF16_NEAR_TIE,
# and a row's comparison ends at a call in which its router margin (its
# top-K's last probability less the next) was below BF16_ROUTER_NEAR_TIE
BF16_NEAR_TIE = 0.25
BF16_ROUTER_NEAR_TIE = 2e-3
# the caching allocator's block rounding and small buffers, beside a build
# peak's reckoning
ALLOC_SLACK = 1 << 27


def log(rank, *a):
    print(f"[rank {rank}]", *a, flush=True)


def resident_bytes(*trees) -> int:
    """The bytes a rank holds of parameter trees: its slices and the
    replicated tensors."""
    from repro_torch.sharding import utils as SH
    from repro_torch.tree import leaves
    return sum((t.local if isinstance(t, SH.Shard) else t).numel()
               * (t.local if isinstance(t, SH.Shard) else t).element_size()
               for tree in trees if tree is not None for t in leaves(tree))


@contextlib.contextmanager
def moe_margins():
    """Per MoE layer call of the target: its (B, S), each row's smallest
    router margin and its experts (numpy, on the host), and the call's
    drop_frac. Syncs the card."""
    from repro_torch.models import moe, transformer
    records, inner = [], transformer.moe_apply

    def probed(p, x, **kw):
        out, aux = inner(p, x, **kw)
        K, (B, S) = kw["top_k"], x.shape[:2]
        _, probs, _, experts = moe.route(p, x.reshape(-1, x.shape[-1]), K)
        top = probs.topk(K + 1, dim=-1).values
        records.append(dict(
            shape=(B, S), drop_frac=float(aux["drop_frac"]),
            margin=(top[:, K - 1] - top[:, K]).view(B, S).amin(1)
            .cpu().numpy(), experts=experts.view(B, -1).cpu().numpy()))
        return out, aux
    transformer.moe_apply = probed
    try:
        yield records
    finally:
        transformer.moe_apply = inner


def router_ties(a, b, n_moe, B):
    """Each row's first target call (0: the prefill) from which two probed
    runs may part for that row, or None (chip_smoke.py's
    ``row_router_ties`` under BF16_ROUTER_NEAR_TIE): where both runs made a
    call of one shape, the first at which the row's experts differ, which
    must come with a router margin below the limit; where the shapes
    differ (a verify against a plain decode), the first in which either
    run had a margin below it for the row."""
    first = [None] * B
    for j in range(max(len(a), len(b))):
        x, y = (r[j] if j < len(r) else None for r in (a, b))
        if x is not None and y is not None and x["shape"] == y["shape"]:
            moved = (x["experts"] != y["experts"]).any(1)
            low = np.minimum(x["margin"], y["margin"])
            assert not (moved & ~(low < BF16_ROUTER_NEAR_TIE)).any(), \
                (j, low[moved])
        else:
            moved = np.minimum.reduce([r["margin"] for r in (x, y)
                                       if r is not None]) \
                < BF16_ROUTER_NEAR_TIE
        for rb in np.flatnonzero(moved):
            if first[rb] is None:
                first[rb] = j // n_moe
    return first


def agree_but_ties(ref, got, want, probes, P, n_moe):
    """Each row of ``got`` equals ``want`` from ``P`` on, up to the call
    ``router_ties`` names for it (call i commits positions P + i and
    later), or first parts where the engine ``ref``'s top-2 logit gap over
    ``want``'s context is below BF16_NEAR_TIE. Returns the positions
    compared and the rows equal to the end. Collective under a mesh: every
    rank holds the same runs."""
    from repro_torch.sharding import utils as SH
    B, W = want.shape
    compared, whole = 0, 0
    for b, i in enumerate(router_ties(*probes, n_moe, B)):
        end = W if i is None else min(W, P + i)
        compared += max(end - P, 0)
        whole += bool((got[b, P:] == want[b, P:]).all())
        where = np.flatnonzero(got[b, P:end] != want[b, P:end])
        if len(where):
            pos = P + int(where[0])
            ctx = torch.as_tensor(want[b:b + 1, :pos], device=ref.device)
            with torch.no_grad(), SH.mesh_scope(ref.mesh):
                top2 = ref.model.forward(
                    ref.tparams, ctx, collect_taps=False,
                    head_last_only=True).logits[0, -1].float().topk(2).values
            gap = float(top2[0] - top2[1])
            assert gap < BF16_NEAR_TIE, (b, pos, gap)
    return compared, whole


def card_llama4_child(rank, world):
    """llama4-maverick at full width in bfloat16, 4 of its 48 layers (its
    first global NoPE layer the fourth), storage-sharded over ``world``
    cards: the build peaks at its slices plus one leaf's float32 draw and
    its cast; at capacity factor 128 (no slot dropped) Engine.run's greedy
    parallel and ar streams equal none's under the bfloat16 near-tie
    rules; a paged serve that swaps equals the same serve on a pool that
    never preempts; and at 2 layers, the sharded tokens are the unsharded
    one-card engine's."""
    import dataclasses
    import gc

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, random_prompts
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request, Scheduler
    from repro_torch.sharding import utils as SH

    dev = torch.device("cuda", rank)
    B, P, NEW, K, MAX_LEN = 4, 128, 32, 5, 512
    kw = dict(arch=LLAMA4, mode="parallel", K=K, max_new=NEW,
              max_len=MAX_LEN, batch=B, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    eng = build_engine(n_layers=4, shard_model=True, **kw)
    torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    held = resident_bytes(eng.tparams, eng.dparams)
    cfg = eng.tcfg
    leaf = cfg.moe.n_experts * cfg.d_model * cfg.d_ff * (4 + 2)
    log(rank, f"build {build_s:.1f} s: resident {held / 1e9:.3f} GB, peak "
        f"{peak / 1e9:.3f} GB (bound {(held + leaf) / 1e9:.3f})")
    assert peak <= held + leaf + ALLOC_SLACK, (peak, held, leaf)

    tcfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=128.0))

    def twin(mode, **extra):
        use_d = mode != "none"
        return Engine(tcfg, eng.dcfg if use_d else None, eng.tparams,
                      eng.dparams if use_d else None, dataclasses.replace(
                          eng.ecfg, drafter_mode=mode, K=K if use_d else 0,
                          **extra), B, device=dev)
    n_moe = sum(tcfg.is_moe_layer(li) for li in range(tcfg.n_layers))
    prompts = random_prompts(cfg.vocab_size, B, P, seed=1)
    runs, probes = {}, {}
    for mode in ("none", "parallel", "ar"):
        e = twin(mode)
        e.run(prompts, max_iters=2)                      # cold
        ops.reset_launches()
        SH.reset_counters()
        with moe_margins() as rec:
            r = e.run(prompts)
        gathers = SH.counters()["all_gather"]
        runs[mode], probes[mode] = r["tokens"][:, :P + NEW], rec
        assert max(x["drop_frac"] for x in rec) == 0.0, mode
        assert ops.launches["flash_attention"] > 0, mode
        assert ops.launches["decode_attention"] > 0, mode
        log(rank, f"{mode}: {r['steps']} steps, "
            f"{r['decode_s'] / r['steps'] * 1e3:.2f} ms/step (probed: syncs "
            f"a MoE call), AL {r['acceptance_length']:.3f}, gathers "
            f"{gathers['calls'] / (r['steps'] + 1):.1f} calls / "
            f"{gathers['bytes'] / (r['steps'] + 1) / 1e9:.2f} GB a step, "
            f"launches {dict(ops.launches)}")
        if mode == "none":
            ref = e
    for mode in ("parallel", "ar"):
        n, whole = agree_but_ties(ref, runs[mode], runs["none"],
                                  (probes[mode], probes["none"]), P, n_moe)
        log(rank, f"{mode} vs none: {n} of {B * NEW} positions compared, "
            f"{whole} of {B} rows equal to the end")
    e = twin("parallel")
    e.run(prompts, max_iters=2)
    t0 = time.perf_counter()
    r = e.run(prompts)
    log(rank, f"parallel, unprobed: {r['decode_s'] / r['steps'] * 1e3:.2f} "
        f"ms/step, {r['otps']:.1f} OTPS, {time.perf_counter() - t0:.1f} s")
    del e, ref

    rng = np.random.default_rng(2)
    work = [(rng.integers(0, cfg.vocab_size - 1, int(m)).astype(np.int32),
             int(b)) for m, b in zip(rng.integers(64, 200, 8),
                                     rng.integers(24, 48, 8))]
    reps = {}
    for name, extra in (("swap", dict(pool_pages=30, swap="host")),
                        ("roomy", {})):
        e = twin("parallel", kv_layout="paged", page_size=16,
                 max_new_tokens=64, **extra)
        ops.reset_launches()
        reps[name] = Scheduler(e).serve([Request(p, max_new_tokens=b)
                                         for p, b in work])
        assert ops.launches["paged_decode_attention"] > 0, name
        log(rank, f"serve {name}: {reps[name]['iterations']} iterations, "
            f"{reps[name]['wall_s'] / reps[name]['iterations'] * 1e3:.2f} "
            f"ms/iteration, swaps {reps[name]['preempt_swap']}, "
            f"recomputes {reps[name]['preempt_recompute']}")
        del e
    assert reps["swap"]["preempt_swap"] >= 1
    assert reps["roomy"]["preemptions"] == 0
    for a, b in zip(reps["swap"]["results"], reps["roomy"]["results"]):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    del eng, runs, probes
    gc.collect()
    torch.cuda.empty_cache()

    sharded = build_engine(n_layers=2, shard_model=True, **kw)
    got = sharded.run(prompts)["tokens"]
    del sharded
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        whole = build_engine(n_layers=2, **kw)
        np.testing.assert_array_equal(got, whole.run(prompts)["tokens"])


async def stream_at_once(aeng, work):
    """Submit every (prompt, policy, budget) of ``work`` before the first
    pass, then drain them: (token lists, report)."""
    import asyncio
    handles = [await aeng.submit(p, sp, max_new_tokens=b)
               for p, sp, b in work]

    async def drain(h):
        return [t async for t, _ in h]
    got = await asyncio.gather(*(drain(h) for h in handles))
    return got, await aeng.close()


def card_async_child(rank, world):
    """AsyncEngine over qwen2-1.5b at full width (2 of its layers, bfloat16)
    storage-sharded over ``world`` cards, paged with swap, greedy and
    seeded-sampled requests: rank 0's streams equal the unsharded
    AsyncEngine's on its card, the followers' sessions hold the same
    tokens."""
    import asyncio

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.streaming import AsyncEngine
    from repro_torch.sharding import utils as SH

    dev = torch.device("cuda", rank)
    kw = dict(n_layers=2, mode="parallel", K=5, max_new=64, max_len=512,
              batch=4, seed=0, device=dev, kv_layout="paged", pool_pages=40,
              swap="host")
    aeng = AsyncEngine(build_engine(shard_model=True, **kw))
    V = aeng.engine.tcfg.vocab_size
    rng = np.random.default_rng(4)
    work = [(rng.integers(0, V - 1, int(m)).astype(np.int32),
             None if i % 2 == 0 else SamplingParams(temperature=0.8,
                                                    top_k=50, seed=40 + i),
             int(b)) for i, (m, b) in enumerate(zip(rng.integers(64, 200, 8),
                                                    rng.integers(16, 48, 8)))]
    SH.reset_counters()
    ops.reset_launches()
    if rank != 0:
        rep = aeng.follow()
    else:
        t0 = time.perf_counter()
        got, rep = asyncio.run(asyncio.wait_for(stream_at_once(aeng, work),
                                                300))
        log(rank, f"sharded AsyncEngine: {rep['iterations']} iterations in "
            f"{time.perf_counter() - t0:.1f} s, {aeng.records} records, "
            f"swaps {rep['preempt_swap']}, launches {dict(ops.launches)}")
        assert ops.launches["paged_decode_attention"] > 0
    assert SH.counters()["broadcast"]["calls"] == aeng.records
    mine = [r["tokens"].tolist() for r in rep["results"]]
    every = [None] * world
    dist.all_gather_object(every, mine)
    assert all(e == every[0] for e in every), "ranks' sessions differ"
    if rank == 0:
        want, _ = asyncio.run(asyncio.wait_for(stream_at_once(
            AsyncEngine(build_engine(**kw)), work), 300))
        assert got == want
