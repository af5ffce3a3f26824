"""Multi-process helpers of the port's sharding tests (a helper, not a test
file): ``spawn`` runs a function on ``world`` spawned ranks joined by a
``gloo`` process group (``nccl`` for the card tests, one card a rank) over
a file in the test's temporary directory, one torch thread each, and kills them at a deadline of its own, so a
mismatched collective fails the test instead of hanging the run. The
children import this module and the port, never ``jax`` nor ``repro``:
the JAX references are computed by the parent and passed in."""
from __future__ import annotations

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
