"""The port's launch tooling (``repro_torch.launch.roofline``, ``mesh``,
``steps``, ``dryrun``) on the CPU.

- ``param_count``, ``drafter_param_count`` and ``model_flops_estimate``
  equal the JAX package's for every architecture and input shape;
- the roofline's constants are one H100's (no TPU constant);
- the production meshes describe 256 and 512 GPUs with an 8-GPU model
  axis, without process groups;
- the dry-run of qwen2 reduced on the meta device at scaled-down train,
  prefill and decode shapes over a described (data 2, model 2) mesh is
  ``ok``, and its analytic collective counts equal the counters of the
  same steps run with real tensors on four ``gloo`` ranks.
"""
import inspect
import json

import pytest

from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import DrafterConfig as JDrafterConfig
from repro.configs import get_config as jget_config
from repro.launch import roofline as JRL
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, DrafterConfig,
                                 InputShape, get_config)
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.sharding.utils import Mesh
import torch_threads  # noqa: F401  (torch threads per xdist worker)
import torch_sharding_child as child


def test_input_shapes_are_the_jax_packages():
    assert {k: (v.seq_len, v.global_batch, v.kind)
            for k, v in INPUT_SHAPES.items()} == \
        {k: (v.seq_len, v.global_batch, v.kind)
         for k, v in JINPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_and_model_flops_match_jax(arch):
    tcfg, jcfg = get_config(arch), jget_config(arch)
    dcfg = DrafterConfig().resolve(tcfg)
    jdcfg = JDrafterConfig().resolve(jcfg)
    for active in (False, True):
        assert roofline.param_count(tcfg, active) == \
            JRL.param_count(jcfg, active)
    assert roofline.drafter_param_count(dcfg, tcfg) == \
        JRL.drafter_param_count(jdcfg, jcfg)
    for name, shape in INPUT_SHAPES.items():
        for k in (3, 5):
            assert roofline.model_flops_estimate(tcfg, shape, dcfg, k) == \
                JRL.model_flops_estimate(jcfg, JINPUT_SHAPES[name], jdcfg, k)


def test_h100_constants_and_no_tpu_constant():
    assert roofline.H100 == dict(peak_flops=989e12, hbm_bw=3.35e12,
                                 nvlink_bw=450e9, internode_bw=50e9,
                                 hbm_bytes=80e9)
    assert roofline.AXIS_BW == {"model": 450e9, "data": 50e9, "pod": 50e9}
    src = inspect.getsource(roofline)
    for tpu in ("197e12", "819e9", "HW["):
        assert tpu not in src
    terms = roofline.roofline_terms(
        989e12, 3.35e12 / 2, {"all_gather": {"by_axis": {"model": 450e9,
                                                         "data": 25e9}}}, 8)
    assert terms["compute_s"] == 1.0 and terms["memory_s"] == 0.5
    assert terms["collective_s"] == 1.5
    assert terms["bottleneck"] == "collective_s"


def test_production_meshes():
    sp, mp = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert sp.shape == {"data": 32, "model": 8} and sp.size == 256
    assert mp.shape == {"pod": 2, "data": 32, "model": 8} and mp.size == 512
    assert sp.groups is None and mp.groups is None


SMALL = (InputShape("train_small", 32, 4, "train"),
         InputShape("prefill_small", 64, 4, "prefill"),
         InputShape("decode_small", 64, 4, "decode"))


def test_dryrun_counts_equal_a_gloo_run(tmp_path):
    """qwen2 reduced, train (n 32, 4 rows, 2 micro-batches), prefill (64
    tokens, 4 rows) and one speculative step (64 cached positions, 4 rows)
    on the meta device over a described (data 2, model 2) mesh: each record
    ``ok``, with FLOPs, an activation peak and the three roofline terms;
    its collective counts (per kind and axis: calls and bytes) equal those
    of the same steps with real tensors on four gloo ranks."""
    tcfg = get_config("qwen2-1.5b").reduced()
    mesh = Mesh.describe(("data", "model"), (2, 2))
    recs = {s.name: dryrun.run_one("qwen2-1.5b", s, False, n_micro=2,
                                   mesh=mesh, tcfg=tcfg) for s in SMALL}
    for name, rec in recs.items():
        assert rec["status"] == "ok", (name, rec)
        assert rec["flops"] > 0 and rec["n_gpus"] == 4
        assert rec["memory"]["activation_peak_bytes"] > 0
        assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                                 "collective_s")
    out = tmp_path / "counts.json"
    child.spawn(child.launch_child, 4, tmp_path, tcfg, SMALL, 2, str(out),
                timeout=120)
    real = json.loads(out.read_text())
    for name, rec in recs.items():
        assert roofline.collective_stats(real[name]) == rec["collectives"], \
            name


def test_sharding_and_launch_modules_load_without_jax():
    """The sharding rules and utils and the launch tooling (and all they
    import) load with ``jax`` and ``repro`` made unimportable."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = "
            "None; import repro_torch.sharding, repro_torch.launch.mesh, "
            "repro_torch.launch.steps, repro_torch.launch.roofline, "
            "repro_torch.launch.dryrun")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(root / "src")}, cwd=root)


@pytest.mark.parametrize("variant", ["baseline", "optimized"])
def test_dryrun_variant_numbers_equal_the_jax_dryruns(variant):
    """``--variant``: the record names it, and its drafter is the one the
    JAX dry-run resolves for it (``optimized``: the blocks recomputed in
    the backward, ``remat``), field for field; the per-GPU numbers both
    dry-runs compute from the configs (the useful FLOPs of a cell, over
    the mesh's GPUs) are the JAX package's for that variant at every input
    shape. On qwen2 reduced at the scaled-down train shape over a described
    (data 2, model 2) mesh the optimized step recomputes each drafter
    block, so its counted FLOPs exceed the baseline's."""
    import dataclasses
    from repro.launch.steps import resolve_drafter as jresolve_drafter
    from repro_torch.launch.steps import resolve_drafter
    remat = variant == "optimized"
    for arch in ARCH_IDS:
        tcfg, jcfg = get_config(arch), jget_config(arch)
        dcfg = resolve_drafter(tcfg, remat=remat)
        jdcfg = jresolve_drafter(jcfg, remat=remat)
        assert dataclasses.asdict(dcfg) == dataclasses.asdict(jdcfg), arch
        for name, shape in INPUT_SHAPES.items():
            assert roofline.model_flops_estimate(tcfg, shape, dcfg) / 256 \
                == JRL.model_flops_estimate(jcfg, JINPUT_SHAPES[name],
                                            jdcfg) / 256, (arch, name)
    tcfg = get_config("qwen2-1.5b").reduced()
    mesh = Mesh.describe(("data", "model"), (2, 2))
    recs = {v: dryrun.run_one("qwen2-1.5b", SMALL[0], False, n_micro=2,
                              mesh=mesh, tcfg=tcfg, variant=v)
            for v in ("baseline", variant)}
    rec = recs[variant]
    assert rec["status"] == "ok" and rec["variant"] == variant
    assert rec["roofline"]["model_flops"] == JRL.model_flops_estimate(
        jget_config("qwen2-1.5b").reduced(), SMALL[0],
        jresolve_drafter(jget_config("qwen2-1.5b").reduced(), remat=remat))
    if remat:
        assert rec["flops"] > recs["baseline"]["flops"]
    with pytest.raises(ValueError, match="variant"):
        dryrun.run_one("qwen2-1.5b", SMALL[0], False, variant="fast")
