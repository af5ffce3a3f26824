"""Structural rules of the port: it imports neither JAX nor the JAX
package, and its entry points run on the card unless the caller asks for
the CPU (a missing card raises, nothing falls back)."""
import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import DrafterConfig, get_config
from repro_torch.launch import serve, serve_stream
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.scheduler import Scheduler
import torch_threads  # noqa: F401  (torch threads per xdist worker)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_cuda_sources_for_every_kernel():
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for name, tpu in (("decode_attention", "decode_attention.py"),
                      ("paged_decode_attention", "decode_attention.py"),
                      ("flash_attention", "flash_attention.py"),
                      ("mtp_attention", "mtp_attention.py")):
        text = (csrc / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch' in text
        # names the TPU kernel it replaces
        assert f"repro/kernels/{tpu}" in text


CSRC_FILES = sorted((ROOT / "src" / "repro_torch" / "kernels" / "csrc")
                    .glob("*.cu*"))


@pytest.mark.parametrize("path", CSRC_FILES, ids=lambda p: p.name)
def test_smem_opt_in_flags_have_internal_linkage(path):
    """A shared-memory opt-in flag kept as a static inside a template is one
    object across every loaded library holding that instantiation, so a
    second library's kernel would skip its own opt-in. Each flag is a
    variable template in an anonymous namespace instead."""
    text = path.read_text()
    assert not re.search(r"\bstatic\s+bool\b", text), \
        f"{path.name} keeps a static flag"
    for decl in re.finditer(r"^(.*)\bbool\s+opted_in\s*\[", text, re.M):
        before = text[:decl.start()].rstrip().splitlines()[-1]
        assert decl.group(1).startswith("template") \
            and before.strip() == "namespace {", \
            f"{path.name}: {decl.group(0)!r} is not in an anonymous namespace"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_without_device_raises_without_card(no_card):
    tcfg = get_config("qwen2-1.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tcfg, DrafterConfig().resolve(tcfg), {}, {}, EngineConfig(), 1)


def test_serve_without_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                    "--max-new", "2", "--max-len", "16"])


def test_serve_stream_without_device_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_stream.main(["--reduced", "--batch", "1", "--max-len", "16",
                           "--max-new", "2", "--port", "0"])


def test_serve_stream_rehearses_on_cpu():
    """The streaming server at the reduced width on the CPU, on a free
    port: the demo client, run where torch cannot be imported, streams one
    request to its budget; SIGINT ends the server."""
    import signal
    import subprocess
    import sys
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_stream", "--reduced",
         "--device", "cpu", "--port", "0", "--batch", "2", "--max-len", "64",
         "--max-new", "8", "--page-size", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)
    try:
        line = server.stdout.readline()
        port = re.search(r"server on [\d.]+:(\d+) ", line)
        assert port, line
        code = ("import sys; sys.modules['torch'] = None; "
                "from repro_torch.launch import serve_stream; "
                "serve_stream.main(['--client', '--port', '"
                + port.group(1) + "', '--requests', '1', '--max-new', '6'])")
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "r0: 6 tokens" in out.stdout and "health:" in out.stdout
    finally:
        server.send_signal(signal.SIGINT)
        assert server.wait(timeout=60) == 0


def test_serve_rehearses_round_based_on_cpu():
    """``--round-based``: the same prompts and budgets through the
    round-based baseline on a contiguous twin of the paged engine."""
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                    "--requests", "3", "--prompt-len", "6", "--max-new", "4",
                    "--max-len", "32", "--kv-layout", "paged", "--page-size",
                    "8", "--runs", "1", "--round-based"])
    rb = r["round_based"]
    assert rb["rounds"] == 2 and rb["new_tokens"] == r["new_tokens"] == 12
    assert rb["acceptance_length"] >= 1.0 and rb["otps"] > 0
    assert r["continuous_over_round_based"] > 0
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--round-based",
                    "--shared-prefix", "8"])


def test_serve_rehearses_on_cpu_when_asked():
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "6", "--max-new", "4", "--max-len", "24",
                    "--runs", "1"])
    assert r["device"] == "cpu" and r["new_tokens"] == 8
    assert r["kv_layout"] == "contiguous" and r["requests"] == 2
    assert r["acceptance_length"] >= 1.0


def test_serve_rehearses_gemma2_with_rings_on_cpu():
    """``--arch gemma2-27b --reduced``: the local layers' windows (64) are
    shorter than max_len, so their caches are per-slot rings beside the
    paged global layers, and 70-token prompts are admitted in chunks; every
    request reaches its budget."""
    r = serve.main(["--arch", "gemma2-27b", "--reduced", "--device", "cpu",
                    "--batch", "2", "--requests", "3", "--prompt-len", "70",
                    "--max-new", "6", "--max-len", "128", "--kv-layout",
                    "paged", "--page-size", "8", "--runs", "1"])
    assert r["arch"] == "gemma2-27b" and r["new_tokens"] == 18
    assert r["kv_layout"] == "paged"


@pytest.fixture
def card_claimed(monkeypatch):
    """A CPU-only torch told that a card exists: what runs before the first
    CUDA allocation is exercised; anything that reaches the card fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_gemma7b_on_card_refuses_head_dim_before_weights(card_claimed,
                                                         monkeypatch):
    """The head-dim gate on the card, now that head dim 256 has its bodies:
    a head dim outside ``ops.HEAD_DIMS`` (gemma-7b's config at head dim 96)
    is refused for a CUDA device, naming the kernel work, before any weight
    is made (no init, no generator) and before weights would move; gemma-7b
    itself (head dim 256) passes the gate, as gemma2-27b does."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import registry, transformer
    monkeypatch.setattr(L, "dense_init", lambda *a, **k: pytest.fail(
        "a weight was made"))
    odd = get_config("gemma-7b").replace(head_dim=96)
    assert odd.head_dim not in ops.HEAD_DIMS
    with pytest.raises(NotImplementedError, match="head dim 96"):
        registry.get_model(odd, "cuda")
    with pytest.raises(NotImplementedError, match="decode_splitk.cuh"):
        Engine(odd, DrafterConfig().resolve(odd), {}, {}, EngineConfig(), 1)
    for arch in ("gemma-7b", "gemma2-27b"):
        transformer.check_supported(get_config(arch), "cuda")
        registry.get_model(get_config(arch), "cuda")
    # the same odd head dim builds for the CPU (the plain attention)
    monkeypatch.undo()
    serve.build_engine(arch="gemma-7b", reduced=True, device="cpu", batch=1,
                       max_len=32, max_new=4, K=2)


def test_head_dims_and_row_tiles():
    """The kernels take head dims 32, 64, 128 and 256; the bfloat16 decode
    kernel's block holds 64 packed rows, 16 at head dim 256 (four warps
    split O's columns), and ``decode_split`` counts row blocks so: gemma-7b's
    verify (B 8, T 6, MHA 16 heads) is 128 row blocks, and its 1024 slots
    split into 4 chunks of up to 320 on 132 SMs."""
    from repro_torch.kernels import ops
    assert ops.HEAD_DIMS == (32, 64, 128, 256)
    assert [ops.decode_row_tile(h) for h in ops.HEAD_DIMS] == [64, 64, 64, 16]
    text = (ROOT / "src/repro_torch/kernels/csrc/decode_splitk.cuh").read_text()
    assert "case 256: return launch_hd<256, PAGED>" in text
    for name in ("flash_tc.cuh", "attention_common.cuh"):
        body = (ROOT / "src/repro_torch/kernels/csrc" / name).read_text()
        assert "case 256:" in body, name
    rows = -(-6 // ops.decode_row_tile(256)) * 8 * 16
    assert rows == 128 and ops.decode_split(1024, rows, 132) == (4, 320)


def test_card_admits_gemma7b_and_mamba2_and_refuses_other_families(
        card_claimed):
    """On a CUDA device the registry admits gemma-7b, the SSM mamba2-780m,
    the hybrid recurrentgemma-2b (head dim 256), the MoE dbrx-132b and
    llama4-maverick, the VLM internvl2-1b and the encoder-decoder
    whisper-base (head dim 64) before any weight is made; a family the
    port does not know still raises NotImplementedError, naming it."""
    from repro_torch.models import registry
    for arch in ("gemma-7b", "mamba2-780m", "recurrentgemma-2b", "dbrx-132b",
                 "llama4-maverick-400b-a17b", "internvl2-1b",
                 "whisper-base"):
        assert registry.get_model(get_config(arch), "cuda").cfg.arch_id == arch
    cfg = get_config("qwen2-1.5b")
    for family in ("audio", "diffusion"):
        with pytest.raises(NotImplementedError, match=family):
            registry.get_model(cfg.replace(family=family), "cuda")


def test_serve_rehearses_mamba2_on_cpu():
    """``--arch mamba2-780m --reduced``, paged and preempting, swap to the
    host: the recurrent state stays per slot beside the drafter's pages,
    13-token prompts are admitted in chunks (8 + 4 + 1), a request is
    swapped out, and every request reaches its budget; the prefix cache
    asked for stays idle."""
    r = serve.main(["--arch", "mamba2-780m", "--reduced", "--device", "cpu",
                    "--batch", "2", "--requests", "4", "--prompt-len", "13",
                    "--max-new", "8", "--max-len", "64", "--kv-layout",
                    "paged", "--page-size", "8", "--pool-pages", "7",
                    "--swap", "host", "--prefix-cache", "--runs", "1"])
    assert r["arch"] == "mamba2-780m" and r["new_tokens"] == 32
    assert r["kv_layout"] == "paged" and r["preempt_swap"] > 0
    assert r["cache_hit_tokens"] == 0


def test_serve_rehearses_recurrentgemma_on_cpu():
    """``serve.build_engine(arch="recurrentgemma-2b", reduced=True,
    n_layers=5)``: one super-block and the 2-layer tail, paged at max_len
    64 (the attention layer's cache a pool beside the per-slot recurrent
    rows), a 5-page pool that preempts to the host; 13-token prompts are
    admitted in chunks (8 + 4 + 1), and every request reaches its budget
    with both pools drained."""
    eng = serve.build_engine(arch="recurrentgemma-2b", reduced=True,
                             n_layers=5, device="cpu", batch=2, max_len=64,
                             max_new=8, K=2, kv_layout="paged", page_size=8,
                             pool_pages=5, swap="host")
    assert eng.tcfg.n_layers == 5 and eng.chunk_only and not eng.ring
    assert eng.prefill_buckets(13) == [8, 4, 1]
    reqs = serve.make_requests(eng.tcfg.vocab_size, 4, 13, 8, 0.0, seed=0)
    r = Scheduler(eng).serve(reqs)
    assert r["total_new_tokens"] == 32 and r["preempt_swap"] > 0
    assert all(x["n_new"] == 8 for x in r["results"])
    assert eng.allocator.n_used == 0 and len(eng.host_pool) == 0


def test_serve_rehearses_dbrx_on_cpu():
    """``--arch dbrx-132b --reduced --n-layers 2``, paged and preempting,
    swap to the host: every layer MoE (4 experts, top-2 in the reduced
    config), 13-token prompts padded to 16, a request swapped out, every
    request to its budget; the prefix cache asked for stays idle."""
    r = serve.main(["--arch", "dbrx-132b", "--reduced", "--n-layers", "2",
                    "--device", "cpu", "--batch", "2", "--requests", "4",
                    "--prompt-len", "13", "--max-new", "8", "--max-len", "64",
                    "--kv-layout", "paged", "--page-size", "8",
                    "--pool-pages", "7", "--swap", "host", "--prefix-cache",
                    "--runs", "1"])
    assert r["arch"] == "dbrx-132b" and r["new_tokens"] == 32
    assert r["kv_layout"] == "paged" and r["preempt_swap"] > 0
    assert r["cache_hit_tokens"] == 0


def test_serve_rehearses_paged_arrivals_on_cpu():
    """The scheduler path of the launcher: arrivals on the virtual clock, a
    pool small enough to preempt, every request to its budget."""
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "3",
                    "--requests", "5", "--mean-gap", "1", "--prompt-len",
                    "12", "--max-new", "10", "--max-len", "64",
                    "--kv-layout", "paged", "--page-size", "8",
                    "--pool-pages", "7", "--runs", "1"])
    assert r["kv_layout"] == "paged" and r["new_tokens"] == 50
    assert r["preemptions"] > 0 and 0 < r["peak_pages"] <= 7
    assert r["p99_latency_vt"] >= r["p50_latency_vt"] > 0


def test_serve_rehearses_mixed_sampling_on_cpu():
    """The sampled flags of the launcher: even requests greedy, odd ones
    sampled with sampled drafts, every request to its budget; a mixed
    batch needs a temperature."""
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                    "--requests", "4", "--prompt-len", "8", "--max-new", "6",
                    "--max-len", "32", "--runs", "1", "--temperature", "0.8",
                    "--top-k", "50", "--top-p", "0.95", "--seed", "1",
                    "--mixed-sampling", "--draft-sampling"])
    assert r["new_tokens"] == 24 and r["mixed_sampling"]
    assert r["draft_sampling"] and r["temperature"] == 0.8
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--mixed-sampling"])


def test_serve_rehearses_cache_swap_and_adaptive_k_on_cpu():
    """The serving policies' flags: shared-prefix traffic in two groups hits
    the prefix cache, the small pool preempts to the host, and the
    controller reports; every request reaches its budget."""
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "3",
                    "--requests", "8", "--mean-gap", "1", "--prompt-len",
                    "16", "--max-new", "10", "--max-len", "96",
                    "--kv-layout", "paged", "--page-size", "8",
                    "--pool-pages", "14", "--runs", "1", "--shared-prefix",
                    "24", "--prefix-groups", "2", "--prefix-cache", "--swap",
                    "host", "--adaptive-k"])
    assert r["new_tokens"] == 80 and r["cache_hit_requests"] >= 6
    assert r["preempt_swap"] > 0 and r["host_pool_peak_bytes"] > 0
    assert r["speculation"]["requests"] == 8
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu", "--prefix-groups", "0"])


def test_shared_prefix_requests_layout():
    reqs = serve.shared_prefix_requests(64, 6, 20, 3, (4, 9), (5, 7), 1.0,
                                        seed=0, repeats=2)
    assert len(reqs) == 8
    for i, r in enumerate(reqs[:6]):
        assert np.array_equal(r.prompt[:20], reqs[i % 3].prompt[:20])
        assert 24 <= r.prompt.size <= 29 and 5 <= r.max_new_tokens <= 7
    assert not np.array_equal(reqs[0].prompt[:20], reqs[1].prompt[:20])
    for r, twin in zip(reqs[6:], reqs[4:6]):        # the last two, again
        assert np.array_equal(r.prompt, twin.prompt)
        assert r.max_new_tokens == twin.max_new_tokens
    times = [r.arrival_time for r in reqs]
    assert times == sorted(times) and max(r.prompt.max() for r in reqs) < 63


def test_random_prompts_avoid_mask_token():
    p = serve.random_prompts(16, 4, 64, seed=0)
    assert p.dtype == np.int32 and p.max() < 15


def test_serving_policy_modules_load_without_jax():
    """The prefix cache, the speculation controller, the scheduler that
    drives them and the streaming front end over it (and all they import)
    load with ``jax`` and ``repro`` made unimportable."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = "
            "None; import repro_torch.serving.prefix_cache, "
            "repro_torch.serving.speculation, repro_torch.serving.scheduler, "
            "repro_torch.serving.streaming, repro_torch.launch.serve_stream")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    for rel in ("prefix_cache.py", "speculation.py", "streaming.py"):
        assert ROOT / "src" / "repro_torch" / "serving" / rel in PORT_FILES


def test_multirank_modules_load_without_jax():
    """The leaf-by-leaf sharded build, the mesh's decision broadcast and
    the launcher and front end over several ranks (and all they import)
    load with ``jax`` and ``repro`` made unimportable, and so does the
    card tests' rank helper, which the card's machine runs without JAX."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = "
            "None; import repro_torch.sharding.rules, "
            "repro_torch.sharding.utils, repro_torch.launch.serve, "
            "repro_torch.serving.streaming, torch_sharding_child")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT / 'tests'}"},
                   cwd=ROOT)
    bad = [m for m in _imported_modules(ROOT / "tests" /
                                        "torch_sharding_child.py")
           if m.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert not bad, f"torch_sharding_child.py imports {bad}"


def test_serve_stream_refuses_several_ranks(monkeypatch):
    """The NDJSON server takes no mesh, as the JAX package's does not: it
    refuses a launch of more than one rank before it builds anything."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="several ranks"):
        serve_stream.main(["--reduced", "--device", "cpu", "--port", "0"])


def test_chip_smoke_kernels_line_lists_every_kernel():
    """``chip_smoke.py``'s kernels line (built in ``run_phases``) names all
    four kernels with their sources and the TPU kernels they replace."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "run_phases")
    consts = {c.value for c in ast.walk(fn)
              if isinstance(c, ast.Constant) and isinstance(c.value, str)}
    for name, tpu in (("decode_attention", "decode_attention.py:73"),
                      ("paged_decode_attention", "decode_attention.py:165"),
                      ("flash_attention", "flash_attention.py:79"),
                      ("mtp_attention", "mtp_attention.py:77")):
        assert name in consts, name
        assert f"src/repro/kernels/{tpu}" in consts, tpu
    assert "src/repro_torch/kernels/csrc/mtp_attention.cu" in consts
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in consts, key


def test_prng_and_policy_modules_load_without_jax():
    """``repro_torch.prng`` and ``repro_torch.serving.sampling`` (and all
    they import) load with ``jax`` and ``repro`` made unimportable."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = "
            "None; import repro_torch.prng, repro_torch.serving.sampling")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={"PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)


# torch's own random streams; the sampled lane and the dropout draw from
# repro_torch.prng, the JAX package's threefry words
_TORCH_RANDOM = re.compile(
    r"^torch\.(Generator|rand\w*|bernoulli|multinomial|normal|poisson)$"
    r"|\.(manual_seed|bernoulli_|uniform_|random_|exponential_|normal_)$")
# (file, functions) on the serving and training paths' sampling and
# dropout; None: the whole file
_SAMPLING_PATHS = {
    "prng.py": None,
    "serving/sampling.py": None,
    "serving/engine.py": None,
    "serving/scheduler.py": None,
    "serving/cache_ops.py": None,
    "serving/prefix_cache.py": None,
    "serving/speculation.py": None,
    "core/spec_decode.py": None,
    "core/drafter.py": ("_hidden_inputs", "mtp_forward", "extend", "_draw",
                        "draft_block_inputs", "draft_parallel", "draft_ar"),
    "training/trainer.py": ("_advance_rng", "taps", "loss", "grads", "apply",
                            "_loss_and_grads", "batch_grads", "train_batch",
                            "train"),
}


def _dotted(node):
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        inner = _dotted(node.value)
        return f"{inner}.{node.attr}" if inner else f".{node.attr}"
    return ""


@pytest.mark.parametrize("rel", sorted(_SAMPLING_PATHS))
def test_sampling_and_dropout_use_no_torch_random_stream(rel):
    tree = ast.parse((ROOT / "src" / "repro_torch" / rel).read_text())
    names = _SAMPLING_PATHS[rel]
    roots = [tree] if names is None else [
        n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
        and n.name in names]
    if names is not None:
        assert {n.name for n in roots} == set(names), rel
    bad = {_dotted(c.func) for r in roots for c in ast.walk(r)
           if isinstance(c, ast.Call) and _TORCH_RANDOM.search(_dotted(c.func))}
    assert not bad, f"{rel} calls {sorted(bad)}"


# The JAX package's launchers and their counterparts in the port. A flag the
# port names otherwise is listed here with its reason (none is, so far).
LAUNCHERS = ("serve", "serve_stream", "train", "dryrun")
RENAMED_FLAGS: dict = {}


def _flags(path: Path) -> set:
    return set(re.findall(r"add_argument\(\s*\"(--[a-z0-9-]+)\"",
                          path.read_text()))


@pytest.mark.parametrize("launcher", LAUNCHERS)
def test_port_launchers_take_every_jax_flag(launcher):
    """Every ``--flag`` of ``src/repro/launch/<launcher>.py`` has its
    counterpart in ``src/repro_torch/launch/<launcher>.py``, read from the
    source text of both."""
    jax_flags = _flags(ROOT / "src" / "repro" / "launch" / f"{launcher}.py")
    port = _flags(ROOT / "src" / "repro_torch" / "launch" / f"{launcher}.py")
    assert jax_flags, launcher
    missing = {f for f in jax_flags
               if RENAMED_FLAGS.get((launcher, f), (f,))[0] not in port}
    assert not missing, f"{launcher}: the port lacks {sorted(missing)}"


def test_serve_stream_serves_a_vlm_with_stub_extras():
    """``serve_stream --arch internvl2-1b`` (reduced, on the CPU): requests
    carry no vision inputs, so each gets the prompt-keyed stub extras at
    admission, and the demo client streams one to its budget; with no
    checkpoint under ``--ckpt`` the server says its drafter is random."""
    import signal
    import subprocess
    import sys
    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve_stream", "--arch",
         "internvl2-1b", "--reduced", "--device", "cpu", "--port", "0",
         "--batch", "2", "--max-len", "64", "--max-new", "8",
         "--page-size", "8", "--ckpt", str(ROOT / "no-such-directory")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT)
    try:
        line = server.stdout.readline()
        port = re.search(r"server on [\d.]+:(\d+) \(internvl2-1b, ", line)
        assert port and "random drafter" in line, line
        code = ("from repro_torch.launch import serve_stream; "
                "serve_stream.main(['--client', '--port', '"
                + port.group(1) + "', '--requests', '1', '--max-new', '6'])")
        out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert "r0: 6 tokens" in out.stdout
    finally:
        server.send_signal(signal.SIGINT)
        assert server.wait(timeout=60) == 0


def test_configs_registry_and_family_properties():
    """``all_configs``, ``is_attention_free`` and ``has_decoder`` as the
    JAX package's configs have them."""
    from repro.configs import all_configs as jall_configs
    from repro_torch.configs import all_configs
    port, ref = all_configs(), jall_configs()
    assert sorted(port) == sorted(ref)
    for arch, cfg in port.items():
        assert cfg.is_attention_free == ref[arch].is_attention_free, arch
        assert cfg.has_decoder == ref[arch].has_decoder, arch
    assert [a for a, c in port.items() if c.is_attention_free] == \
        ["mamba2-780m"]
