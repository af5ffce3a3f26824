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
from repro_torch.launch import serve
from repro_torch.serving.engine import Engine, EngineConfig

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


def test_serve_rehearses_on_cpu_when_asked():
    r = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "6", "--max-new", "4", "--max-len", "24",
                    "--runs", "1"])
    assert r["device"] == "cpu" and r["new_tokens"] == 8
    assert r["kv_layout"] == "contiguous" and r["requests"] == 2
    assert r["acceptance_length"] >= 1.0


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


def test_random_prompts_avoid_mask_token():
    p = serve.random_prompts(16, 4, 64, seed=0)
    assert p.dtype == np.int32 and p.max() < 15


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
