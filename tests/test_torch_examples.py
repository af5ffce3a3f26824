"""The port's examples (``examples/torch_*.py``) at their reduced size on
the CPU: the quickstart and the serving example print ``lossless: True``
(every greedy speculative stream equals vanilla decoding's), the
long-context example's segmented loss falls; and none of the three imports
JAX or the JAX package (only ``repro_torch``, ``torch``, ``numpy`` and the
standard library)."""
import ast
import importlib.util
import re
import sys
from pathlib import Path

import pytest

import torch_threads  # noqa: F401  (torch threads per xdist worker)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = {"torch_quickstart": ["--epochs", "6"],
            "torch_serve_batched": ["--ks", "3", "--epochs", "6",
                                    "--requests", "6"],
            "torch_train_long_context": ["--epochs", "4"]}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_reduced_on_cpu(name, capsys):
    out = _load(name).main(["--reduced", "--device", "cpu"] + EXAMPLES[name])
    text = capsys.readouterr().out
    if name == "torch_train_long_context":
        first, last = map(float, re.search(
            r"segmented S=4\s*: loss ([\d.]+) -> ([\d.]+)", text).groups())
        assert last < first, text
        assert "dependencies preserved: True" in text
    else:
        assert re.search(r"lossless\s*: True", text), text
        assert out["lossless"] is True


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_imports_only_the_port(name):
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert not mods & {"jax", "jaxlib", "repro", "flax", "benchmarks"}, mods
    assert mods - set(sys.stdlib_module_names) <= {"repro_torch", "torch",
                                                   "numpy"}, mods
