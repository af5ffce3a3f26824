"""Build the CUDA sources in ``kernels/csrc`` into shared libraries with a
plain C interface and load them with ctypes.

Each ``<name>.cu`` becomes ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout, where ``<hash>`` covers the source, every header of
``csrc`` and the flags, so an edited source is rebuilt and an unchanged one is
loaded as is. Sources are compiled at first use, one ``nvcc`` per source,
all started together. A failed build raises with nvcc's output.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("decode_attention", "paged_decode_attention", "flash_attention",
           "mtp_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
# C signatures of the entry points (every pointer and the stream as void*)
SIGNATURES = {
    "decode_attention": ("decode_attention_launch",
                         [_PTR] * 11 + [_INT] * 6
                         + [_FLT] + [_INT] * 6 + [_PTR]),
    "paged_decode_attention": ("paged_decode_attention_launch",
                               [_PTR] * 12 + [_INT] * 8
                               + [_FLT] + [_INT] * 6 + [_PTR]),
    "flash_attention": ("flash_attention_launch",
                        [_PTR] * 4 + [_INT] * 6 + [_FLT, _INT, _INT, _FLT,
                                                   _INT, _INT, _PTR]),
    "mtp_attention": ("mtp_attention_launch",
                      [_PTR] * 11 + [_INT] * 5 + [_FLT, _INT, _PTR]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report per source, from the build in this process
ptxas_reports: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    return proc


def build(names: Iterable[str] = SOURCES) -> List[str]:
    """Compile every source of ``names`` whose library is missing, all
    nvcc processes at once. Returns the names built."""
    todo = [n for n in names if not lib_path(n).exists()]
    procs = {n: _start(n) for n in todo}
    errors = []
    for n, proc in procs.items():
        out, _ = proc.communicate()
        ptxas_reports[n] = out
        if proc.returncode != 0:
            os.unlink(proc.tmp)
            errors.append(f"nvcc failed for {n}.cu (exit {proc.returncode}):"
                          f"\n{out}")
        else:
            os.replace(proc.tmp, lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            lib.repro_attn_error_string.argtypes = [ctypes.c_int]
            lib.repro_attn_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib
