"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into its own shared library with a plain C
interface, loaded through ctypes (no PyTorch headers: a build takes seconds).
Libraries land in ``build/torch_kernels/`` at the repository root, named by
a hash of their sources and flags, so an edited source rebuilds and an
unchanged one loads as is. ``build_all`` starts one nvcc per source, all at
once. Nothing here runs at import: the CPU has no nvcc and needs none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("resblock_group", "conv_transpose", "band_attention", "unet_chain",
           "viterbi")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}
_FNS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every named kernel whose library is missing, in parallel.

    Returns {name: ptxas report} for the libraries built by this call.
    Raises with nvcc's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed."""
    if name not in _LIBS:
        build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def bind(name: str, symbol: str, n_ptr: int, tail: tuple):
    """ctypes function `symbol` of kernel `name`: n_ptr pointer arguments,
    then the ctypes types in `tail`, then the stream; returns an int."""
    key = (name, symbol)
    if key not in _FNS:
        fn = getattr(load(name), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + list(tail) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return _FNS[key]


def launch(fn, *args):
    """Call a bound kernel entry on the current stream; raise on a CUDA
    error reported by the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def timed_build_all() -> tuple[float, dict]:
    t0 = time.perf_counter()
    reports = build_all()
    return time.perf_counter() - t0, reports
