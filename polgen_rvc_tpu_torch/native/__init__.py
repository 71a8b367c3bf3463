"""The port's host-side C++ (the FLAC codec and the effects chain), built
with g++ at first use and bound through ctypes: the port's copy of the JAX
package's native/__init__.py, with its own build directory.

Each library compiles from its source in this directory with the JAX
package's flags (``-O2 -shared -fPIC -std=c++17``), so both packages give
the same bits, into ``build/native/`` at the repository root, named by a
hash of its source and flags: an edited source rebuilds, an unchanged one
loads as is. A build writes a file of its own process and renames it into
place, under a lock within the process. Nothing builds at import. A failed
build raises ``NativeBuildError`` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBRARIES = {"polgen_dsp": "dsp.cpp", "polgen_flac": "flac_codec.cpp"}

_LOCK = threading.Lock()
_LIBS: dict = {}


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str, source: str) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update((SRC_DIR / source).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _build(name: str, source: str) -> Path:
    out = library_path(name, source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC_DIR / source), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeBuildError(f"g++ not found: cannot build {source}") from e
    except subprocess.CalledProcessError as e:
        raise NativeBuildError(f"g++ failed on {source}:\n{e.stdout}{e.stderr}") from e
    os.replace(tmp, out)
    return out


def available(name: str) -> bool:
    """Whether library `name` is built or g++ is there to build it: where
    neither holds, a caller may take another codec."""
    return (library_path(name, LIBRARIES[name]).exists()
            or shutil.which("g++") is not None)


def load_library(name: str, source: str) -> ctypes.CDLL:
    """The loaded library built from `source`, building it first if needed."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_build(name, source)))
        return _LIBS[name]


def build_all() -> dict:
    """Build (or find) and load every native library: {name: path}."""
    for name, source in LIBRARIES.items():
        load_library(name, source)
    return {name: str(library_path(name, source)) for name, source in LIBRARIES.items()}


def dsp_library() -> ctypes.CDLL:
    lib = load_library("polgen_dsp", LIBRARIES["polgen_dsp"])
    if not getattr(lib, "_polgen_configured", False):
        lib.polgen_chain_create.restype = ctypes.c_void_p
        lib.polgen_chain_create.argtypes = [ctypes.c_double] + [ctypes.c_float] * 18
        lib.polgen_chain_process.restype = None
        lib.polgen_chain_process.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.polgen_chain_destroy.restype = None
        lib.polgen_chain_destroy.argtypes = [ctypes.c_void_p]
        lib._polgen_configured = True
    return lib
