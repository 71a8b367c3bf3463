"""Python bindings for the port's native FLAC codec (native/flac_codec.cpp):
a copy of the JAX package's native/flac.py.

``encode`` writes 16-bit FLAC with fixed predictors; the JAX package's
encoder and this one write the same bytes for the same float samples.
int16 samples, which the JAX binding reads as floats and clips to full
scale, are taken as 16-bit PCM here: s / 32767, which the encoder rounds
back to s for every |s| <= 32767. ``decode`` returns float32 q / 32768.
The codec checks its own bounds (truncated metadata, a frame's channel
count against STREAMINFO's) and returns an error code that raises here.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import LIBRARIES, load_library


def _lib():
    lib = load_library("polgen_flac", LIBRARIES["polgen_flac"])
    if not getattr(lib, "_flac_configured", False):
        lib.polgen_flac_probe.restype = ctypes.c_int
        lib.polgen_flac_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.polgen_flac_read.restype = ctypes.c_int
        lib.polgen_flac_read.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        lib.polgen_flac_encode.restype = ctypes.c_int64
        lib.polgen_flac_encode.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib._flac_configured = True
    return lib


def decode(path: str):
    """.flac file -> ((T, C) float32, sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    lib = _lib()
    total = ctypes.c_int64()
    channels = ctypes.c_int32()
    rate = ctypes.c_int32()
    bits = ctypes.c_int32()
    off = lib.polgen_flac_probe(
        data, len(data), ctypes.byref(total), ctypes.byref(channels),
        ctypes.byref(rate), ctypes.byref(bits),
    )
    if off < 0:
        raise ValueError(f"{path}: not a decodable FLAC stream (err {off})")
    n = int(total.value)
    if n == 0:  # unknown length: over-allocate from stream size
        n = len(data) * 8 // (bits.value * channels.value) + 65536
    out = np.zeros(n * channels.value, np.float32)
    rc = lib.polgen_flac_read(
        data, len(data), off, channels.value, bits.value,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
    )
    if rc != 0:
        raise ValueError(f"{path}: FLAC decode failed (err {rc})")
    return out.reshape(-1, channels.value), int(rate.value)


def encode(path: str, samples: np.ndarray, sample_rate: int):
    """(T,) or (T, C) float32 in [-1, 1], or int16 -> .flac file (16-bit,
    fixed predictors)."""
    samples = np.asarray(samples)
    if samples.dtype == np.int16:
        samples = samples.astype(np.float32) / np.float32(32767.0)
    samples = np.asarray(samples, np.float32)
    if samples.ndim == 1:
        samples = samples[:, None]
    inter = np.ascontiguousarray(samples)
    n, c = inter.shape
    lib = _lib()
    bound = lib.polgen_flac_encode(
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, c,
        sample_rate, None, 0,
    )
    buf = ctypes.create_string_buffer(int(bound))
    size = lib.polgen_flac_encode(
        inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, c,
        sample_rate, ctypes.cast(buf, ctypes.c_char_p), bound,
    )
    if size < 0:
        raise RuntimeError("FLAC encode buffer overflow")
    with open(path, "wb") as f:
        f.write(buf.raw[:size])
    return path
