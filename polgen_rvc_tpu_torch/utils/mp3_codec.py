"""MP3 encode and decode through ctypes bindings to the system codec
libraries: libmp3lame to encode, libmpg123 to decode (a copy of the JAX
package's utils/mp3_codec.py). Without them, Mp3Unavailable is raised and
utils/audio_io.py falls back to an ffmpeg subprocess or CodecUnavailable.

Both libraries are loaded lazily on first use; nothing here loads at
import time.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np


class Mp3Unavailable(RuntimeError):
    pass


_LAME = None
_MPG = None

# mpg123.h constants (stable ABI)
_MPG123_MONO = 1
_MPG123_STEREO = 2
_MPG123_ENC_SIGNED_16 = 0xD0
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_RATES = (
    8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000,
)


def _lame():
    global _LAME
    if _LAME is None:
        try:
            lib = ctypes.CDLL("libmp3lame.so.0")
        except OSError as e:
            raise Mp3Unavailable(f"libmp3lame not present: {e}") from e
        lib.lame_init.restype = ctypes.c_void_p
        for name in (
            "lame_set_in_samplerate", "lame_set_out_samplerate",
            "lame_set_num_channels", "lame_set_brate", "lame_set_mode",
            "lame_set_quality", "lame_init_params", "lame_close",
        ):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] + (
                [ctypes.c_int] if name not in ("lame_init_params", "lame_close") else []
            )
        lib.lame_encode_buffer_interleaved.restype = ctypes.c_int
        lib.lame_encode_buffer_interleaved.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.lame_encode_buffer.restype = ctypes.c_int
        lib.lame_encode_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.lame_encode_flush.restype = ctypes.c_int
        lib.lame_encode_flush.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        _LAME = lib
    return _LAME


def _mpg123():
    global _MPG
    if _MPG is None:
        try:
            lib = ctypes.CDLL("libmpg123.so.0")
        except OSError as e:
            raise Mp3Unavailable(f"libmpg123 not present: {e}") from e
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.restype = ctypes.c_int
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.restype = ctypes.c_int
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.restype = ctypes.c_int
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ]
        lib.mpg123_read.restype = ctypes.c_int
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_plain_strerror.restype = ctypes.c_char_p
        lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
        _MPG = lib
    return _MPG


def available() -> bool:
    """True when both encode and decode libraries load."""
    try:
        _lame()
        _mpg123()
        return True
    except Mp3Unavailable:
        return False


def encode_mp3(path: str, samples: np.ndarray, sr: int, *,
               bitrate_kbps: int = 192, quality: int = 2) -> str:
    """samples: (T,) / (T, C) float in [-1, 1] or int16 -> CBR mp3 file."""
    lame = _lame()
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    channels = min(samples.shape[1], 2)
    samples = samples[:, :channels]
    if samples.dtype != np.int16:
        samples = np.round(
            np.clip(samples.astype(np.float64), -1.0, 1.0) * 32767.0
        ).astype(np.int16)
    samples = np.ascontiguousarray(samples)
    n = samples.shape[0]

    gfp = lame.lame_init()
    if not gfp:
        raise Mp3Unavailable("lame_init failed")
    try:
        lame.lame_set_in_samplerate(gfp, int(sr))
        lame.lame_set_out_samplerate(gfp, int(sr))
        lame.lame_set_num_channels(gfp, channels)
        lame.lame_set_mode(gfp, 1 if channels == 2 else 3)  # joint / mono
        lame.lame_set_brate(gfp, int(bitrate_kbps))
        lame.lame_set_quality(gfp, int(quality))
        if lame.lame_init_params(gfp) < 0:
            raise Mp3Unavailable(
                f"lame rejected params (sr={sr}, ch={channels}, "
                f"{bitrate_kbps} kbps)"
            )
        out = ctypes.create_string_buffer(int(1.25 * n) + 7200)
        if channels == 2:
            written = lame.lame_encode_buffer_interleaved(
                gfp, samples.ctypes.data, n, out, len(out)
            )
        else:
            written = lame.lame_encode_buffer(
                gfp, samples.ctypes.data, samples.ctypes.data, n, out, len(out)
            )
        if written < 0:
            raise Mp3Unavailable(f"lame encode error {written}")
        with open(path, "wb") as f:
            f.write(out.raw[:written])
            tail = ctypes.create_string_buffer(7200)
            written = lame.lame_encode_flush(gfp, tail, len(tail))
            if written > 0:
                f.write(tail.raw[:written])
    finally:
        lame.lame_close(gfp)
    return path


def decode_mp3(path: str):
    """mp3 file -> ((T, C) float32 in [-1, 1], sr)."""
    mpg = _mpg123()
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    err = ctypes.c_int(0)
    h = mpg.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise Mp3Unavailable(f"mpg123_new failed: {err.value}")
    try:
        # lock output to signed-16 at the stream's own rate/channels
        mpg.mpg123_format_none(h)
        for rate in _MPG123_RATES:
            mpg.mpg123_format(
                h, rate, _MPG123_MONO | _MPG123_STEREO, _MPG123_ENC_SIGNED_16
            )
        rc = mpg.mpg123_open(h, os.fsencode(path))
        if rc != _MPG123_OK:
            raise ValueError(
                f"{path}: {mpg.mpg123_plain_strerror(rc).decode()}"
            )
        rate = ctypes.c_long(0)
        ch = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        rc = mpg.mpg123_getformat(
            h, ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(enc)
        )
        if rc != _MPG123_OK:
            raise ValueError(
                f"{path}: {mpg.mpg123_plain_strerror(rc).decode()}"
            )
        chunks = []
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        while True:
            rc = mpg.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[: done.value])
            if rc == _MPG123_DONE:
                break
            if rc == _MPG123_NEW_FORMAT:
                mpg.mpg123_getformat(
                    h, ctypes.byref(rate), ctypes.byref(ch), ctypes.byref(enc)
                )
                continue
            if rc != _MPG123_OK:
                raise ValueError(
                    f"{path}: {mpg.mpg123_plain_strerror(rc).decode()}"
                )
        pcm = np.frombuffer(b"".join(chunks), "<i2")
        channels = max(ch.value, 1)
        pcm = pcm[: (len(pcm) // channels) * channels].reshape(-1, channels)
        return pcm.astype(np.float32) / 32768.0, int(rate.value)
    finally:
        mpg.mpg123_close(h)
        mpg.mpg123_delete(h)
