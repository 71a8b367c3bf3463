"""Host high-pass and the conversion head's pad + int16 quantize.

The upstream pipeline applies a 5th-order 48 Hz Butterworth high-pass with
scipy.signal.filtfilt before chunking. Here it is scipy itself, in float64,
followed by the reflect pad and the int16 quantization against the padded
signal's own max (the JAX package's f0_dispatch._quantize_audio).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy import signal as _sps

F0_FRAME_BUCKET = 1024  # the quantized buffer is a multiple of this many frames


@lru_cache(maxsize=8)
def butter_highpass(order: int = 5, cutoff_hz: float = 48.0,
                    fs: float = 16000.0):
    b, a = _sps.butter(N=order, Wn=cutoff_hz, btype="high", fs=fs)
    return b.astype(np.float64), a.astype(np.float64)


def highpass_filtfilt(x: np.ndarray, fs: float = 16000.0) -> np.ndarray:
    """Zero-phase high-pass (scipy filtfilt, float64)."""
    b, a = butter_highpass(fs=fs)
    return _sps.filtfilt(b, a, np.asarray(x, np.float64))


def quantize_int16(audio: np.ndarray, window: int = 160):
    """int16-quantize a signal against its own max into a zero-tailed buffer
    of a multiple of F0_FRAME_BUCKET frames.

    Returns (int16 (bucket,), inv_scale float32, valid length)."""
    t = audio.shape[0]
    step = F0_FRAME_BUCKET * window
    bucket = max(int(np.ceil(t / step)), 1) * step
    amax = float(np.max(np.abs(audio))) if t else 0.0
    scale = 32767.0 / amax if amax > 0 else 1.0
    buf = np.zeros(bucket, np.int16)
    buf[:t] = np.round(audio * scale)
    return buf, np.float32(1.0 / scale), t


def highpass_pad_quant(audio16k: np.ndarray, t_pad: int, window: int = 160):
    """High-pass -> float32 -> reflect pad by t_pad -> int16 quantize.

    Returns (filtered float32 (n,), int16 buffer, inv_scale, padded length)."""
    audio = highpass_filtfilt(audio16k).astype(np.float32)
    padded = np.pad(audio, (t_pad, t_pad), mode="reflect").astype(np.float32)
    buf, inv_scale, t = quantize_int16(padded, window)
    return audio, buf, inv_scale, t
