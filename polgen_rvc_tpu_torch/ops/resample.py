"""Polyphase windowed-sinc resampling: the port of the JAX package's
ops/resample.py (librosa.resample's role).

Used for an input file at any rate -> the 16 kHz pipeline rate
(utils/audio_io.py:load_audio).

Direct polyphase evaluation: output sample i at input time t_i = i*down/up
is y[i] = sum_q x[j*down + q] * h(p*down/up - q) with i = j*up + p, i.e. one
strided conv1d with `up` output channels (one per phase), whose outputs
interleave. XLA lowered this conv in the JAX package, so F.conv1d runs it
here, on the tensor's own device.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def _polyphase_kernel(orig_sr: int, target_sr: int, zeros: int = 24,
                      rolloff: float = 0.945):
    """Kaiser-windowed sinc kernel bank (up, 1, down + 2W) and (up, down, W)."""
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    # cutoff in cycles per *input* sample
    fc = rolloff * 0.5 * min(1.0, up / down)
    half_width = int(math.ceil(zeros / (2.0 * fc))) + 1
    beta = 14.769656459379492  # kaiser beta for ~180 dB sidelobes

    # phase p's taps are centred at t = p*down/up, which spans [0, down), so
    # the shared kernel support covers q in [-W, down-1+W]
    q = np.arange(-half_width, down + half_width, dtype=np.float64)
    kernels = np.zeros((up, 1, q.size), dtype=np.float64)
    for p in range(up):
        t = p * down / up - q
        x = 2.0 * fc * t
        sinc = np.where(x == 0.0, 1.0, np.sin(np.pi * x) / (np.pi * np.where(x == 0, 1, x)))
        u = t / half_width
        win = np.where(
            np.abs(u) <= 1.0,
            np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - u**2))) / np.i0(beta),
            0.0,
        )
        kernels[p, 0] = 2.0 * fc * sinc * win
    return up, down, half_width, kernels.astype(np.float32)


def resample(x, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Resample the last axis from orig_sr to target_sr: (..., T) ->
    (..., ceil(T * up / down)) on x's device (a numpy array goes to a CPU
    tensor). The right edge is zero-padded by one extra stride, so every
    length gives ceil(T * up / down) samples (the JAX function raises
    unless T is a multiple of down)."""
    x = torch.as_tensor(x)
    if orig_sr == target_sr:
        return x
    up, down, w, kernel = _polyphase_kernel(int(orig_sr), int(target_sr))
    t = x.shape[-1]
    out_len = int(math.ceil(t * up / down))
    xr = F.pad(x.reshape(-1, 1, t), (w, w + down))
    y = F.conv1d(xr, torch.from_numpy(kernel).to(x.device, x.dtype), stride=down)
    # y: (B, up, J); interleave the phases: out[j*up + p] = y[p, j]
    y = y.transpose(1, 2).reshape(y.shape[0], -1)[:, :out_len]
    return y.reshape(x.shape[:-1] + (out_len,))
