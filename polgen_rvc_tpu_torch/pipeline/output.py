"""Output path: RMS-envelope gain, per-chunk int16 pack, optional
resample, final normalize.

Reproduces the upstream post-processing (change_rms, trim, int16 normalize)
with the JAX package's semantics (pipeline/output.py there): the gain
follows librosa-style RMS envelopes of the 16 kHz source (frame 16000, hop
8000) and of the whole output (frame tgt_sr, hop tgt_sr/2), linearly
interpolated to the output length. Here it runs in torch on whatever device
holds the rows, with float64 sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _interp_linear(x, size: int):
    """F.interpolate(mode='linear', align_corners=False) of a 1-D tensor."""
    n = x.shape[-1]
    if n == 1:
        return x.expand(size).clone()
    pos = (torch.arange(size, dtype=torch.float64, device=x.device) + 0.5) \
        * (n / size) - 0.5
    pos = pos.clamp(0.0, n - 1)
    lo = pos.floor().long().clamp(0, n - 1)
    hi = (lo + 1).clamp(max=n - 1)
    frac = pos - lo.to(torch.float64)
    return x[lo] * (1 - frac) + x[hi] * frac


def _rms(y, frame_length: int, hop_length: int):
    """librosa.feature.rms(center=True, pad zeros) of a 1-D tensor."""
    y = y.to(torch.float64)
    half = frame_length // 2
    c = torch.cat([y.new_zeros(1),
                   torch.cumsum(torch.nn.functional.pad(y, (half, half)) ** 2, 0)])
    n = 1 + y.shape[0] // hop_length
    lo = torch.arange(n, device=y.device) * hop_length
    return torch.sqrt(torch.clamp(c[lo + frame_length] - c[lo], min=0.0)
                      / frame_length)


def change_rms(source, src_sr: int, target, tgt_sr: int, rate: float):
    """The upstream change_rms: scale target towards the source's loudness
    envelope by (1 - rate). Returns target's dtype."""
    rms1 = _rms(source, src_sr // 2 * 2, src_sr // 2)
    rms2 = _rms(target, tgt_sr // 2 * 2, tgt_sr // 2)
    n = target.shape[0]
    rms1 = _interp_linear(rms1, n)
    rms2 = torch.clamp(_interp_linear(rms2, n), min=1e-6)
    gain = rms1 ** (1 - rate) * rms2 ** (rate - 1)
    return (target.to(torch.float64) * gain).to(target.dtype)


def pack_int16(seg):
    """One chunk's rows -> (int16 samples, absmax): quantized against the
    segment's own peak, as the JAX engine emits them."""
    absmax = torch.amax(seg.abs()) if seg.numel() else seg.new_zeros(())
    scale = 32767.0 / torch.clamp(absmax, min=1e-9)
    return torch.round(seg * scale).to(torch.int16), absmax


def rows_to_audio(packed) -> np.ndarray:
    """[(int16 numpy (n,), absmax float)] -> concatenated float32 audio."""
    parts = [seg.astype(np.float32) * (float(am) / 32767.0) for seg, am in packed]
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def host_finalize(audio: np.ndarray, tgt_sr: int, resample_sr: int,
                  sample_rate: int):
    """The host tail (the JAX package's _host_finalize): scipy resample_poly
    to resample_sr when resample_sr >= the pipeline rate and differs from
    the model's, then int16. Returns (int16, rate)."""
    out_sr = tgt_sr
    if resample_sr >= sample_rate and resample_sr != tgt_sr:
        from scipy.signal import resample_poly

        g = math.gcd(tgt_sr, resample_sr)
        audio = resample_poly(audio, resample_sr // g, tgt_sr // g)
        out_sr = resample_sr
    # peak-normalize to 0.99 only when the signal would clip
    audio_max = np.abs(audio).max() / 0.99 if audio.size else 0.0
    max_int16 = 32768.0
    if audio_max > 1:
        max_int16 /= audio_max
    return (audio * max_int16).astype(np.int16), out_sr
