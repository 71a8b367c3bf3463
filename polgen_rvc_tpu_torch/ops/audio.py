"""Spectral frontend: STFT magnitude, mel filterbanks, log-mel.

Same numerics as the JAX package's ops/audio.py for both frontends:
RMVPE's reflect center padding, periodic Hann window, HTK mels and log
clamp; FCPE's asymmetric (win - hop)//2 padding without centering, slaney
mels and the magnitude eps inside the square root. The STFT is
``torch.stft`` (an FFT) where the JAX package multiplies by a DFT basis;
both are float32 to ~1e-6 relative.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (torch.hann_window / scipy get_window fftbins)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def stft_magnitude(x, *, n_fft: int, hop_length: int, win_length: int | None = None,
                   center: bool = True, pad_left: int | None = None,
                   pad_right: int | None = None, pad_mode: str = "reflect",
                   magnitude_eps: float = 0.0):
    """|STFT| of (..., T) float32 -> (..., n_fft//2 + 1, N), freq-major.

    A Hann window of win_length (default n_fft), centred in n_fft. center
    pads n_fft//2 on both sides in pad_mode; explicit pad_left / pad_right
    replace it (FCPE's asymmetric scheme; "constant" pads zeros).
    N = 1 + (T + pads - n_fft) // hop_length."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1]).float()
    win = hann_window(win_length or n_fft)
    lpad = (n_fft - win.shape[0]) // 2
    win = np.pad(win, (lpad, n_fft - win.shape[0] - lpad))
    window = torch.from_numpy(win).to(flat.device)
    if pad_left is not None or pad_right is not None:
        pads = (pad_left or 0, pad_right or 0)
        if any(pads):
            flat = F.pad(flat[:, None], pads, mode=pad_mode)[:, 0]
        center = False
    spec = torch.stft(flat, n_fft, hop_length=hop_length, window=window,
                      center=center, pad_mode=pad_mode, return_complex=True)
    mag = torch.sqrt(spec.real * spec.real + spec.imag * spec.imag
                     + magnitude_eps)
    return mag.reshape(*lead, *mag.shape[-2:])


def _hz_to_mel(freq, htk: bool):
    freq = np.asanyarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )


def _mel_to_hz(mels, htk: bool):
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        mels >= min_log_mel,
        min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs,
    )


def mel_filterbank(*, sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False,
                   norm: str | None = "slaney", dtype=np.float32) -> np.ndarray:
    """Triangular mel filterbank, (n_mels, n_fft//2 + 1). librosa-compatible."""
    fmax = fmax if fmax is not None else sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk),
                          n_mels + 2)
    mel_f = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(dtype)


def log_mel_spectrogram(x, mel_basis: np.ndarray, *, n_fft: int,
                        hop_length: int, win_length: int | None = None,
                        center: bool = True,
                        pad_left: int | None = None, pad_right: int | None = None,
                        pad_mode: str = "reflect", clamp: float = 1e-5,
                        magnitude_eps: float = 0.0):
    """log(clamp(mel @ |STFT|)): (..., T) -> (..., n_mels, N), float32."""
    mag = stft_magnitude(x, n_fft=n_fft, hop_length=hop_length,
                         win_length=win_length, center=center,
                         pad_left=pad_left, pad_right=pad_right,
                         pad_mode=pad_mode, magnitude_eps=magnitude_eps)
    basis = torch.from_numpy(np.asarray(mel_basis, np.float32)).to(mag.device)
    mel = torch.matmul(basis, mag)
    return torch.log(torch.clamp(mel, min=clamp))
