"""Mel distortion between two renditions of one conversion: a copy of the
port's acceptance metric (``utils/metrics.py``), mean absolute log-mel
difference in dB over 80 slaney mels, n_fft 1024, hop 256."""

from __future__ import annotations

import numpy as np
import torch


def _hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
                    freq / f_sp)


def _mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)


def slaney_mels(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def _log_mel(x, basis, n_fft: int, hop: int):
    n = np.arange(n_fft)
    win = torch.from_numpy((0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft)).astype(np.float32))
    spec = torch.stft(x[None], n_fft, hop_length=hop, window=win, center=True,
                      pad_mode="reflect", return_complex=True)[0]
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2)
    return torch.log(torch.clamp(torch.from_numpy(basis) @ mag, min=1e-5))


def mel_distortion_parts(a: np.ndarray, b: np.ndarray, sr: int, *, n_mels: int = 80,
                         n_fft: int = 1024, hop: int = 256) -> tuple:
    """(summed absolute log-mel difference in dB, number of mel cells) of
    two waveforms (int16 or float) over their common length: pooled over
    several pairs, sum / count is their frame-weighted mel distortion."""
    n = min(len(a), len(b))
    a = np.asarray(a[:n], np.float32)
    b = np.asarray(b[:n], np.float32)
    if np.abs(a).max() > 1.5:
        a = a / 32768.0
    if np.abs(b).max() > 1.5:
        b = b / 32768.0
    basis = slaney_mels(sr, n_fft, n_mels)
    ma = _log_mel(torch.from_numpy(a), basis, n_fft, hop)
    mb = _log_mel(torch.from_numpy(b), basis, n_fft, hop)
    diff = torch.abs(ma - mb).double()
    return float(diff.sum()) * (20.0 / np.log(10.0)), diff.numel()
