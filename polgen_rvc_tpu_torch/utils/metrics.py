"""Mel distortion: the repo's acceptance metric for two renditions of one
conversion (< 0.5 dB), a copy of the JAX package's utils/metrics.py."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.audio import log_mel_spectrogram, mel_filterbank


def mel_distortion_db(a: np.ndarray, b: np.ndarray, sr: int, *,
                      n_mels: int = 80, n_fft: int = 1024, hop: int = 256) -> float:
    """Mean absolute log-mel difference in dB between two waveforms
    (int16 or float), over their common length."""
    n = min(len(a), len(b))
    a = np.asarray(a[:n], np.float32)
    b = np.asarray(b[:n], np.float32)
    if np.abs(a).max() > 1.5:
        a = a / 32768.0
    if np.abs(b).max() > 1.5:
        b = b / 32768.0
    basis = mel_filterbank(sr=sr, n_fft=n_fft, n_mels=n_mels, fmax=sr / 2)
    ma = log_mel_spectrogram(torch.from_numpy(a)[None], basis, n_fft=n_fft,
                             hop_length=hop)
    mb = log_mel_spectrogram(torch.from_numpy(b)[None], basis, n_fft=n_fft,
                             hop_length=hop)
    return float(torch.mean(torch.abs(ma - mb))) * (20.0 / np.log(10.0))
