"""F0 post-processing: coarse mel quantization and the RMVPE cents decode.

Same math as the JAX package's ops/f0_utils.py (the upstream pipeline's
get_f0 pitch math and RMVPE's cents<->Hz mapping): bin cents
= 20*i + 1997.3794084376191, f0 = 10 * 2^(cents/1200).
"""

from __future__ import annotations

import numpy as np
import torch

CENTS_OFFSET = 1997.3794084376191
N_PITCH_BINS = 360


def coarse_f0(f0, f0_min: float = 50.0, f0_max: float = 1100.0):
    """Hz -> the synthesizer's 1..255 coarse mel bins (int64), rounded
    half-to-even like np.rint."""
    mel_min = 1127.0 * np.log(1.0 + f0_min / 700.0)
    mel_max = 1127.0 * np.log(1.0 + f0_max / 700.0)
    mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = torch.where(
        mel > 0, (mel - mel_min) * 254.0 / (mel_max - mel_min) + 1.0, mel
    )
    return torch.round(torch.clamp(scaled, 1.0, 255.0)).long()


def bin_cents_table() -> np.ndarray:
    return (20.0 * np.arange(N_PITCH_BINS) + CENTS_OFFSET).astype(np.float32)


def cents_to_hz(cents):
    """Cents -> Hz for a numpy array or a tensor, in the input's precision."""
    return 10.0 * (2.0 ** (cents / 1200.0))


def local_average_cents(salience, threshold: float = 0.03):
    """(..., T, 360) salience -> cents: weighted mean over the 9 bins around
    the argmax (first index on ties), zero where the peak <= threshold."""
    salience = salience.float()
    cents = torch.from_numpy(bin_cents_table()).to(salience.device)
    center = torch.argmax(salience, dim=-1)
    sal_pad = torch.nn.functional.pad(salience, (4, 4))
    cents_pad = torch.nn.functional.pad(cents, (4, 4))
    win_idx = center[..., None] + torch.arange(9, device=salience.device)
    win_sal = torch.gather(sal_pad, -1, win_idx)
    win_cents = cents_pad[win_idx]
    avg = torch.sum(win_sal * win_cents, dim=-1) / torch.clamp(
        torch.sum(win_sal, dim=-1), min=1e-12
    )
    peak = torch.amax(salience, dim=-1)
    return torch.where(peak > threshold, avg, torch.zeros_like(avg))


def salience_to_f0(salience, threshold: float = 0.03):
    """Salience -> Hz, zero on low-confidence frames."""
    cents = local_average_cents(salience, threshold)
    f0 = 10.0 * torch.pow(2.0, cents / 1200.0)
    return torch.where(cents == 0.0, torch.zeros_like(f0), f0)
