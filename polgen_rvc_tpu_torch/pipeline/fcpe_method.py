"""The "fcpe" F0 method, on both paths of the JAX package.

``fcpe_f0`` is the host path of pipeline/fcpe_method.py (the reference
predictor's compute_f0): the mel of the padded signal, the salience over a
zero-padded bucket of whole _FRAME_BUCKET frames with the real frame count
as n_valid, the decode at threshold 0.03, then the predictor's host
post-processing onto p_len frames. ``fcpe_f0_device`` is the device path
of pipeline/f0_dispatch.py, which the JAX convert takes when the FCPE hop
equals the engine's window: the mel over the whole zero-tailed bucket,
padded_len // hop + 1 frames as n_valid, the decode, and fcpe_resize_fill
in place of the host post.

Both paths decode inside the span ``polgen.fcpe.decode`` and count, per
pass, the mel frames the net runs over (``fcpe_frames_computed``: the
bucket's) and the frames of signal among them (``fcpe_frames_valid``:
n_valid), every pass of the process, prewarm's too.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.fcpe import (
    fcpe_decode, fcpe_mel, fcpe_post_process, fcpe_resize_fill, fcpe_salience,
)
from ..utils.tracing import count, span

_FRAME_BUCKET = 1024


def fcpe_f0_device(params, cfg, buf, padded_len: int, p_len: int,
                   threshold: float = 0.03):
    """buf (S,) float32 zero-tailed signal, its first padded_len samples
    valid -> (S // hop + 1,) float32 Hz on buf's device, zero from p_len."""
    mel = fcpe_mel(buf.float()[None], cfg)
    n = padded_len // cfg.hop_size + 1
    _count_frames(mel.shape[1], n)
    sal = fcpe_salience(params, cfg, mel, n_valid=n)
    with span("polgen.fcpe.decode"):
        return fcpe_resize_fill(fcpe_decode(sal, cfg, threshold)[0], n, p_len)


def fcpe_f0(params, cfg, audio, p_len: int, threshold: float = 0.03) -> np.ndarray:
    """audio (T,) float32 tensor -> (p_len,) float32 Hz on the host."""
    mel = fcpe_mel(audio.float()[None], cfg)
    n = mel.shape[1]
    bucket = -(-n // _FRAME_BUCKET) * _FRAME_BUCKET
    mel = torch.cat([mel, mel.new_zeros(1, bucket - n, mel.shape[2])], dim=1)
    _count_frames(bucket, n)
    sal = fcpe_salience(params, cfg, mel, n_valid=n)
    with span("polgen.fcpe.decode"):
        f0 = fcpe_decode(sal, cfg, threshold)[0, :n].cpu().numpy()
        if not np.any(f0 > 0):
            return np.zeros(p_len, np.float32)
        return fcpe_post_process(f0, p_len, cfg.hop_size, cfg.sampling_rate)


def _count_frames(computed: int, valid: int) -> None:
    count("fcpe_frames_computed", computed)
    count("fcpe_frames_valid", valid)
