"""The "mangio-crepe" F0 method (reference VC.get_f0_crepe,
pipeline.py:86-117) over the engine's full padded signal: CREPE-full
salience at the user's hop_length in slabs of at most _FRAME_BUCKET frames,
each slab cast to float16 (the JAX package's wire format, part of its
semantics), then the decode, the resize onto the engine's frames, the pitch
shift and the coarse bins.

The JAX package computes whole 2,048-frame slabs so that one compiled graph
serves every song; rows past the n frames of the signal are never read, so
here only those n frames are computed. The reference's 0.999-quantile
pre-scaling cancels under CREPE's per-frame normalization and is skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.crepe import (
    crepe_f0_decode_device, crepe_resize_device, crepe_salience_window,
)
from ..ops.f0_utils import coarse_f0
from ..utils.tracing import span

# frames per salience slab: CREPE's first conv expands each frame to
# 1024 channels x 256 rows, ~0.5 MB in bf16, so a slab peaks at a few GB
_FRAME_BUCKET = 2048


def crepe_f0(params, buf, padded_len: int, opts, *, window: int = 160,
             compute_dtype=torch.float32):
    """buf (S,) float32 padded signal in a zero-tailed buffer, its first
    padded_len samples valid -> (coarse pitch (S // 160 + 1,) int64,
    pitchf (S // 160 + 1,) float32), zero past padded_len // window frames.
    params come through models.crepe.pack_crepe_weights."""
    hop = int(opts.hop_length)
    n = padded_len // hop + 1
    with span("polgen.crepe.net"):
        sal = torch.cat([
            crepe_salience_window(params, buf, 1.0, start, hop,
                                  min(_FRAME_BUCKET, n - start),
                                  compute_dtype=compute_dtype).to(torch.float16)
            for start in range(0, n, _FRAME_BUCKET)
        ])
    with span("polgen.crepe.viterbi"):
        f0 = crepe_f0_decode_device(sal, n, f0_min=opts.f0_min, f0_max=opts.f0_max)
    f0 = crepe_resize_device(f0, n, padded_len // window, buf.shape[0] // 160 + 1)
    pitchf = f0 * float(np.float32(2.0 ** (opts.pitch / 12.0)))
    return coarse_f0(pitchf, opts.f0_min, opts.f0_max), pitchf
