"""RMVPE neural F0 predictor: the port of polgen_rvc_tpu/models/rmvpe.py.

DeepUnet (5 encoder / 4 intermediate / 5 decoder levels of ConvBlockRes
chains, run by the U-Net chain kernel, with 2x2 average pooling), the
3-channel head conv, BiGRU(384 -> 2x256) + Linear(512 -> 360) + sigmoid
salience, and the mel frontend (128 HTK mels, win 1024, hop 160, fmin 30,
fmax 8000, log clamp 1e-5). BatchNorms are folded at conversion.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.audio import log_mel_spectrogram, mel_filterbank
from ..ops.conv import conv2d, conv_transpose2d
from ..ops.rnn import bigru
from ..ops.unet_chain import convblock_chain, pack_unet_weights

N_MELS = 128
SAMPLE_RATE = 16000
WIN_LENGTH = 1024
HOP_LENGTH = 160
MEL_FMIN = 30
MEL_FMAX = 8000


@lru_cache(maxsize=1)
def _mel_basis() -> np.ndarray:
    return mel_filterbank(sr=SAMPLE_RATE, n_fft=WIN_LENGTH, n_mels=N_MELS,
                          fmin=MEL_FMIN, fmax=MEL_FMAX, htk=True)


def rmvpe_mel(audio):
    """(B, T_samples) -> (B, 128, T_frames) log-mel, float32."""
    return log_mel_spectrogram(audio, _mel_basis(), n_fft=WIN_LENGTH,
                               hop_length=HOP_LENGTH, center=True, clamp=1e-5)


def pad_frames_to_32(mel):
    """Reflect-pad the frame axis to a multiple of 32; returns (mel, n)."""
    n = mel.shape[-1]
    pad = min(32 * ((n - 1) // 32 + 1) - n, n)
    if pad:
        mel = F.pad(mel, (0, pad), mode="reflect")
    return mel, n


def pack_rmvpe_weights(params):
    """The U-Net's parameters with the chain kernel's weight layouts added
    (pack_unet_weights), made once when the weights load."""
    out = dict(params)
    for part in ("encoder", "intermediate", "decoder"):
        out[part] = [{**lvl, "blocks": pack_unet_weights(lvl["blocks"])}
                     for lvl in params[part]]
    return out


def rmvpe_salience(params, mel, *, compute_dtype=torch.float32):
    """(B, 128, T) log-mel, T a multiple of 32 -> (B, T, 360) salience.
    On the card, params come through pack_rmvpe_weights."""
    x = mel.to(compute_dtype).transpose(1, 2)[:, None]  # (B, 1, T, 128)
    inb = params["in_bn"]
    x = x * inb["scale"].to(x.dtype) + inb["shift"].to(x.dtype)
    skips = []
    for enc in params["encoder"]:
        x = convblock_chain(x, enc["blocks"])
        skips.append(x)
        x = F.avg_pool2d(x, 2)
    for inter in params["intermediate"]:
        x = convblock_chain(x, inter["blocks"])
    for dec, skip in zip(params["decoder"], reversed(skips)):
        up = dec["up"]
        x = conv_transpose2d(x, up["w"], up["b"], stride=2, padding=1,
                             output_padding=1)
        x = torch.cat([torch.relu(x), skip], dim=1)
        x = convblock_chain(x, dec["blocks"])
    x = conv2d(x, params["cnn"]["w"], params["cnn"]["b"], padding=1)
    b, c, t, m = x.shape
    x = x.float().transpose(1, 2).reshape(b, t, c * m)
    x = bigru(x, params["gru"])
    return torch.sigmoid(x @ params["fc"]["w"].float() + params["fc"]["b"].float())
