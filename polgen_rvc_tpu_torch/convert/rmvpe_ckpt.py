"""rmvpe.pt (raw E2E state_dict) -> param pytree with BatchNorm folded.

Layout mirrors reference RMVPE.py:140-376 (E2E(4, 1, (2, 2))):
  unet.encoder:       BatchNorm2d input norm + 5 ResEncoderBlocks
                      (4 ConvBlockRes each + 2x2 avg-pool)
  unet.intermediate:  4 ResEncoderBlocks without pooling
  unet.decoder:       5 ResDecoderBlocks (ConvTranspose2d + BN + ReLU,
                      then 4 ConvBlockRes on the skip-concat)
  cnn:                Conv2d(16 -> 3)
  fc.0.gru / fc.1:    BiGRU(384 -> 2x256) + Linear(512 -> 360)

Every conv here is bias-free and followed by BatchNorm (ConvBlockRes,
RMVPE.py:143-163); eval-mode BN folds exactly into conv scale+bias.
"""

from __future__ import annotations

import numpy as np

from .common import fold_batch_norm_into_conv, to_numpy

N_ENC = 5
N_INTER = 4
N_DEC = 5
N_BLOCKS = 4


def _conv_block_res(sd, prefix: str):
    """ConvBlockRes: conv(3x3)+BN+ReLU twice + optional 1x1 shortcut.

    torch Sequential indices: 0 conv, 1 BN, 2 ReLU, 3 conv, 4 BN, 5 ReLU.
    """
    w1 = to_numpy(sd[f"{prefix}.conv.0.weight"]).astype(np.float32)
    w1, b1 = fold_batch_norm_into_conv(w1, sd, f"{prefix}.conv.1", eps=1e-5)
    w2 = to_numpy(sd[f"{prefix}.conv.3.weight"]).astype(np.float32)
    w2, b2 = fold_batch_norm_into_conv(w2, sd, f"{prefix}.conv.4", eps=1e-5)
    out = {"conv1": {"w": w1, "b": b1}, "conv2": {"w": w2, "b": b2}}
    if f"{prefix}.shortcut.weight" in sd:
        out["shortcut"] = {
            "w": to_numpy(sd[f"{prefix}.shortcut.weight"]).astype(np.float32),
            "b": to_numpy(sd[f"{prefix}.shortcut.bias"]).astype(np.float32),
        }
    return out


def convert_rmvpe_state(sd: dict) -> dict:
    # input BatchNorm2d (Encoder.bn) -> affine scale/shift on the mel image
    gamma = to_numpy(sd["unet.encoder.bn.weight"]).astype(np.float64)
    beta = to_numpy(sd["unet.encoder.bn.bias"]).astype(np.float64)
    mean = to_numpy(sd["unet.encoder.bn.running_mean"]).astype(np.float64)
    var = to_numpy(sd["unet.encoder.bn.running_var"]).astype(np.float64)
    s = gamma / np.sqrt(var + 1e-5)
    in_bn = {
        "scale": s.astype(np.float32).reshape(1, -1, 1, 1),
        "shift": (beta - mean * s).astype(np.float32).reshape(1, -1, 1, 1),
    }

    encoder = []
    for i in range(N_ENC):
        encoder.append({
            "blocks": [
                _conv_block_res(sd, f"unet.encoder.layers.{i}.conv.{j}")
                for j in range(N_BLOCKS)
            ]
        })

    intermediate = []
    for i in range(N_INTER):
        intermediate.append({
            "blocks": [
                _conv_block_res(sd, f"unet.intermediate.layers.{i}.conv.{j}")
                for j in range(N_BLOCKS)
            ]
        })

    decoder = []
    for i in range(N_DEC):
        wt = to_numpy(sd[f"unet.decoder.layers.{i}.conv1.0.weight"]).astype(np.float32)
        wt, bt = fold_batch_norm_into_conv(
            wt, sd, f"unet.decoder.layers.{i}.conv1.1", transpose=True, eps=1e-5
        )
        decoder.append({
            "up": {"w": wt, "b": bt},
            "blocks": [
                _conv_block_res(sd, f"unet.decoder.layers.{i}.conv2.{j}")
                for j in range(N_BLOCKS)
            ],
        })

    gru = {
        k: to_numpy(sd[f"fc.0.gru.{t}"]).astype(np.float32)
        for k, t in [
            ("w_ih_l0", "weight_ih_l0"), ("w_hh_l0", "weight_hh_l0"),
            ("b_ih_l0", "bias_ih_l0"), ("b_hh_l0", "bias_hh_l0"),
            ("w_ih_l0_reverse", "weight_ih_l0_reverse"),
            ("w_hh_l0_reverse", "weight_hh_l0_reverse"),
            ("b_ih_l0_reverse", "bias_ih_l0_reverse"),
            ("b_hh_l0_reverse", "bias_hh_l0_reverse"),
        ]
    }

    return {
        "in_bn": in_bn,
        "encoder": encoder,
        "intermediate": intermediate,
        "decoder": decoder,
        "cnn": {
            "w": to_numpy(sd["cnn.weight"]).astype(np.float32),
            "b": to_numpy(sd["cnn.bias"]).astype(np.float32),
        },
        "gru": gru,
        "fc": {
            "w": to_numpy(sd["fc.1.weight"]).astype(np.float32).T.copy(),
            "b": to_numpy(sd["fc.1.bias"]).astype(np.float32),
        },
    }
