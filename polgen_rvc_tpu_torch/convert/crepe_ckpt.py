"""torchcrepe "full" state dict -> the CREPE parameter dictionary.

torchcrepe's names: conv{1..6}.weight/bias, conv{1..6}_BN.{weight, bias,
running_mean, running_var}, classifier.{weight, bias}. The BatchNorm sits
after the ReLU in torchcrepe's layer, so it cannot fold into the conv: it
becomes a per-channel affine (s, t) on the ReLU output (models/crepe.py
applies it before the pool). The classifier weight is stored transposed,
(in_features, 360). Same numbers, bit for bit, as the JAX package's
convert/crepe_ckpt.py.
"""

from __future__ import annotations

import numpy as np

from ..models.crepe import CrepeConfig
from .common import to_numpy

# torch.nn.BatchNorm2d(eps=0.0010000000474974513) in torchcrepe: the float32
# value of keras' 1e-3 default
_BN_EPS = 0.0010000000474974513


def convert_crepe_state(sd: dict, cfg: CrepeConfig = CrepeConfig()) -> dict:
    convs = []
    for i in range(len(cfg.layers)):
        w = to_numpy(sd[f"conv{i + 1}.weight"]).astype(np.float32)
        b = to_numpy(sd[f"conv{i + 1}.bias"]).astype(np.float32)
        gamma = to_numpy(sd[f"conv{i + 1}_BN.weight"]).astype(np.float64)
        beta = to_numpy(sd[f"conv{i + 1}_BN.bias"]).astype(np.float64)
        mean = to_numpy(sd[f"conv{i + 1}_BN.running_mean"]).astype(np.float64)
        var = to_numpy(sd[f"conv{i + 1}_BN.running_var"]).astype(np.float64)
        s = gamma / np.sqrt(var + _BN_EPS)
        t = beta - mean * s
        convs.append({"w": w, "b": b,
                      "s": s.astype(np.float32), "t": t.astype(np.float32)})
    return {
        "convs": convs,
        "classifier": {
            "w": to_numpy(sd["classifier.weight"]).astype(np.float32).T.copy(),
            "b": to_numpy(sd["classifier.bias"]).astype(np.float32),
        },
    }


def load_crepe_checkpoint(path: str, cfg: CrepeConfig = CrepeConfig()) -> dict:
    """A torchcrepe full.pth (tensors only) -> the parameter dictionary."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_crepe_state(sd, cfg)


def make_crepe_state(*, seed: int = 0, cfg: CrepeConfig = CrepeConfig()) -> dict:
    """Synthetic torchcrepe-layout state dict of numpy arrays, with
    non-trivial BatchNorm statistics (an identity BN would hide a wrong
    layer order: BN(relu(x)) == relu(BN(x)) only for the identity)."""
    rng = np.random.default_rng(seed)
    sd = {}
    in_ch = 1
    for i, (out_ch, k, _, _, _) in enumerate(cfg.layers):
        fan = in_ch * k
        sd[f"conv{i + 1}.weight"] = (
            rng.standard_normal((out_ch, in_ch, k, 1)) / np.sqrt(fan)
        ).astype(np.float32)
        sd[f"conv{i + 1}.bias"] = (rng.standard_normal(out_ch) * 0.02).astype(np.float32)
        sd[f"conv{i + 1}_BN.weight"] = (
            1.0 + 0.2 * rng.standard_normal(out_ch)).astype(np.float32)
        sd[f"conv{i + 1}_BN.bias"] = (0.1 * rng.standard_normal(out_ch)).astype(np.float32)
        sd[f"conv{i + 1}_BN.running_mean"] = (
            0.1 * rng.standard_normal(out_ch)).astype(np.float32)
        sd[f"conv{i + 1}_BN.running_var"] = np.exp(
            0.3 * rng.standard_normal(out_ch)).astype(np.float32)
        in_ch = out_ch
    sd["classifier.weight"] = (
        rng.standard_normal((360, cfg.in_features)) / np.sqrt(cfg.in_features)
    ).astype(np.float32)
    sd["classifier.bias"] = np.zeros(360, np.float32)
    return sd
