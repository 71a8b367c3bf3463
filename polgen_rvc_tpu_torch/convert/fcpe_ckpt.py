"""fcpe.pt ({config, model}) -> (FcpeConfig, parameter dictionary).

The checkpoint layout of the reference FCPEInfer; module names from its
FCPE / PCmer classes. Same numbers, bit for bit, as the JAX package's
convert/fcpe_ckpt.py; ``make_fcpe_state`` fabricates synthetic weights so
nothing needs a download.
"""

from __future__ import annotations

import numpy as np

from ..models.fcpe import FcpeConfig
from .common import fold_weight_norm, linear_params, norm_params, to_numpy


def build_fcpe_config(cfg_dict: dict) -> FcpeConfig:
    model = cfg_dict.get("model", {})
    mel = cfg_dict.get("mel", {})
    return FcpeConfig(
        input_channel=int(model.get("input_channel", 128)),
        out_dims=int(model.get("out_dims", 360)),
        n_layers=int(model.get("n_layers", 12)),
        n_chans=int(model.get("n_chans", 512)),
        f0_min=float(model.get("f0_min", 32.70)),
        f0_max=float(model.get("f0_max", 1975.5)),
        sampling_rate=int(mel.get("sampling_rate", 16000)),
        num_mels=int(mel.get("num_mels", 128)),
        n_fft=int(mel.get("n_fft", 1024)),
        win_size=int(mel.get("win_size", 1024)),
        hop_size=int(mel.get("hop_size", 160)),
        fmin=float(mel.get("fmin", 0)),
        fmax=float(mel.get("fmax", 8000)),
    )


def convert_fcpe_state(sd: dict, cfg: FcpeConfig) -> dict:
    def conv(prefix):
        return {
            "w": to_numpy(sd[f"{prefix}.weight"]).astype(np.float32),
            "b": to_numpy(sd[f"{prefix}.bias"]).astype(np.float32),
        }

    layers = []
    for i in range(cfg.n_layers):
        p = f"decoder._layers.{i}"
        layers.append({
            "norm": norm_params(sd, f"{p}.norm"),
            "attn": {
                "projection_matrix": to_numpy(
                    sd[f"{p}.attn.fast_attention.projection_matrix"]
                ).astype(np.float32),
                "to_q": linear_params(sd, f"{p}.attn.to_q"),
                "to_k": linear_params(sd, f"{p}.attn.to_k"),
                "to_v": linear_params(sd, f"{p}.attn.to_v"),
                "to_out": linear_params(sd, f"{p}.attn.to_out"),
            },
            "conformer": {
                "norm": norm_params(sd, f"{p}.conformer.net.0"),
                "conv_in": conv(f"{p}.conformer.net.2"),
                "depthwise": conv(f"{p}.conformer.net.4.conv"),
                "conv_out": conv(f"{p}.conformer.net.6"),
            },
        })
    dense_w = fold_weight_norm(sd, "dense_out")  # weight-normed Linear
    return {
        "stack": {
            "conv1": conv("stack.0"),
            "gn": norm_params(sd, "stack.1"),
            "conv2": conv("stack.3"),
        },
        "layers": layers,
        "norm": norm_params(sd, "norm"),
        "dense_out": {
            "w": dense_w.T.copy(),
            "b": to_numpy(sd["dense_out.bias"]).astype(np.float32),
        },
    }


def load_fcpe_checkpoint(path: str):
    """(FcpeConfig, parameters) from a {config, model} checkpoint file."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = build_fcpe_config(dict(ckpt["config"]))
    return cfg, convert_fcpe_state(ckpt["model"], cfg)


def make_fcpe_state(*, tiny: bool = True, seed: int = 0):
    """Synthetic {config-equivalent cfg, state dict} for tests."""
    rng = np.random.default_rng(seed)
    cfg = FcpeConfig(n_layers=2, n_chans=64) if tiny else FcpeConfig()
    c = cfg.n_chans
    inner = c * 2
    sd = {}

    def conv(prefix, out_c, in_c, k):
        sd[f"{prefix}.weight"] = (
            rng.standard_normal((out_c, in_c, k)) / np.sqrt(in_c * k)
        ).astype(np.float32)
        sd[f"{prefix}.bias"] = (rng.standard_normal(out_c) * 0.02).astype(np.float32)

    def lin(prefix, out_c, in_c):
        sd[f"{prefix}.weight"] = (
            rng.standard_normal((out_c, in_c)) / np.sqrt(in_c)
        ).astype(np.float32)
        sd[f"{prefix}.bias"] = (rng.standard_normal(out_c) * 0.02).astype(np.float32)

    def norm(prefix, n):
        sd[f"{prefix}.weight"] = np.ones(n, np.float32)
        sd[f"{prefix}.bias"] = np.zeros(n, np.float32)

    conv("stack.0", c, cfg.input_channel, 3)
    norm("stack.1", c)
    conv("stack.3", c, c, 3)
    # the reference SelfAttention: a FIXED dim_head of 64, inner = 64*8 =
    # 512, nb_features = int(64*log(64)) = 266; not c / heads
    dh = 64
    inner_attn = dh * 8
    nb_features = int(dh * np.log(dh))
    for i in range(cfg.n_layers):
        p = f"decoder._layers.{i}"
        norm(f"{p}.norm", c)
        sd[f"{p}.attn.fast_attention.projection_matrix"] = (
            rng.standard_normal((nb_features, dh)).astype(np.float32)
        )
        for nm in ("to_q", "to_k", "to_v"):
            lin(f"{p}.attn.{nm}", inner_attn, c)
        lin(f"{p}.attn.to_out", c, inner_attn)
        norm(f"{p}.conformer.net.0", c)
        conv(f"{p}.conformer.net.2", inner * 2, c, 1)
        sd[f"{p}.conformer.net.4.conv.weight"] = (
            rng.standard_normal((inner, 1, 31)) / np.sqrt(31)
        ).astype(np.float32)
        sd[f"{p}.conformer.net.4.conv.bias"] = np.zeros(inner, np.float32)
        conv(f"{p}.conformer.net.6", c, inner, 1)
    norm("norm", c)
    v = (rng.standard_normal((cfg.out_dims, c)) / np.sqrt(c)).astype(np.float32)
    sd["dense_out.weight_g"] = np.linalg.norm(v, axis=1, keepdims=True).astype(np.float32)
    sd["dense_out.weight_v"] = v
    sd["dense_out.bias"] = np.zeros(cfg.out_dims, np.float32)
    return cfg, sd
