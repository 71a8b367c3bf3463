"""fairseq HuBERT state dict -> (HubertConfig, parameter dictionary).

A direct state-dict conversion (no fairseq at runtime). Only the numpy
conversion lives here; reading .pt files comes later.
"""

from __future__ import annotations

import numpy as np

from ..models.hubert import HubertConfig
from .common import fold_weight_norm, linear_params, norm_params, to_numpy


_STANDARD_STRIDES = (5, 2, 2, 2, 2, 2, 2)


def _find_encoder_heads(obj, depth: int = 0):
    """Recover encoder_attention_heads from fairseq checkpoint metadata
    (ckpt["cfg"]/ckpt["args"], possibly stubbed objects that kept __dict__)."""
    if depth > 6:
        return None
    if isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, _Stub) or hasattr(obj, "__dict__"):
        items = vars(obj).items()
    else:
        return None
    for k, v in items:
        if k == "encoder_attention_heads" and isinstance(v, int) and v > 0:
            return v
    for _, v in items:
        found = _find_encoder_heads(v, depth + 1)
        if found:
            return found
    return None


def infer_hubert_config(sd: dict, *, n_heads: int | None = None) -> HubertConfig:
    """Derive the architecture from state-dict shapes.

    Strides are not serialized; the standard wav2vec2/HuBERT stride schedule
    (5,2,2,2,2,2,2 -> total 320) is assumed, which holds for every public
    HuBERT/contentvec embedder the reference installs
    (tabs/install/install_huberts.py:12-19)."""
    n_conv = 0
    while f"feature_extractor.conv_layers.{n_conv}.0.weight" in sd:
        n_conv += 1
    convs = []
    for i in range(n_conv):
        w = sd[f"feature_extractor.conv_layers.{i}.0.weight"]
        dim, _, k = w.shape
        stride = _STANDARD_STRIDES[i] if i < len(_STANDARD_STRIDES) else 2
        convs.append((int(dim), int(k), int(stride)))
    n_layers = 0
    while f"encoder.layers.{n_layers}.self_attn.q_proj.weight" in sd:
        n_layers += 1
    embed_dim = int(sd["post_extract_proj.weight"].shape[0])
    # Head count is not in the state dict; prefer the checkpoint's own
    # metadata (n_heads arg, recovered from cfg/args by the loader), then map
    # the known embedder families rather than guessing a divisor (a 1024-dim
    # HuBERT-large has 16 heads, not the first divisor that fits) — unknown
    # dims must fail loudly, not run with wrong attention.
    _HEADS_BY_DIM = {768: 12, 1024: 16, 512: 8}
    if n_heads is None:
        n_heads = _HEADS_BY_DIM.get(embed_dim)
    if n_heads is None or embed_dim % n_heads:
        raise ValueError(
            f"unknown HuBERT embed_dim {embed_dim}: cannot infer head count; "
            "pass an explicit HubertConfig to convert_hubert_state"
        )
    if "encoder.pos_conv.0.weight_v" in sd:
        pv = sd["encoder.pos_conv.0.weight_v"]
    else:
        pv = sd["encoder.pos_conv.0.parametrizations.weight.original1"]
    pos_kernel = int(pv.shape[-1])
    pos_groups = embed_dim // int(pv.shape[1])
    final_dim = (
        int(sd["final_proj.weight"].shape[0]) if "final_proj.weight" in sd else 256
    )
    ffn_dim = int(sd["encoder.layers.0.fc1.weight"].shape[0])
    return HubertConfig(
        conv_layers=tuple(convs), embed_dim=embed_dim, ffn_dim=ffn_dim,
        n_heads=n_heads, n_layers=n_layers,
        pos_conv_kernel=pos_kernel, pos_conv_groups=pos_groups,
        final_dim=final_dim,
    )


def convert_hubert_state(sd: dict, cfg: HubertConfig | None = None):
    """fairseq HubertModel state_dict -> param pytree for models.hubert."""
    cfg = cfg or infer_hubert_config(sd)
    convs = []
    for i in range(len(cfg.conv_layers)):
        entry = {"w": to_numpy(sd[f"feature_extractor.conv_layers.{i}.0.weight"]).astype(np.float32)}
        if i == 0:
            entry["gn"] = {
                "gamma": to_numpy(sd["feature_extractor.conv_layers.0.2.weight"]).astype(np.float32),
                "beta": to_numpy(sd["feature_extractor.conv_layers.0.2.bias"]).astype(np.float32),
            }
        convs.append(entry)

    layers = []
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}"
        layers.append(
            {
                "attn": {
                    "q": linear_params(sd, f"{p}.self_attn.q_proj"),
                    "k": linear_params(sd, f"{p}.self_attn.k_proj"),
                    "v": linear_params(sd, f"{p}.self_attn.v_proj"),
                    "o": linear_params(sd, f"{p}.self_attn.out_proj"),
                },
                "norm1": norm_params(sd, f"{p}.self_attn_layer_norm"),
                "fc1": linear_params(sd, f"{p}.fc1"),
                "fc2": linear_params(sd, f"{p}.fc2"),
                "norm2": norm_params(sd, f"{p}.final_layer_norm"),
            }
        )

    params = {
        "feature_extractor": {"convs": convs},
        "layer_norm": norm_params(sd, "layer_norm"),
        "post_extract_proj": linear_params(sd, "post_extract_proj"),
        "encoder": {
            "pos_conv": {
                # fairseq weight-norms the positional conv along dim=2
                "w": fold_weight_norm(sd, "encoder.pos_conv.0", dim=2),
                "b": to_numpy(sd["encoder.pos_conv.0.bias"]).astype(np.float32),
            },
            "layer_norm": norm_params(sd, "encoder.layer_norm"),
            "layers": layers,
        },
    }
    if "final_proj.weight" in sd:
        params["final_proj"] = linear_params(sd, "final_proj")
    return params
