"""HuBERT-base content encoder: the port of polgen_rvc_tpu/models/hubert.py.

7-layer strided conv feature extractor (first layer group-normed, GELU),
LayerNorm + Linear(512 -> 768), grouped positional conv, post-LN
transformer layers; ``hubert_extract`` returns layer ``output_layer``.
Padded frames are zeroed at input and masked out of attention, and the
first GroupNorm's statistics cover only the valid samples, so a chunk's
features do not depend on the bucket it is padded to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..ops.conv import at_rows, conv1d


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_layers: tuple = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
                          (512, 3, 2), (512, 2, 2), (512, 2, 2))
    embed_dim: int = 768
    ffn_dim: int = 3072
    n_heads: int = 12
    n_layers: int = 12
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    final_dim: int = 256  # final_proj output (used by v1 models)

    def num_frames(self, samples: int) -> int:
        t = samples
        for _, k, s in self.conv_layers:
            t = (t - k) // s + 1
        return t


def _layer_norm(x, p, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["gamma"].to(x.dtype),
                        p["beta"].to(x.dtype), eps)


def _group_sums(xg):
    return xg.sum(dim=(2, 3), keepdim=True)


def _group_norm(x, gamma, beta, groups: int, eps=1e-5, time_valid=None, rows=None):
    """GroupNorm over (B, C, T); time_valid (B,) restricts the statistics to
    each row's first time_valid positions, whose sums run at `rows` rows
    (ops/conv.py:at_rows)."""
    b, c, t = x.shape
    xg = x.reshape(b, groups, c // groups, t)
    if time_valid is None:
        mean = xg.mean(dim=(2, 3), keepdim=True)
        var = xg.var(dim=(2, 3), keepdim=True, unbiased=False)
    else:
        tmask = (torch.arange(t, device=x.device)[None, :]
                 < time_valid[:, None]).to(x.dtype)[:, None, None, :]
        n = torch.clamp(time_valid.to(x.dtype), min=1.0)[:, None, None, None] * (c // groups)
        mean = at_rows(_group_sums, rows, xg * tmask) / n
        var = at_rows(_group_sums, rows, (xg - mean).square() * tmask) / n
    xg = (xg - mean) * torch.rsqrt(var + eps)
    x = xg.reshape(b, c, t)
    return x * gamma.to(x.dtype)[None, :, None] + beta.to(x.dtype)[None, :, None]


def feature_extractor(params, cfg: HubertConfig, wav, valid_samples=None, rows=None):
    """(B, T_samples) -> (B, T_frames, 512); rows: as hubert_extract."""
    x = wav[:, None, :]
    for i, (dim, k, s) in enumerate(cfg.conv_layers):
        x = conv1d(x, params["convs"][i]["w"], None, stride=s)
        if i == 0:
            gn = params["convs"][i]["gn"]
            tv = None
            if valid_samples is not None:
                tv = torch.clamp(torch.div(valid_samples - k, s,
                                           rounding_mode="floor") + 1, min=1)
            x = _group_norm(x, gn["gamma"], gn["beta"], groups=dim, time_valid=tv,
                            rows=rows)
        x = F.gelu(x)
    return x.transpose(1, 2)


def _linear(x, p):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


def _attend(x, p, n_heads: int, mask=None, rows=None):
    """The heads of attention on (B, T, C) before the output projection:
    (B, T, C); mask (B, T) True = padded key; the probabilities' product
    with v runs at `rows` rows (at_rows)."""
    b, t, c = x.shape
    q, k, v = _linear(x, p["q"]), _linear(x, p["k"]), _linear(x, p["v"])
    dk = c // n_heads

    def heads(y):
        return y.reshape(b, t, n_heads, dk).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = (q / math.sqrt(dk)) @ k.transpose(-1, -2)
    if mask is not None:
        scores.masked_fill_(mask[:, None, None, :], -1e4)
    out = at_rows(torch.matmul, rows, torch.softmax(scores, dim=-1), v)
    return out.transpose(1, 2).reshape(b, t, c)


def _encoder_input(params, cfg: HubertConfig, wav, padding_mask, compute_dtype,
                   valid_samples, rows=None):
    """Conv features -> LayerNorm -> projection -> padded frames zeroed ->
    + GELU(positional conv) -> the encoder's LayerNorm: (B, T_frames, C)."""
    wav = wav.to(compute_dtype)
    feats = feature_extractor(params["feature_extractor"], cfg, wav,
                              valid_samples=valid_samples, rows=rows)
    feats = _layer_norm(feats, params["layer_norm"])
    x = _linear(feats, params["post_extract_proj"])
    if padding_mask is not None:
        x = x.masked_fill(padding_mask[:, :, None], 0.0)
    pc = params["encoder"]["pos_conv"]
    pos = conv1d(x.transpose(1, 2), pc["w"], pc["b"],
                 padding=cfg.pos_conv_kernel // 2, groups=cfg.pos_conv_groups)
    if cfg.pos_conv_kernel % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    return _layer_norm(x, params["encoder"]["layer_norm"])


def hubert_extract(params, cfg: HubertConfig, wav, *,
                   output_layer: Optional[int] = None, final_proj: bool = False,
                   padding_mask=None, compute_dtype=torch.float32,
                   valid_samples=None, rows=None):
    """(B, T_samples) -> (B, T_frames, embed_dim or final_dim).

    padding_mask: (B, T_frames) bool, True = padded frame;
    valid_samples: (B,) real sample counts; rows: the row count of the
    engine's batch, at which the calls whose algorithm the card picks by
    row count run (ops/conv.py:at_rows), or None. Each post-LN layer:
    attention, its output projection, the residual and norm1; fc1, GELU,
    fc2, the residual and norm2; every projection one _linear in x's
    dtype."""
    if output_layer is None:
        output_layer = cfg.n_layers
    x = _encoder_input(params, cfg, wav, padding_mask, compute_dtype, valid_samples, rows)
    for lp in params["encoder"]["layers"][:output_layer]:
        y = _linear(_attend(x, lp["attn"], cfg.n_heads, mask=padding_mask, rows=rows),
                    lp["attn"]["o"])
        x = _layer_norm(x + y, lp["norm1"])
        y = _linear(F.gelu(_linear(x, lp["fc1"])), lp["fc2"])
        x = _layer_norm(x + y, lp["norm2"])
    if final_proj:
        x = _linear(x, params["final_proj"])
    return x
