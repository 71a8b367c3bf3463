"""Shared converter helpers."""

from __future__ import annotations

import numpy as np


def to_numpy(t):
    """torch tensor / array-like -> float32-preserving numpy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def fold_weight_norm(sd: dict, prefix: str, dim: int = 0):
    """Resolve a weight-normed tensor from a torch state dict.

    Accepts both serialization styles:
      old:  {prefix}.weight_g / {prefix}.weight_v
      new:  {prefix}.parametrizations.weight.original0 / original1
      none: {prefix}.weight (already plain)
    Returns the folded dense weight w = g * v / ||v|| with the norm taken
    over all dims except `dim` (torch weight_norm semantics).
    """
    if f"{prefix}.weight" in sd:
        return to_numpy(sd[f"{prefix}.weight"])
    if f"{prefix}.weight_g" in sd:
        g = to_numpy(sd[f"{prefix}.weight_g"]).astype(np.float64)
        v = to_numpy(sd[f"{prefix}.weight_v"]).astype(np.float64)
    else:
        g = to_numpy(sd[f"{prefix}.parametrizations.weight.original0"]).astype(np.float64)
        v = to_numpy(sd[f"{prefix}.parametrizations.weight.original1"]).astype(np.float64)
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt(np.sum(v**2, axis=axes, keepdims=True))
    return (g * v / norm).astype(np.float32)


def get_bias(sd: dict, prefix: str):
    key = f"{prefix}.bias"
    return to_numpy(sd[key]).astype(np.float32) if key in sd else None


def conv_params(sd: dict, prefix: str, *, weight_norm: bool = False, dim: int = 0):
    """{'w', 'b'} for a torch Conv*/ConvTranspose* module."""
    w = (
        fold_weight_norm(sd, prefix, dim=dim)
        if weight_norm
        else to_numpy(sd[f"{prefix}.weight"]).astype(np.float32)
    )
    return {"w": w, "b": get_bias(sd, prefix)}


def linear_params(sd: dict, prefix: str, *, weight_norm: bool = False):
    """{'w': (in, out), 'b'} — transposed to matmul layout."""
    w = (
        fold_weight_norm(sd, prefix)
        if weight_norm
        else to_numpy(sd[f"{prefix}.weight"]).astype(np.float32)
    )
    return {"w": w.T.copy(), "b": get_bias(sd, prefix)}


def norm_params(sd: dict, prefix: str, names=("gamma", "beta")):
    """LayerNorm/GroupNorm affine params; torch uses weight/bias, the
    reference VITS LayerNorm uses gamma/beta (normalization.py:10-11)."""
    if f"{prefix}.gamma" in sd:
        g, b = sd[f"{prefix}.gamma"], sd[f"{prefix}.beta"]
    else:
        g, b = sd[f"{prefix}.weight"], sd[f"{prefix}.bias"]
    return {
        "gamma": to_numpy(g).astype(np.float32),
        "beta": to_numpy(b).astype(np.float32),
    }


def fold_batch_norm_into_conv(w, bn_sd: dict, prefix: str, *, transpose: bool = False,
                              eps: float = 1e-5):
    """Fold eval-mode BatchNorm into the preceding (bias-free) conv.

    conv -> BN becomes conv' with w' = w * s, b' = beta - mean * s where
    s = gamma / sqrt(var + eps). `transpose`: weight layout (in, out, ...)
    so the output-channel axis is 1.
    """
    gamma = to_numpy(bn_sd[f"{prefix}.weight"]).astype(np.float64)
    beta = to_numpy(bn_sd[f"{prefix}.bias"]).astype(np.float64)
    mean = to_numpy(bn_sd[f"{prefix}.running_mean"]).astype(np.float64)
    var = to_numpy(bn_sd[f"{prefix}.running_var"]).astype(np.float64)
    s = gamma / np.sqrt(var + eps)
    b = (beta - mean * s).astype(np.float32)
    shape = [1] * w.ndim
    shape[1 if transpose else 0] = -1
    w = (w.astype(np.float64) * s.reshape(shape)).astype(np.float32)
    return w, b
