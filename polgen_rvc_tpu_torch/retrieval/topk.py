"""Exact top-k feature retrieval with index_rate blending: the port of
polgen_rvc_tpu/retrieval/topk.py.

For every HuBERT frame, the k nearest bank vectors (squared L2, like faiss
IndexFlat), weighted by 1/d^4 normalized, blended into the features by
index_rate. Always exact (``torch.topk``); the JAX package switches to an
approximate top-k above 1,024 bank vectors.
"""

from __future__ import annotations

import torch


def topk_neighbours(feats, bank, k: int = 8):
    """Squared L2 distances (B, T, k) and indices (B, T, k) of each frame's
    k nearest bank vectors, nearest first; fp32 math."""
    f32 = feats.float()
    b32 = bank.float()
    d2 = (f32 * f32).sum(-1, keepdim=True) - 2.0 * (f32 @ b32.T) \
        + (b32 * b32).sum(-1)[None, None, :]
    neg, idx = torch.topk(-d2, k, dim=-1)
    return -neg, idx


def retrieval_blend(feats, bank, index_rate, *, k: int = 8):
    """feats (B, T, d), bank (N, d) -> (B, T, d) in feats' dtype; fp32 math."""
    f32 = feats.float()
    b32 = bank.float()
    d2k, idx = topk_neighbours(f32, b32, k)
    d2k = torch.clamp(d2k, min=1e-12)
    w = 1.0 / (d2k * d2k)
    w = w / w.sum(-1, keepdim=True)
    retrieved = torch.einsum("btk,btkd->btd", w, b32[idx])
    return (index_rate * retrieved + (1.0 - index_rate) * f32).to(feats.dtype)
