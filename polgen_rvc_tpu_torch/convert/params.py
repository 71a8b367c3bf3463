"""Carry a parameter dictionary of numpy arrays onto torch tensors."""

from __future__ import annotations

import numpy as np
import torch


def params_to_torch(tree, device="cpu", dtype=torch.float32):
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    tensors on `device`. Floating arrays become `dtype`, integer arrays
    int64; anything else passes through. Accepts the JAX package's numpy
    parameter pytrees as they are."""
    if isinstance(tree, dict):
        return {k: params_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_torch(v, device, dtype) for v in tree)
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(tree))
        t = t.to(dtype) if tree.dtype.kind == "f" else t.long()
        return t.to(device)
    return tree
