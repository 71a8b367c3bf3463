"""Convolutions with PyTorch layout and padding, as the JAX package's ops.

Weight layouts are torch's, so converted checkpoints drop straight in:
  conv1d:            w (out, in/groups, k)
  conv2d:            w (out, in/groups, kh, kw)
  conv_transpose2d:  w (in, out/groups, kh, kw)

These are the convolutions the JAX package leaves to XLA (HuBERT's feature
convs, the WaveNet and FFN convs, RMVPE's transposed convs and head). The
decoder's upsampling, its resblocks and the U-Net block chains have kernels
of their own (ops/conv_transpose.py, ops/resblock_group.py,
ops/unet_chain.py). Weights are cast to the activation dtype, as the JAX
ops do.
"""

from __future__ import annotations

import torch.nn.functional as F


def _bias(b, x):
    return None if b is None else b.to(x.dtype)


def conv1d(x, w, b=None, *, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1):
    """x: (B, C, T), w: (O, I/g, K) -> (B, O, T')."""
    return F.conv1d(x, w.to(x.dtype), _bias(b, x), stride=stride,
                    padding=padding, dilation=dilation, groups=groups)


def conv2d(x, w, b=None, *, stride=1, padding=0, dilation=1, groups: int = 1):
    """x: (B, C, H, W), w: (O, I/g, KH, KW)."""
    return F.conv2d(x, w.to(x.dtype), _bias(b, x), stride=stride,
                    padding=padding, dilation=dilation, groups=groups)


def conv_transpose2d(x, w, b=None, *, stride=1, padding=0, output_padding=0):
    """x: (B, I, H, W), w: (I, O, KH, KW)."""
    return F.conv_transpose2d(x, w.to(x.dtype), _bias(b, x), stride=stride,
                              padding=padding, output_padding=output_padding)
