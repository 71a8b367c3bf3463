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

import threading

import torch
import torch.nn.functional as F


_CUDNN_FLAG_LOCK = threading.Lock()


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
    """x: (B, I, H, W), w: (I, O, KH, KW). cuDNN runs it with a
    deterministic algorithm: the one it picks otherwise for RMVPE's decoder
    (stride 2) sums with atomics, and its result, and with it the F0 track
    and the whole output, changed from run to run on the card.

    The flag is process-global. A lock holds it across the call, so calls
    from two threads (converters shared by a server) cannot restore it
    under each other; code elsewhere that sets the flag from another
    thread meanwhile is not guarded."""
    cudnn = torch.backends.cudnn
    with _CUDNN_FLAG_LOCK:
        prev = cudnn.deterministic
        cudnn.deterministic = True
        try:
            return F.conv_transpose2d(x, w.to(x.dtype), _bias(b, x), stride=stride,
                                      padding=padding, output_padding=output_padding)
        finally:
            cudnn.deterministic = prev
