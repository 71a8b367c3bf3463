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

``at_rows`` (and ``conv1d(..., rows=)``) runs a library call at a fixed
row count. On the card, cuDNN, cuBLAS and PyTorch's reductions pick their
algorithm, and with it the order of a sum, by the batch's row count, so a
mesh's data shard of fewer rows than the engine's batch could give a row
other bytes than the unsharded batch gives it. The calls where that was
seen (mesh_stages.py --sweep: enc_p's FFN conv2 and the flow's WaveNet
in convs at 1,198-1,998 frames, HuBERT's attention product at 798, its
feature extractor's group-norm sums at 4,398-4,798) pass the engine's
chunk_batch and run at that many rows.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F


_CUDNN_FLAG_LOCK = threading.Lock()


def _bias(b, x):
    return None if b is None else b.to(x.dtype)


def at_rows(fn, rows, *xs):
    """fn(*xs), with each x's first axis zero-padded to `rows` when xs lie
    on the card and hold fewer rows, and the result cut back to their rows.
    A row then gets the bytes it gets in a batch of `rows` rows, whatever
    rides beside it: the padded rows' outputs are dropped, and each output
    row reads only its own input row. rows None, at most xs[0]'s rows, or
    CPU tensors: fn(*xs) as it is, no copy (the calls were found on the
    card; on the CPU a shard stays within 1 count of the batch, and the
    padding would multiply its cost)."""
    n = xs[0].shape[0]
    if rows is None or n >= rows or not xs[0].is_cuda:
        return fn(*xs)
    return fn(*(torch.cat([x, x.new_zeros((rows - n, *x.shape[1:]))]) for x in xs))[:n]


def conv1d(x, w, b=None, *, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1, rows=None):
    """x: (B, C, T), w: (O, I/g, K) -> (B, O, T'); rows: run at that many
    rows (at_rows)."""
    return at_rows(lambda x: F.conv1d(x, w.to(x.dtype), _bias(b, x), stride=stride,
                                      padding=padding, dilation=dilation, groups=groups),
                   rows, x)


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
