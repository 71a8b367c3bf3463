"""VITS windowed relative-position attention over per-row valid lengths:

    s[t, u] = q[t].k[u] + (|u - t| <= w ? q[t].rel_k[u - t + w] : 0)
    p[t]    = softmax over u < length of s[t]
    out[t]  = sum_u p[t, u] v[u] + sum_{|d| <= w} p[t, t + d] rel_v[d + w]

q arrives pre-scaled by 1/sqrt(dk). Rows t >= length are unspecified.

Replaces polgen_rvc_tpu/ops/flash_relattn.py:flash_band_attention. On a
CUDA tensor ``band_attention`` launches the sm_90a streaming-softmax kernel
of csrc/band_attention.cu for every enc_p attention call, whatever T (the
TPU path's T >= 512 gate was a tile choice); it never forms a T x T array.
Each block of BLOCK_ROWS query rows is one 2-CTA cluster that splits the
row's key tiles in two and merges the halves' softmax states in shared
memory; a block whose rows all lie past the row's length writes zeros. On
a CPU tensor it runs ``band_attention_plain``, which does form one.

Working precision on the card: bf16 operands (q, k, v, the relative tables,
and the probabilities in the value product, as in flash kernels), fp32
softmax and accumulation; the result comes back in q's dtype (bf16 or
fp32). bf16 inputs, as the main path gives them, go to the kernel with no
cast; fp32 inputs are rounded to bf16 first.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.tracing import count
from . import cuda_build

BLOCK_ROWS = 64  # query rows of one cluster (csrc/band_attention.cu)


def band_attention_plain(q, k, v, rel_k, rel_v, lengths, window: int, *,
                         operand_dtype=None):
    """Dense fp32 twin: q, k, v (BH, T, dk); rel_k, rel_v (2w+1, dk);
    lengths (BH,) -> (BH, T, dk) in q's dtype. operand_dtype (e.g.
    torch.bfloat16) rounds q, k, v and the tables to it first, as the
    kernel does; the kernel also rounds p before the value product."""

    out_dtype = q.dtype
    if operand_dtype is not None:
        q, k, v, rel_k, rel_v = (a.to(operand_dtype).float()
                                 for a in (q, k, v, rel_k, rel_v))
    bh, t, dk = q.shape
    w = window
    q32, k32, v32 = q.float(), k.float(), v.float()
    dev = q.device
    pos = torch.arange(t, device=dev)
    off = pos[None, :] - pos[:, None] + w  # (T, T): band coordinate of [t, u]
    in_band = (off >= 0) & (off <= 2 * w)
    offc = off.clamp(0, 2 * w).expand(bh, t, t)
    qrel = q32 @ rel_k.float().T  # (BH, T, 2w+1)
    s = q32 @ k32.transpose(1, 2)
    s = s + torch.gather(qrel, 2, offc) * in_band
    valid = pos[None, None, :] < lengths.to(dev).view(bh, 1, 1)
    s = torch.where(valid, s, torch.full_like(s, -1e4))
    p = torch.softmax(s, dim=-1)
    out = p @ v32
    # rel-value band: pb[t, r] = p[t, t + r - w] where that column exists
    band_cols = pos[:, None] + torch.arange(-w, w + 1, device=dev)[None, :]
    col_ok = (band_cols >= 0) & (band_cols < t)
    pb = torch.gather(p, 2, band_cols.clamp(0, t - 1).expand(bh, t, 2 * w + 1))
    out = out + (pb * col_ok) @ rel_v.float()
    return out.to(out_dtype)


def _operand(a):
    """a as the kernel reads it: contiguous bf16 starting on a 16-byte
    boundary (rows are loaded as 16-byte vectors); no copy when it is."""
    a = a.to(torch.bfloat16).contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def band_attention(q, k, v, rel_k, rel_v, lengths, window: int):
    """q, k, v (BH, T, dk), q pre-scaled; rel_k, rel_v (2w+1, dk);
    lengths (BH,) ints >= 1 -> (BH, T, dk) in q's dtype."""
    if (q.dim() != 3 or k.shape != q.shape or v.shape != q.shape
            or rel_k.shape != (2 * window + 1, q.shape[-1])
            or rel_v.shape != rel_k.shape or lengths.shape != (q.shape[0],)):
        raise ValueError(f"band_attention: q/k/v {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, rel tables "
                         f"{tuple(rel_k.shape)}, {tuple(rel_v.shape)}, lengths "
                         f"{tuple(lengths.shape)}, window={window} do not fit")
    if q.device.type == "cpu":
        return band_attention_plain(q, k, v, rel_k, rel_v, lengths, window)
    if q.device.type != "cuda":
        raise ValueError(f"band_attention: unsupported device {q.device}")
    bh, t, dk = q.shape
    if dk % 16 or dk > 128:
        raise ValueError(f"band_attention: dk={dk} is not a multiple of 16 up to 128")
    if 2 * window + 1 > BLOCK_ROWS:
        raise ValueError(f"band_attention: window={window} is above {(BLOCK_ROWS - 1) // 2}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"band_attention: dtype {q.dtype} is neither bfloat16 nor float32")
    tensors = (q, k, v, rel_k, rel_v, lengths)
    if any(a.device != q.device for a in tensors):
        raise ValueError("band_attention: inputs lie on different devices")
    ops = [_operand(a) for a in (q, k, v, rel_k, rel_v)]
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    fn = cuda_build.bind("band_attention", "band_attention", 7,
                         (ctypes.c_int,) * 5)
    cuda_build.launch(fn, q.device, *(cuda_build.ptr(a) for a in (*ops, lens, out)),
                      bh, t, dk, window, int(q.dtype == torch.float32))
    count("launches.band_attention")
    return out
