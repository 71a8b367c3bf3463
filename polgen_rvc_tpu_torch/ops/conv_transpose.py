"""The NSF decoder's upsampling ConvTranspose1d, for k - 2*padding == stride
(T_out = T_in * stride).

Replaces polgen_rvc_tpu/ops/pallas_convtranspose.py:conv_transpose1d_pallas.
On a CUDA tensor ``conv_transpose1d`` launches the sm_90a kernel of
csrc/conv_transpose.cu (all four upsample stages of the 48 kHz config:
u = 12, 10, 2, 2); bound and design are in the kernel source. On a CPU
tensor it runs ``conv_transpose1d_plain``. The kernel reads its weights
as ``pack_phase_taps`` lays them out (bf16), made once when the weights
load and passed as ``taps``.

Output sample t = m*u + r needs only inputs m-1, m, m+1, so each phase r is
a 3-tap convolution; ``pack_phase_taps`` gathers the weight taps each
(phase, input offset) pair uses, with zeros where a tap falls outside the
kernel. Working precision: bf16 operands, fp32 accumulation, result in x's
dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build


def conv_transpose1d_plain(x, w, b, *, stride: int, padding: int,
                           operand_dtype=None):
    """Plain PyTorch twin, in fp32; operand_dtype rounds x and w first."""

    def rnd(t):
        return t if operand_dtype is None else t.to(operand_dtype).float()

    y = F.conv_transpose1d(rnd(x.float()), rnd(w.float()),
                           None if b is None else b.float(),
                           stride=stride, padding=padding)
    return y.to(x.dtype)


def pack_phase_taps(w, stride: int, padding: int):
    """(C_in, C_out, k) -> (u, 3, C_out, C_in): P[r, d+1, o, c] =
    w[c, o, r + padding - d*u], zero outside the kernel."""
    k = w.shape[-1]
    r = torch.arange(stride, device=w.device)
    d = torch.arange(-1, 2, device=w.device)
    j = r[:, None] + padding - d[None, :] * stride  # (u, 3)
    valid = (j >= 0) & (j < k)
    taps = w[:, :, j.clamp(0, k - 1)] * valid.to(w.dtype)  # (C_in, C_out, u, 3)
    return taps.permute(2, 3, 1, 0).contiguous()


def conv_transpose1d(x, w, b, *, stride: int, padding: int, taps=None):
    """x: (B, C_in, T) -> (B, C_out, T * stride); w: (C_in, C_out, k).
    On a CUDA tensor ``taps`` must be pack_phase_taps(w in bf16)."""
    k = w.shape[-1]
    if k - 2 * padding != stride:
        raise ValueError(f"conv_transpose1d: k={k}, padding={padding} does "
                         f"not give T_out = T_in * {stride}")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[1] or (
            b is not None and b.shape != (w.shape[1],)):
        raise ValueError(f"conv_transpose1d: input {tuple(x.shape)}, weight "
                         f"{tuple(w.shape)} and bias do not fit")
    if x.device.type == "cpu":
        return conv_transpose1d_plain(x, w, b, stride=stride, padding=padding)
    if x.device.type != "cuda":
        raise ValueError(f"conv_transpose1d: unsupported device {x.device}")
    bsz, c_in, t = x.shape
    c_out = w.shape[1]
    if c_in % 32 or c_out % 32:
        raise ValueError(f"conv_transpose1d: C_in={c_in}, C_out={c_out} must "
                         "be multiples of 32")
    if (taps is None or taps.shape != (stride, 3, c_out, c_in)
            or taps.dtype != torch.bfloat16 or taps.device != x.device
            or not taps.is_contiguous()):
        got = "missing" if taps is None else f"{tuple(taps.shape)} {taps.dtype} on {taps.device}"
        raise ValueError(f"conv_transpose1d: taps are {got}, the kernel takes "
                         f"contiguous ({stride}, 3, {c_out}, {c_in}) bf16 on "
                         f"{x.device} (pack_phase_taps, once at load)")
    if b is not None and (b.dtype != torch.float32 or b.device != x.device
                          or not b.is_contiguous()):
        raise ValueError(f"conv_transpose1d: bias must be contiguous float32 on {x.device}")
    fn = cuda_build.bind("conv_transpose", "conv_transpose_upsample", 4,
                         (ctypes.c_int,) * 5)
    x32 = x.float().contiguous()
    bias = torch.zeros(c_out, device=x.device) if b is None else b
    y = torch.empty(bsz, c_out, t * stride, device=x.device,
                    dtype=torch.float32)
    cuda_build.launch(fn, cuda_build.ptr(x32), cuda_build.ptr(taps),
                      cuda_build.ptr(bias), cuda_build.ptr(y),
                      bsz, c_in, c_out, t, stride)
    conv_transpose1d.launches += 1
    return y.to(x.dtype)


conv_transpose1d.launches = 0
