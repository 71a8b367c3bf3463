"""The NSF decoder's upsampling ConvTranspose1d, for k - 2*padding == stride
(T_out = T_in * stride).

Replaces polgen_rvc_tpu/ops/pallas_convtranspose.py:conv_transpose1d_pallas.
On a CUDA tensor ``conv_transpose1d`` launches the sm_90a kernel of
csrc/conv_transpose.cu (every upsample stage of the published configs:
u = 12, 10, 8, 6, 4, 2); bound and design are in the kernel source. On a CPU
tensor it runs ``conv_transpose1d_plain``. The kernel reads its weights
as ``pack_phase_taps`` lays them out (bf16), made once when the weights
load and passed as ``taps``.

Output sample t = m*u + r draws on input m + d only for the offsets d of
``phase_taps(u, padding)[r]``: the run floor((r - p)/u) .. floor((r + p)/u),
whose weight taps r + p - d*u lie inside the kernel. Every offset lies
within -H..H for the halo H = ceil(p/u); the kernel stages that halo and
takes H <= 2, which holds every published RVC config (v1 32 kHz's
u = 4, k = 16, p = 6 has H = 2; the rest H = 1). ``pack_phase_taps``
lays out exactly those weight taps, phase by phase, with no zero blocks.
Working precision: bf16 operands, fp32 accumulation and bias, the result
rounded once to x's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.tracing import count
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


MAX_HALO = 2  # the largest halo the kernel stages


def phase_taps(stride: int, padding: int) -> list[list[int]]:
    """For each phase r of the output, the input offsets d (ascending) whose
    weight tap r + padding - d*stride lies inside the kernel (k = stride +
    2*padding): the run floor((r - padding)/stride) .. floor((r +
    padding)/stride)."""
    return [list(range((r - padding) // stride, (r + padding) // stride + 1))
            for r in range(stride)]


def _check_geometry(k: int, stride: int, padding: int):
    if k - 2 * padding != stride:
        raise ValueError(f"conv_transpose1d: k={k}, padding={padding} does "
                         f"not give T_out = T_in * {stride}")
    if not 0 <= padding <= MAX_HALO * stride:
        raise ValueError(f"conv_transpose1d: padding={padding} outside "
                         f"0..{MAX_HALO * stride} (k={k} > {2 * MAX_HALO + 1}"
                         f"*stride) needs taps beyond input offsets "
                         f"-{MAX_HALO}..{MAX_HALO}")


def pack_phase_taps(w, stride: int, padding: int):
    """(C_in, C_out, k) -> (k, C_out, C_in): the taps of phase 0, then
    phase 1, ..., each phase's in the order of phase_taps; block
    [start(r) + i] = w[:, :, r + padding - d_i * stride].T. Every one of the
    k kernel taps appears exactly once."""
    _check_geometry(w.shape[-1], stride, padding)
    j = [r + padding - d * stride
         for r, ds in enumerate(phase_taps(stride, padding)) for d in ds]
    return w[:, :, j].permute(2, 1, 0).contiguous()


def conv_transpose1d(x, w, b, *, stride: int, padding: int, taps=None):
    """x: (B, C_in, T) -> (B, C_out, T * stride) in x's dtype; w: (C_in,
    C_out, k). On a CUDA tensor ``taps`` must be pack_phase_taps(w in
    bf16) and x float32 or bfloat16."""
    k = w.shape[-1]
    _check_geometry(k, stride, padding)
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
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"conv_transpose1d: x is {x.dtype}, the kernel takes "
                         "contiguous float32 or bfloat16")
    if (taps is None or taps.shape != (k, c_out, c_in)
            or taps.dtype != torch.bfloat16 or taps.device != x.device
            or not taps.is_contiguous()):
        got = "missing" if taps is None else f"{tuple(taps.shape)} {taps.dtype} on {taps.device}"
        raise ValueError(f"conv_transpose1d: taps are {got}, the kernel takes "
                         f"contiguous ({k}, {c_out}, {c_in}) bf16 on "
                         f"{x.device} (pack_phase_taps, once at load)")
    if b is not None and (b.dtype != torch.float32 or b.device != x.device
                          or not b.is_contiguous()):
        raise ValueError(f"conv_transpose1d: bias must be contiguous float32 on {x.device}")
    fn = cuda_build.bind("conv_transpose", "conv_transpose_upsample", 4,
                         (ctypes.c_int,) * 7)
    bias = torch.zeros(c_out, device=x.device) if b is None else b
    y = torch.empty(bsz, c_out, t * stride, device=x.device, dtype=x.dtype)
    cuda_build.launch(fn, x.device, cuda_build.ptr(x), cuda_build.ptr(taps),
                      cuda_build.ptr(bias), cuda_build.ptr(y),
                      bsz, c_in, c_out, t, stride, padding,
                      int(x.dtype == torch.bfloat16))
    count("launches.conv_transpose")
    return y
