"""One decoder stage's HiFi-GAN ResBlock1 group: the mean over resblocks of

    for each dilation d:  x = x + conv_k(lrelu(conv_{k,d}(lrelu(x))))

with "same" zero padding at [0, T) before every conv.

Replaces polgen_rvc_tpu/ops/pallas_resblock.py:fused_resblock_group and
fused_resblock_group_folded (one function; the time fold was a TPU
matrix-unit trick). On a CUDA tensor ``fused_resblock_group`` launches the
sm_90a kernel of csrc/resblock_group.cu once per conv (18 per group at the
48 kHz config), at every stage width (C = 256, 128, 64, 32). Bound and
design: see the kernel source. On a CPU tensor it runs
``resblock_group_plain``, the same function in plain PyTorch.

The kernel reads each conv's weight in its own layout, "w_taps", which
``pack_resblock_weights`` adds once when the weights load; the CUDA path
only checks and launches.

Working precision: bf16 operands (lrelu(x) and the weights), fp32
accumulation, fp32 intermediates; the result is cast back to x's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

LRELU_SLOPE = 0.1


def _convs(params_list, kernel_sizes, dilations):
    """[(resblock, [(conv1 params, k, d), (conv2 params, k, 1)] per pair)]."""
    out = []
    for p, k, dils in zip(params_list, kernel_sizes, dilations):
        out.append([((p["convs1"][i], int(k), int(d)), (p["convs2"][i], int(k), 1))
                    for i, d in enumerate(dils)])
    return out


def pack_resblock_weights(params_list):
    """The resblocks with every conv's kernel layout added: "w_taps", its
    (C, C, k) weight as (k, C_out, C_in) bf16, input channels contiguous.
    Made once when the weights load; the plain twin ignores it."""

    def pack(conv):
        return {**conv, "w_taps": conv["w"].to(torch.bfloat16).permute(2, 0, 1).contiguous()}

    return [{**p, "convs1": [pack(c) for c in p["convs1"]],
             "convs2": [pack(c) for c in p["convs2"]]} for p in params_list]


def resblock_group_plain(x, params_list, kernel_sizes, dilations, *,
                         operand_dtype=None, slope: float = LRELU_SLOPE):
    """Plain PyTorch twin of the kernel, in fp32. operand_dtype (e.g.
    torch.bfloat16) rounds each conv's operands to it first, as the kernel
    does; None keeps them fp32 (the JAX package's XLA path)."""

    def rnd(t):
        return t if operand_dtype is None else t.to(operand_dtype).float()

    x32 = x.float()
    acc = None
    groups = _convs(params_list, kernel_sizes, dilations)
    for pairs in groups:
        cur = x32
        for (p1, k, d), (p2, _, _) in pairs:
            t = F.conv1d(rnd(F.leaky_relu(cur, slope)), rnd(p1["w"].float()),
                         p1["b"].float(), padding=d * (k - 1) // 2, dilation=d)
            t = F.conv1d(rnd(F.leaky_relu(t, slope)), rnd(p2["w"].float()),
                         p2["b"].float(), padding=(k - 1) // 2)
            cur = cur + t
        acc = cur if acc is None else acc + cur
    return (acc / len(groups)).to(x.dtype)


def _check_packed(conv, c, k, device):
    w, b = conv.get("w_taps"), conv["b"]
    if w is None:
        raise ValueError("fused_resblock_group: conv weights are not packed "
                         "(pack_resblock_weights, once at load)")
    if (w.shape != (k, c, c) or w.dtype != torch.bfloat16 or w.device != device
            or not w.is_contiguous() or b.dtype != torch.float32
            or b.device != device or not b.is_contiguous()):
        raise ValueError(f"fused_resblock_group: packed weight {tuple(w.shape)} "
                         f"{w.dtype} / bias {b.dtype} on {w.device} do not fit "
                         f"C={c}, k={k} as bf16 / float32 on {device}")


def resblock_conv(x, conv, kernel_size: int, dilation: int, *, res=None,
                  out=None, mode: int = 0, scale: float = 1.0,
                  slope: float = LRELU_SLOPE):
    """One launch of the kernel, the group's building block, on fp32
    (B, C, T) CUDA tensors and a packed conv:

        v = conv_{k,d}(lrelu(x)) + bias (+ res)
        mode 0: out = v     mode 1: out = v * scale     mode 2: out += v * scale

    Returns out (allocated when None)."""
    b, c, t = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"resblock_conv: launches on CUDA tensors only, not {x.device}")
    if c % 32:
        raise ValueError(f"fused_resblock_group: C={c} is not a multiple of 32")
    for a in (x, res, out):
        if a is not None and (a.shape != x.shape or a.dtype != torch.float32
                              or a.device != x.device or not a.is_contiguous()):
            raise ValueError("resblock_conv: x, res and out must be contiguous "
                             f"float32 {tuple(x.shape)} on {x.device}")
    _check_packed(conv, c, kernel_size, x.device)
    if out is None:
        out = torch.empty_like(x)
    fn = cuda_build.bind("resblock_group", "resblock_conv", 5,
                         (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_int,
                                                ctypes.c_float))
    cuda_build.launch(
        fn, cuda_build.ptr(x), cuda_build.ptr(conv["w_taps"]), cuda_build.ptr(conv["b"]),
        cuda_build.ptr(res) if res is not None else ctypes.c_void_p(None),
        cuda_build.ptr(out), b, c, t, kernel_size, dilation, slope, mode, scale,
    )
    fused_resblock_group.launches += 1
    return out


def fused_resblock_group(x, params_list, kernel_sizes, dilations, *,
                         slope: float = LRELU_SLOPE):
    """(B, C, T) -> mean_r resblock_r(x), shape (B, C, T), x's dtype. On a
    CUDA tensor the convs must carry "w_taps" (pack_resblock_weights)."""
    if x.dim() != 3:
        raise ValueError(f"fused_resblock_group: input {tuple(x.shape)} is not (B, C, T)")
    c = x.shape[1]
    groups = _convs(params_list, kernel_sizes, dilations)
    for pairs in groups:
        for conv_pair in pairs:
            for p, k, _ in conv_pair:
                if p["w"].shape != (c, c, k) or p["b"].shape != (c,):
                    raise ValueError(f"fused_resblock_group: conv weight "
                                     f"{tuple(p['w'].shape)} / bias "
                                     f"{tuple(p['b'].shape)} do not match C={c}, k={k}")
    if x.device.type == "cpu":
        return resblock_group_plain(x, params_list, kernel_sizes, dilations,
                                    slope=slope)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock_group: unsupported device {x.device}")
    x_in = x.float().contiguous()
    cur = torch.empty_like(x_in)
    tmp = torch.empty_like(x_in)
    out = torch.empty_like(x_in)
    n_res = len(groups)
    for r, pairs in enumerate(groups):
        src = x_in
        for i, ((p1, k, d), (p2, _, _)) in enumerate(pairs):
            resblock_conv(src, p1, k, d, out=tmp, slope=slope)
            if i < len(pairs) - 1:
                resblock_conv(tmp, p2, k, 1, res=src, out=cur, slope=slope)
                src = cur
            else:
                resblock_conv(tmp, p2, k, 1, res=src, out=out,
                              mode=1 if r == 0 else 2, scale=1.0 / n_res,
                              slope=slope)
    return out.to(x.dtype)


fused_resblock_group.launches = 0
