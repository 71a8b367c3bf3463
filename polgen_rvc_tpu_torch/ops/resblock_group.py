"""One decoder stage's HiFi-GAN ResBlock1 group: the mean over resblocks of

    for each dilation d:  x = x + conv_k(lrelu(conv_{k,d}(lrelu(x))))

with "same" zero padding at [0, T) before every conv.

Replaces polgen_rvc_tpu/ops/pallas_resblock.py:fused_resblock_group and
fused_resblock_group_folded (one function; the time fold was a TPU
matrix-unit trick). On a CUDA tensor ``fused_resblock_group`` launches the
sm_90a kernel of csrc/resblock_group.cu once per conv pair (9 per group at
the 48 kHz config), at every stage width (C = 256, 128, 64, 32). Bound and
design: see the kernel source. On a CPU tensor it runs
``resblock_group_plain``, the same function in plain PyTorch;
``resblock_pair_plain`` is the plain version of one launch.

The kernel reads each conv's weight in its own layout, "w_taps", which
``pack_resblock_weights`` adds once when the weights load; the CUDA path
only checks and launches.

Working precision: bf16 operands (lrelu of the pair's input, the hidden
activation between the two convs, and the weights), fp32 accumulation and
an fp32 residual stream; the result is x's dtype, rounded once.
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


def resblock_pair_plain(src, conv1, conv2, kernel_size: int, dilation: int, *,
                        acc=None, last: bool = False, n_res: int = 1,
                        out_dtype=None, operand_dtype=None,
                        slope: float = LRELU_SLOPE):
    """Plain twin of one kernel launch, one conv pair of a ResBlock1:

        h = rnd(lrelu(conv_{k,d}(rnd(lrelu(src))) + b1))   (zero outside [0, T))
        v = conv_{k,1}(h) + b2 + src

    with rnd the rounding to operand_dtype (None: none). Not last: returns
    v, or acc + v when acc is given (the fp32 residual stream and the
    resblocks' running sum). Last pair of the group: ((acc + v) / n_res),
    or v / n_res without acc, in out_dtype (default src's dtype). Its
    composition over a group's pairs is resblock_group_plain bit for bit."""

    def rnd(t):
        return t if operand_dtype is None else t.to(operand_dtype).float()

    s = src.float()
    t = F.conv1d(rnd(F.leaky_relu(s, slope)), rnd(conv1["w"].float()),
                 conv1["b"].float(), padding=dilation * (kernel_size - 1) // 2,
                 dilation=dilation)
    t = F.conv1d(rnd(F.leaky_relu(t, slope)), rnd(conv2["w"].float()),
                 conv2["b"].float(), padding=(kernel_size - 1) // 2)
    v = s + t
    a = v if acc is None else acc + v
    if not last:
        return a
    return (a / n_res).to(src.dtype if out_dtype is None else out_dtype)


MAX_CHANNELS = 256


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


def _check_width(c):
    if c % 32 or not 32 <= c <= MAX_CHANNELS:
        raise ValueError(f"fused_resblock_group: C={c} is not a multiple of 32 "
                         f"in [32, {MAX_CHANNELS}]")


def resblock_pair(src, conv1, conv2, kernel_size: int, dilation: int, *,
                  acc=None, last: bool = False, n_res: int = 1, out=None,
                  slope: float = LRELU_SLOPE):
    """One launch of the kernel on (B, C, T) CUDA tensors and two packed
    convs: resblock_pair_plain at bf16 operands. src is float32 or bf16;
    acc, when given, float32 (it may be `out`: updated in place). Not
    last: out (float32) = v or acc + v. Last: out (src's dtype unless
    given) = (acc + v) / n_res. out must not be src: blocks read src's
    halo across tile edges. Returns out (allocated when None)."""
    b, c, t = src.shape
    if src.device.type != "cuda":
        raise ValueError(f"resblock_pair: launches on CUDA tensors only, not {src.device}")
    _check_width(c)
    if src.dtype not in (torch.float32, torch.bfloat16) or not src.is_contiguous():
        raise ValueError(f"resblock_pair: src must be contiguous float32 or bf16, "
                         f"not {src.dtype}")
    if kernel_size % 2 != 1 or dilation < 1:
        raise ValueError(f"resblock_pair: k={kernel_size}, d={dilation}: "
                         "'same' padding needs an odd k and d >= 1")
    if out is None:
        out = torch.empty(src.shape, device=src.device,
                          dtype=src.dtype if last else torch.float32)
    out_dtypes = (torch.float32, torch.bfloat16) if last else (torch.float32,)
    for a, dts in ((acc, (torch.float32,)), (out, out_dtypes)):
        if a is not None and (a.shape != src.shape or a.dtype not in dts
                              or a.device != src.device or not a.is_contiguous()):
            raise ValueError("resblock_pair: acc and out must be contiguous "
                             f"{tuple(src.shape)} on {src.device}, acc float32, "
                             "out float32 (or bf16 for the last pair)")
    if out.data_ptr() == src.data_ptr():
        raise ValueError("resblock_pair: out may not be src")
    _check_packed(conv1, c, kernel_size, src.device)
    _check_packed(conv2, c, kernel_size, src.device)
    fn = cuda_build.bind("resblock_group", "resblock_pair", 7,
                         (ctypes.c_int,) * 5 + (ctypes.c_float, ctypes.c_int,
                                                ctypes.c_float, ctypes.c_int,
                                                ctypes.c_int))
    cuda_build.launch(
        fn, cuda_build.ptr(src), cuda_build.ptr(conv1["w_taps"]),
        cuda_build.ptr(conv1["b"]), cuda_build.ptr(conv2["w_taps"]),
        cuda_build.ptr(conv2["b"]),
        cuda_build.ptr(acc) if acc is not None else ctypes.c_void_p(None),
        cuda_build.ptr(out), b, c, t, kernel_size, dilation, slope,
        int(last), float(n_res),
        int(src.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
    )
    fused_resblock_group.launches += 1
    return out


def fused_resblock_group(x, params_list, kernel_sizes, dilations, *,
                         slope: float = LRELU_SLOPE):
    """(B, C, T) -> mean_r resblock_r(x), shape (B, C, T), x's dtype. On a
    CUDA tensor x is float32 or bf16, C a multiple of 32 up to 256, and the
    convs carry "w_taps" (pack_resblock_weights): one launch per conv pair,
    the residual stream and the resblocks' sum in float32 between them."""
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
    _check_width(c)
    x = x.contiguous()
    streams = [torch.empty(x.shape, device=x.device) for _ in range(2)]
    acc = torch.empty(x.shape, device=x.device)
    out = torch.empty_like(x)
    n_res = len(groups)
    for r, pairs in enumerate(groups):
        src = x
        for i, ((p1, k, d), (p2, _, _)) in enumerate(pairs):
            if i < len(pairs) - 1:
                src = resblock_pair(src, p1, p2, k, d, out=streams[i % 2], slope=slope)
            elif r == n_res - 1:
                resblock_pair(src, p1, p2, k, d, acc=acc if r else None, last=True,
                              n_res=n_res, out=out, slope=slope)
            else:
                resblock_pair(src, p1, p2, k, d, acc=acc if r else None, out=acc,
                              slope=slope)
    return out


fused_resblock_group.launches = 0
