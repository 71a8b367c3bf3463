"""One RMVPE U-Net level's ConvBlockRes chain over (B, C, T, W):

    for each block:  x = relu(conv3x3(relu(conv3x3(x)))) + shortcut(x)

with "same" zero padding, BatchNorm folded into the convs, and the 1x1
shortcut only where a block changes the channel count.

Replaces polgen_rvc_tpu/ops/pallas_unet2d.py:fused_convblock_chain_folded
(its mel-axis fold was a TPU matrix-unit trick and is not reproduced). On a
CUDA tensor ``convblock_chain`` launches the sm_90a kernel of
csrc/unet_chain.cu twice per block, at every U-Net level (C = 16..512,
W = 128..4); bound and design are in the kernel source. On a CPU tensor it
runs ``convblock_chain_plain``. The kernel reads its weights in its own
layout, which ``pack_unet_weights`` adds once when the weights load.

Working precision: bf16 operands (the 1x1 shortcut's input stays fp32, as
in the TPU kernel), fp32 accumulation and residuals, result in x's dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build


def convblock_chain_plain(x, blocks, *, operand_dtype=None):
    """Plain PyTorch twin, in fp32; operand_dtype rounds each 3x3 conv's
    operands and the shortcut weights first, as the kernel does."""

    def rnd(t):
        return t if operand_dtype is None else t.to(operand_dtype).float()

    h = x.float()
    for blk in blocks:
        c1, c2 = blk["conv1"], blk["conv2"]
        y = F.relu(F.conv2d(rnd(h), rnd(c1["w"].float()), c1["b"].float(),
                            padding=1))
        y = F.relu(F.conv2d(rnd(y), rnd(c2["w"].float()), c2["b"].float(),
                            padding=1))
        if "shortcut" in blk:
            sc = blk["shortcut"]
            h = F.conv2d(h, rnd(sc["w"].float()), sc["b"].float())
        h = y + h
    return h.to(x.dtype)


def pack_taps_3x3(w):
    """(C_out, C_in, 3, 3) -> (9, C_out, C_in rounded up to 32): tap
    dt*3 + dw, zero channels added (the kernel stages 32 at a time)."""
    c_out, c_in = w.shape[:2]
    taps = w.permute(2, 3, 0, 1).reshape(9, c_out, c_in)
    return F.pad(taps, (0, -c_in % 32)).contiguous()


def pack_unet_weights(blocks):
    """The blocks with the kernel's layouts added, made once when the
    weights load: each 3x3 conv gains "w_taps" (pack_taps_3x3 of its bf16
    weight), a 1x1 shortcut gains "w_mat", its (C_out, C_in) weight
    rounded to bf16 and held in fp32. The plain twin ignores both."""
    out = []
    for blk in blocks:
        new = {**blk}
        for name in ("conv1", "conv2"):
            new[name] = {**blk[name],
                         "w_taps": pack_taps_3x3(blk[name]["w"].to(torch.bfloat16))}
        if "shortcut" in blk:
            sc = blk["shortcut"]
            new["shortcut"] = {**sc, "w_mat": sc["w"].reshape(sc["w"].shape[0], -1)
                               .to(torch.bfloat16).float().contiguous()}
        out.append(new)
    return out


def _check(t, shape, dtype, device, what):
    if (t is None or t.shape != shape or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        got = "missing" if t is None else f"{tuple(t.shape)} {t.dtype} on {t.device}"
        raise ValueError(f"convblock_chain: {what} is {got}, the kernel takes "
                         f"contiguous {shape} {dtype} on {device} "
                         "(pack_unet_weights, once at load)")


def unet_conv3x3(x, conv, *, res=None, shortcut=None, out=None):
    """One launch of the kernel on fp32 (B, C_in, T, W) CUDA tensors and a
    packed conv: out = relu(conv3x3(x) + bias) (+ res, or + the 1x1
    shortcut of the (B, C_res, T, W) block input res). Returns out."""
    if x.device.type != "cuda":
        raise ValueError(f"unet_conv3x3: launches on CUDA tensors only, not {x.device}")
    b, c_in, t, w = x.shape
    c_out = conv["w"].shape[0]
    if c_out % 16:
        raise ValueError(f"convblock_chain: C_out={c_out} is not a multiple of 16")
    if w > 128 or 128 % w:
        raise ValueError(f"convblock_chain: W={w} must divide 128")
    dev, f32 = x.device, torch.float32
    _check(x, (b, c_in, t, w), f32, dev, "x")
    _check(conv.get("w_taps"), (9, c_out, c_in + (-c_in % 32)), torch.bfloat16,
           dev, "the packed 3x3 weight")
    _check(conv["b"], (c_out,), f32, dev, "the bias")
    c_res = 0
    if shortcut is not None:
        c_res = res.shape[1]
        _check(shortcut.get("w_mat"), (c_out, c_res), f32, dev, "the packed shortcut")
        _check(shortcut["b"], (c_out,), f32, dev, "the shortcut bias")
    if res is not None:
        _check(res, (b, c_res or c_out, t, w), f32, dev, "the residual")
    if out is None:
        out = torch.empty(b, c_out, t, w, device=dev, dtype=f32)
    _check(out, (b, c_out, t, w), f32, dev, "out")
    null = ctypes.c_void_p(None)
    fn = cuda_build.bind("unet_chain", "unet_conv3x3", 7, (ctypes.c_int,) * 7)
    cuda_build.launch(
        fn, cuda_build.ptr(x), cuda_build.ptr(conv["w_taps"]), cuda_build.ptr(conv["b"]),
        null if res is None else cuda_build.ptr(res),
        null if shortcut is None else cuda_build.ptr(shortcut["w_mat"]),
        null if shortcut is None else cuda_build.ptr(shortcut["b"]),
        cuda_build.ptr(out), b, c_in, conv["w_taps"].shape[-1], c_out, c_res, t, w,
    )
    convblock_chain.launches += 1
    return out


def convblock_chain(x, blocks):
    """(B, C_in, T, W) -> (B, C_out, T, W) in x's dtype. On a CUDA tensor
    the blocks must carry their packed weights (pack_unet_weights)."""
    if x.dim() != 4:
        raise ValueError(f"convblock_chain: input {tuple(x.shape)} is not (B, C, T, W)")
    c = x.shape[1]
    for blk in blocks:
        c_out = blk["conv1"]["w"].shape[0]
        shapes = {"conv1": (c_out, c, 3, 3), "conv2": (c_out, c_out, 3, 3)}
        if "shortcut" in blk or c != c_out:
            shapes["shortcut"] = (c_out, c, 1, 1)
        for name, shape in shapes.items():
            p = blk.get(name)
            if p is None or p["w"].shape != shape or p["b"].shape != (c_out,):
                raise ValueError(f"convblock_chain: {name} does not fit "
                                 f"C_in={c}, C_out={c_out}")
        c = c_out
    if x.device.type == "cpu":
        return convblock_chain_plain(x, blocks)
    if x.device.type != "cuda":
        raise ValueError(f"convblock_chain: unsupported device {x.device}")
    h = x.float().contiguous()
    for blk in blocks:
        y = unet_conv3x3(h, blk["conv1"])
        h = unet_conv3x3(y, blk["conv2"], res=h, shortcut=blk.get("shortcut"))
    return h.to(x.dtype)


convblock_chain.launches = 0
