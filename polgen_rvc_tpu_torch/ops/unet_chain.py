"""One RMVPE U-Net level's ConvBlockRes chain over (B, C, T, W):

    for each block:  x = relu(conv3x3(relu(conv3x3(x)))) + shortcut(x)

with "same" zero padding, BatchNorm folded into the convs, and the 1x1
shortcut only where a block changes the channel count.

Replaces polgen_rvc_tpu/ops/pallas_unet2d.py:fused_convblock_chain_folded
(its mel-axis fold was a TPU matrix-unit trick and is not reproduced). On a
CUDA tensor ``convblock_chain`` launches the sm_90a kernel of
csrc/unet_chain.cu twice per block, at every U-Net level (C = 16..512,
W = 128..4); bound and design are in the kernel source. On a CPU tensor it
runs ``convblock_chain_plain``; ``unet_conv3x3_plain`` is the plain version
of one launch. The kernel reads its weights in its own layout, which
``pack_unet_weights`` adds once when the weights load.

Working precision: bf16 operands (the 1x1 shortcut's input stays at full
precision, as in the TPU kernel), fp32 accumulation. Between launches h,
a block's hidden activation, is bf16 (the operand the next conv rounds it
to anyway) and each block's output fp32; the chain reads x in its own
dtype and its last launch writes x's dtype, with no cast pass.
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


def unet_conv3x3_plain(src, conv, *, res=None, shortcut=None,
                       out_dtype=torch.float32):
    """Plain twin of one kernel launch:

        out = relu(conv3x3(rnd(src), rnd(w)) + b)  (+ res, or + the 1x1
              shortcut rnd(W_sc) . res + b_sc of the block input res)

    rnd rounds to bf16; res is read at full precision; the result is
    rounded once to out_dtype. Per block, conv1 with out_dtype bf16 and
    conv2 with res = the block input (fp32, or x's dtype for the last
    block) compose to convblock_chain_plain(..., operand_dtype=bf16) bit
    for bit."""

    def rnd(t):
        return t.to(torch.bfloat16).float()

    y = F.relu(F.conv2d(rnd(src.float()), rnd(conv["w"].float()),
                        conv["b"].float(), padding=1))
    if shortcut is not None:
        y = y + F.conv2d(res.float(), rnd(shortcut["w"].float()),
                         shortcut["b"].float())
    elif res is not None:
        y = y + res.float()
    return y.to(out_dtype)


def padded_channels(c_in, c_out):
    """C_in rounded up to the kernel's channel chunk: 32 for a conv with
    C_out a multiple of 32 from 64 up, else 16 (C_in = 1 becomes 16)."""
    kc = 32 if c_out % 32 == 0 and c_out >= 64 else 16
    return c_in + (-c_in % kc)


def pack_taps_3x3(w):
    """(C_out, C_in, 3, 3) -> (9, C_out, padded_channels(C_in, C_out)):
    tap dt*3 + dw, zero channels added (the kernel stages a chunk of 16 or
    32 input channels at a time)."""
    c_out, c_in = w.shape[:2]
    taps = w.permute(2, 3, 0, 1).reshape(9, c_out, c_in)
    return F.pad(taps, (0, padded_channels(c_in, c_out) - c_in)).contiguous()


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


_FLOATS = (torch.float32, torch.bfloat16)


def _check(t, shape, dtypes, device, what):
    if (t is None or t.shape != shape or t.dtype not in dtypes or t.device != device
            or not t.is_contiguous() or t.data_ptr() % 16):
        got = "missing" if t is None else f"{tuple(t.shape)} {t.dtype} on {t.device}"
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise ValueError(f"convblock_chain: {what} is {got}, the kernel takes "
                         f"contiguous, 16-byte aligned {shape} {names} on {device} "
                         "(weights: pack_unet_weights, once at load)")


def _check_geometry(c_out, w):
    if c_out % 16 or c_out < 16:
        raise ValueError(f"convblock_chain: C_out={c_out} is not a multiple of 16")
    if not 4 <= w <= 128 or 128 % w:
        raise ValueError(f"convblock_chain: W={w} must divide 128, from 4 up")


def unet_conv3x3_tile(c_out, w):
    """The kernel's tile at (C_out, W), from the kernel itself:
    {"bm": output channels, "n": positions, "tt": frames, "kc": input
    channels a chunk} of one block (CUDA only: it loads the library)."""
    _check_geometry(c_out, w)
    out = (ctypes.c_int * 4)()
    fn = cuda_build.load("unet_chain").unet_conv3x3_tile
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(c_out, w, ctypes.cast(out, ctypes.c_void_p)) != 0:
        raise ValueError(f"unet_conv3x3_tile: C_out={c_out}, W={w} refused")
    return dict(zip(("bm", "n", "tt", "kc"), out))


def unet_conv3x3(src, conv, *, res=None, shortcut=None, out_dtype=torch.float32):
    """One launch of the kernel on (B, C_in, T, W) CUDA tensors and a packed
    conv: unet_conv3x3_plain. src and res are fp32 or bf16; returns a new
    tensor in out_dtype (fp32 or bf16)."""
    if src.device.type != "cuda":
        raise ValueError(f"unet_conv3x3: launches on CUDA tensors only, not {src.device}")
    if src.dim() != 4:
        raise ValueError(f"unet_conv3x3: input {tuple(src.shape)} is not (B, C, T, W)")
    b, c_in, t, w = src.shape
    c_out = conv["w"].shape[0]
    _check_geometry(c_out, w)
    dev, f32 = src.device, torch.float32
    _check(src, (b, c_in, t, w), _FLOATS, dev, "x")
    _check(conv.get("w_taps"), (9, c_out, padded_channels(c_in, c_out)),
           (torch.bfloat16,), dev, "the packed 3x3 weight")
    _check(conv["b"], (c_out,), (f32,), dev, "the bias")
    c_res = 0
    if shortcut is not None:
        if res is None:
            raise ValueError("unet_conv3x3: a shortcut needs its block input as res")
        c_res = res.shape[1]
        _check(shortcut.get("w_mat"), (c_out, c_res), (f32,), dev, "the packed shortcut")
        _check(shortcut["b"], (c_out,), (f32,), dev, "the shortcut bias")
    if res is not None:
        _check(res, (b, c_res or c_out, t, w), _FLOATS, dev, "the residual")
    if out_dtype not in _FLOATS:
        raise ValueError(f"unet_conv3x3: out_dtype {out_dtype} is not float32 or bfloat16")
    out = torch.empty(b, c_out, t, w, device=dev, dtype=out_dtype)
    null = ctypes.c_void_p(None)
    fn = cuda_build.bind("unet_chain", "unet_conv3x3", 7, (ctypes.c_int,) * 10)
    cuda_build.launch(
        fn, cuda_build.ptr(src), cuda_build.ptr(conv["w_taps"]), cuda_build.ptr(conv["b"]),
        null if res is None else cuda_build.ptr(res),
        null if shortcut is None else cuda_build.ptr(shortcut["w_mat"]),
        null if shortcut is None else cuda_build.ptr(shortcut["b"]),
        cuda_build.ptr(out), b, c_in, conv["w_taps"].shape[-1], c_out, c_res, t, w,
        int(src.dtype == torch.bfloat16),
        int(res is not None and res.dtype == torch.bfloat16),
        int(out.dtype == torch.bfloat16),
    )
    convblock_chain.launches += 1
    return out


def convblock_chain(x, blocks):
    """(B, C_in, T, W) -> (B, C_out, T, W) in x's dtype. On a CUDA tensor x
    is fp32 or bf16 and the blocks carry their packed weights
    (pack_unet_weights): two launches a block, h in bf16 and each block's
    output in fp32 between them."""
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
    cur = x.contiguous()
    for i, blk in enumerate(blocks):
        h = unet_conv3x3(cur, blk["conv1"], out_dtype=torch.bfloat16)
        cur = unet_conv3x3(h, blk["conv2"], res=cur, shortcut=blk.get("shortcut"),
                           out_dtype=x.dtype if i == len(blocks) - 1 else torch.float32)
    return cur


convblock_chain.launches = 0
