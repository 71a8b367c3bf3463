"""RMVPE's bidirectional GRU: one input projection, then the recurrence of
both directions in one launch of csrc/gru_scan.cu.

The parameters are torch-layout tensors (w_ih_l0, w_hh_l0, b_ih_l0, b_hh_l0
and the *_reverse set), so the gate order is torch's own (reset, update,
new), the order the JAX package's lax.scan GRU (ops/rnn.py) reproduces.
As there, the input projection of every step is hoisted out of the
recurrence: gx = x @ W_ih_cat + b, both directions in one fp32 product,
with b_ih and the reset and update parts of b_hh folded into b. Then, per
step and direction,

    r  = sigmoid(gx_r + W_hr h)
    z  = sigmoid(gx_z + W_hz h)
    n  = tanh(gx_n + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

the backward direction from t = T - 1 down to 0. On a CUDA tensor ``bigru``
launches the sm_90a kernel once a call (a cluster of 8 CTAs a batch row
and direction; design in the kernel source), on its weights' layouts that
``pack_gru_weights`` makes once when the weights load. On a CPU tensor it
runs ``bigru_plain``, the same arithmetic step by step in torch ops. The
JAX package has no TPU kernel here: the kernel replaces torch.nn.GRU's
per-step cuDNN launches. Everything is fp32, RMVPE's F0 precision.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.tracing import count, spanned
from . import cuda_build

HIDDEN, INPUT = 256, 384  # RMVPE's widths, compile-time in the kernel
_DIRS = ("", "_reverse")


def _folded_bias(params, suffix):
    """b_ih + (b_hr, b_hz, 0): the bias of one direction's input projection."""
    b_hh = params[f"b_hh_l0{suffix}"].float()
    hdim = b_hh.shape[0] // 3
    return params[f"b_ih_l0{suffix}"].float() + torch.cat(
        [b_hh[:2 * hdim], torch.zeros_like(b_hh[2 * hdim:])])


def _projection(params):
    """(W_ih_cat, b): (I, 6H) and (6H,) fp32, forward then backward."""
    w = torch.cat([params[f"w_ih_l0{s}"].float().t() for s in _DIRS], dim=1)
    b = torch.cat([_folded_bias(params, s) for s in _DIRS])
    return w.contiguous(), b.contiguous()


def pack_gru_weights(params):
    """The GRU's parameters with the kernel's layouts added, made once when
    the weights load:

        w_ih_cat  (I, 6H)      [W_ih^T | W_ih_reverse^T]
        b_gx      (6H,)        b_ih + (b_hr, b_hz, 0), forward then backward
        w_hh_units (2, H, 3, H) [d, j, g, k] = W_hh_d[g*H + j, k]: each
                               hidden unit's r, z, n rows side by side
        b_hn      (2, H)       the new gate's b_hh part

    The torch-layout tensors stay beside them; the plain twin reads those."""
    hdim = params["w_hh_l0"].shape[1]
    w_ih_cat, b_gx = _projection(params)
    w_hh = torch.stack([params[f"w_hh_l0{s}"].float().reshape(3, hdim, hdim)
                        .permute(1, 0, 2) for s in _DIRS]).contiguous()
    b_hn = torch.stack([params[f"b_hh_l0{s}"].float()[2 * hdim:] for s in _DIRS])
    return {**params, "w_ih_cat": w_ih_cat, "b_gx": b_gx, "w_hh_units": w_hh,
            "b_hn": b_hn.contiguous()}


def bigru_plain(x, params):
    """The plain twin: (B, T, I) -> (B, T, 2H) in fp32, the kernel's
    arithmetic in torch ops (the projection, then a Python loop over the
    steps with both directions stacked)."""
    b, t_len, _ = x.shape
    hdim = params["w_hh_l0"].shape[1]
    w_ih_cat, b_gx = _projection(params)
    gx = torch.addmm(b_gx, x.float().reshape(b * t_len, -1), w_ih_cat)
    gx = gx.reshape(b, t_len, 2, 3 * hdim).permute(1, 2, 0, 3)  # (T, 2, B, 3H)
    gx = torch.stack([gx[:, 0], gx[:, 1].flip(0)], dim=1)  # backward time-flipped
    w_hh = torch.stack([params[f"w_hh_l0{s}"].float().t() for s in _DIRS])
    b_hn = torch.stack([params[f"b_hh_l0{s}"].float()[2 * hdim:] for s in _DIRS])[:, None]
    h = x.new_zeros((2, b, hdim), dtype=torch.float32)
    hs = x.new_empty((t_len, 2, b, hdim), dtype=torch.float32)
    for s in range(t_len):
        hg = torch.bmm(h, w_hh)  # (2, B, 3H)
        xg = gx[s]
        r = torch.sigmoid(xg[..., :hdim] + hg[..., :hdim])
        z = torch.sigmoid(xg[..., hdim:2 * hdim] + hg[..., hdim:2 * hdim])
        n = torch.tanh(xg[..., 2 * hdim:] + r * (hg[..., 2 * hdim:] + b_hn))
        h = (1.0 - z) * n + z * h
        hs[s] = h
    fwd = hs[:, 0].permute(1, 0, 2)
    bwd = hs[:, 1].flip(0).permute(1, 0, 2)
    return torch.cat([fwd, bwd], dim=-1)


def _check(t, shape, device, what):
    if (t is None or tuple(t.shape) != shape or t.dtype != torch.float32
            or t.device != device or not t.is_contiguous()):
        got = "missing" if t is None else f"{tuple(t.shape)} {t.dtype} on {t.device}"
        raise ValueError(f"bigru: {what} is {got}, the kernel takes contiguous "
                         f"float32 {shape} on {device} (weights: "
                         "pack_gru_weights, once at load)")


def gru_scan(x, params):
    """The kernel's path on a CUDA tensor: the projection (one fp32 matrix
    product), then one launch of the recurrence."""
    if x.dim() != 3:
        raise ValueError(f"bigru: input {tuple(x.shape)} is not (B, T, I)")
    b, t_len, _ = x.shape
    dev = x.device
    _check(x, (b, t_len, INPUT), dev, "x")
    _check(params.get("w_ih_cat"), (INPUT, 6 * HIDDEN), dev, "the packed W_ih")
    _check(params.get("b_gx"), (6 * HIDDEN,), dev, "the folded bias")
    _check(params.get("w_hh_units"), (2, HIDDEN, 3, HIDDEN), dev, "the packed W_hh")
    _check(params.get("b_hn"), (2, HIDDEN), dev, "b_hn")
    return _scan(_project(x, params), params)


def _project(x, params):
    """gx = x @ W_ih_cat + b: (B, T, 6H) fp32, both directions' gates."""
    b, t_len, _ = x.shape
    gx = torch.addmm(params["b_gx"], x.reshape(b * t_len, INPUT), params["w_ih_cat"])
    return gx.view(b, t_len, 6 * HIDDEN)


def _scan(gx, params):
    """The kernel's launch on gx: (B, T, 2H) fp32."""
    b, t_len, _ = gx.shape
    out = torch.empty((b, t_len, 2 * HIDDEN), device=gx.device, dtype=torch.float32)
    fn = cuda_build.bind("gru_scan", "gru_scan", 4, (ctypes.c_int, ctypes.c_int))
    cuda_build.launch(fn, gx.device, cuda_build.ptr(gx),
                      cuda_build.ptr(params["w_hh_units"]), cuda_build.ptr(params["b_hn"]),
                      cuda_build.ptr(out), b, t_len)
    count("launches.gru_scan")
    return out


@spanned("polgen.rmvpe.bigru")
def bigru(x, params: dict):
    """(B, T, I) -> (B, T, 2H): concat(forward, backward) hidden states."""
    if x.device.type == "cpu":
        return bigru_plain(x, params)
    if x.device.type != "cuda":
        raise ValueError(f"bigru: unsupported device {x.device}")
    return gru_scan(x, params)
