"""The reference's products and convolutions, in float32 with TF32 off.

``Ops(None)`` computes them in full float32, but for the operands a
configuration states in another precision: ``unet="bfloat16"`` rounds
the operands of RMVPE's U-Net 3x3 convs and 1x1 shortcut weights to
bf16 before the float32 product, as the configuration states for that
layer (the port's K5 and the JAX package's Pallas kernel take bf16
operands with fp32 accumulation).

``Ops("fp8")`` first rounds both operands of every product to float8
e4m3 against the tensor's own absolute maximum (per-tensor scale, as fp8
inference scales them): the control, the reference one precision step
below the bf16 the configurations run their models in.

``Ops("bf16_decode")`` keeps every product as stated and rounds the
operands of the F0 decode to bf16 (CREPE's Viterbi observations and the
salience weights of its cents average): the control of the decode, one
step below the float32 it runs in."""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(t):
    """t rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = torch.clamp(t.abs().amax().float(), min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def bf16_round(t):
    return t.to(torch.bfloat16).float()


def _same(t):
    return t


class Ops:
    def __init__(self, operand=None, unet=None):
        if operand not in (None, "fp8", "bf16_decode") or unet not in (None, "float32", "bfloat16"):
            raise ValueError(f"unknown operand rounding {operand!r}, {unet!r}")
        self.q = fp8_round if operand == "fp8" else _same
        self.q_unet = (fp8_round if operand == "fp8"
                       else bf16_round if unet == "bfloat16" else _same)
        self.q_decode = bf16_round if operand == "bf16_decode" else _same

    def unet_conv2d(self, x, w, b=None, *, round_input=True, **kw):
        """A U-Net conv at the layer's stated operand precision; a shortcut
        reads its input at full precision (round_input False)."""
        return F.conv2d(self.q_unet(x) if round_input else x, self.q_unet(w), b, **kw)

    def conv1d(self, x, w, b=None, **kw):
        return F.conv1d(self.q(x), self.q(w), b, **kw)

    def conv_transpose1d(self, x, w, b=None, **kw):
        return F.conv_transpose1d(self.q(x), self.q(w), b, **kw)

    def linear(self, x, w, b=None):
        """x @ w.T + b with w in torch's (out, in) layout."""
        return F.linear(self.q(x), self.q(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def full_precision():
    """Pin float32 products and convolutions to full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
