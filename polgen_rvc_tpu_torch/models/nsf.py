"""NSF-source HiFi-GAN decoder and the plain HiFi-GAN generator of no-f0
models: the port of polgen_rvc_tpu/models/nsf.py.

Harmonic sine source from F0, per-stage transposed-conv upsampling (the
conv-transpose kernel) with source injection, the mean of each stage's
ResBlock1 stacks (the resblock-group kernel), tanh output. The no-f0
``generator`` is the same stage loop without the source.

A stage whose width is not a multiple of 32 (v1's fifth stage, C = 16) is
zero-padded to the next multiple of 32 when the weights load
(``pack_decoder_weights``), so the kernels take it unchanged: the padded
channels stay exactly zero through lrelu, the convs, the residuals and
the mean, and conv_post's padded input channels have zero weights, so the
output is the unpadded decoder's.

conv_pre runs at a fixed frame length where the caller gives one (the
engine gives its largest bucket's): the row's frames, zero-padded at the
end, then the valid outputs sliced back. The padded frames are zeros, as
is the conv's own padding, so the values are the same; on the card cuDNN
then sees one shape at every bucket and keeps one algorithm, so a chunk
gives the same bytes whichever bucket it rides (it picks its algorithm by
length, and two lengths differed by a bf16 step).

The sine phase is closed-form from a frame-rate cumsum, as in the JAX
package: phase[f*upp + k] = cumsum_frames(frac(upp * rad_f))[f]
+ (k+1) * rad_f[f] (whole-cycle wrap corrections cannot change the sine).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.conv import conv1d
from ..ops.conv_transpose import conv_transpose1d, pack_phase_taps
from ..ops.resblock_group import fused_resblock_group, pack_resblock_weights
from .synthesizer import SynthesizerConfig

LRELU_SLOPE = 0.1


def sine_source(f0, upp: int, sample_rate: int, *, noise=None,
                sine_amp: float = 0.1, noise_std: float = 0.003):
    """(B, T) Hz -> (B, T * upp) sine + gated noise (SineGen, no harmonics).

    noise: (B, >= T*upp) standard normal draws sliced to length, or None."""
    f0 = f0.float()
    rad_f = torch.remainder(f0 / sample_rate, 1.0)
    per_frame = torch.remainder(rad_f * upp, 1.0)
    start = torch.remainder(torch.cumsum(per_frame, dim=-1) - per_frame, 1.0)
    k = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    phase = (start[..., None] + rad_f[..., None] * k).reshape(*f0.shape[:-1], -1)
    sine = torch.sin(2.0 * math.pi * phase) * sine_amp
    uv = (f0 > 0).float().repeat_interleave(upp, dim=-1)
    out = sine * uv
    if noise is not None:
        amp = uv * noise_std + (1.0 - uv) * (sine_amp / 3.0)
        out = out + amp * noise[..., : sine.shape[-1]].float()
    return out


def source_module(params, f0, upp: int, sample_rate: int, *, noise=None,
                  dtype=torch.float32):
    """SourceModuleHnNSF: sine -> tanh(linear)."""
    sine = sine_source(f0, upp, sample_rate, noise=noise).to(dtype)
    w = params["l_linear"]["w"].to(dtype)
    b = params["l_linear"]["b"].to(dtype)
    return torch.tanh(sine * w[0, 0] + b[0])


def _pad_to(t, dim: int, size: int):
    """t zero-padded at the end of dim to size."""
    extra = size - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _pad_conv(conv, out_c: int, in_c: int = None):
    """A conv's {w (C_out, C_in, k), b} zero-padded to out_c (and in_c)."""
    w = _pad_to(conv["w"], 0, out_c)
    if in_c is not None:
        w = _pad_to(w, 1, in_c)
    b = conv.get("b")
    return {**conv, "w": w, "b": None if b is None else _pad_to(b, 0, out_c)}


def pad_decoder_stages(params, cfg: SynthesizerConfig):
    """Every stage whose width is not a multiple of 32 zero-padded to the
    next one: the upsample's C_out (and the next upsample's C_in, or
    conv_post's), the stage's noise conv outputs and its resblock convs
    (in and out, zero biases). The padded channels are exact zeros at every
    point of the decoder, so its output does not change."""
    n_k = len(cfg.resblock_kernel_sizes)
    ups = [dict(up) for up in params["ups"]]
    resblocks = list(params["resblocks"])
    noise = list(params.get("noise_convs", []))
    width = [up["w"].shape[1] for up in ups]
    padded = [-(-c // 32) * 32 for c in width]
    for i, (c, cp) in enumerate(zip(width, padded)):
        if i and padded[i - 1] != width[i - 1]:
            ups[i]["w"] = _pad_to(ups[i]["w"], 0, padded[i - 1])
        if cp == c:
            continue
        ups[i]["w"] = _pad_to(ups[i]["w"], 1, cp)
        ups[i]["b"] = _pad_to(ups[i]["b"], 0, cp)
        if noise:
            noise[i] = _pad_conv(noise[i], cp)
        for j in range(i * n_k, (i + 1) * n_k):
            resblocks[j] = {key: [_pad_conv(cv, cp, cp) for cv in resblocks[j][key]]
                            for key in ("convs1", "convs2")}
    out = {**params, "ups": ups, "resblocks": resblocks,
           "conv_post": _pad_conv(params["conv_post"], params["conv_post"]["w"].shape[0],
                                  padded[-1])}
    if noise:
        out["noise_convs"] = noise
    return out


def pack_decoder_weights(params, cfg: SynthesizerConfig):
    """The decoder's parameters with its stages padded to multiples of 32
    (pad_decoder_stages) and the kernels' weight layouts added, made once
    when the weights load: each upsample gains "w_taps" (pack_phase_taps of
    its bf16 weight), each resblock conv its own (pack_resblock_weights)."""
    params = pad_decoder_stages(params, cfg)
    ups = []
    for up, u, k in zip(params["ups"], cfg.upsample_rates, cfg.upsample_kernel_sizes):
        taps = pack_phase_taps(up["w"].to(torch.bfloat16), int(u), (int(k) - int(u)) // 2)
        ups.append({**up, "w_taps": taps})
    return {**params, "ups": ups,
            "resblocks": pack_resblock_weights(params["resblocks"])}


def generator_nsf(params, cfg: SynthesizerConfig, x, f0, g=None, *, noise=None,
                  frames=None):
    """conv_pre -> per stage [lrelu -> upsample -> + noise_conv(source) ->
    mean(resblocks)] -> lrelu -> conv_post -> tanh.

    x: (B, inter, T); f0: (B, T) Hz; g: (B, gin, 1); frames: the fixed
    length conv_pre runs at (>= T), or None for T. Returns (B, T * upp).
    On the card, params come through pack_decoder_weights."""
    har = source_module(params["m_source"], f0, cfg.upp, cfg.sr, noise=noise,
                        dtype=x.dtype)[:, None, :]
    return _decode(params, cfg, x, g, har, frames)


def generator(params, cfg: SynthesizerConfig, x, g=None, *, frames=None):
    """The plain HiFi-GAN generator of no-f0 models: conv_pre -> per stage
    [lrelu -> upsample -> mean(resblocks)] -> lrelu -> conv_post -> tanh,
    with no source and no noise convs (the JAX package's ``generator``).
    Same kernels, weight packing and conv_pre route as generator_nsf."""
    return _decode(params, cfg, x, g, None, frames)


def conv_pre(conv, x, frames=None):
    """The decoder's conv_pre (k 7, padding 3) on x (B, C, T), run at
    `frames` >= T frames, zero-padded at the end, and sliced back to T."""
    t = x.shape[-1]
    if frames is not None:
        if frames < t:
            raise ValueError(f"conv_pre: {t} frames exceed the fixed length {frames}")
        x = _pad_to(x, 2, frames)
    return conv1d(x, conv["w"], conv["b"], padding=3)[..., :t]


def _decode(params, cfg: SynthesizerConfig, x, g, har, frames=None):
    """The stage loop of both generators; har (B, 1, T * upp) is the NSF
    source, injected through each stage's noise conv, or None."""
    x = conv_pre(params["conv_pre"], x, frames)
    if g is not None:
        x = x + conv1d(g, params["cond"]["w"], params["cond"]["b"])
    n_k = len(cfg.resblock_kernel_sizes)
    kernel_sizes = [int(k) for k in cfg.resblock_kernel_sizes]
    dilations = [tuple(int(d) for d in ds) for ds in cfg.resblock_dilation_sizes]
    rates = [int(r) for r in cfg.upsample_rates]
    for i, (u, k) in enumerate(zip(rates, cfg.upsample_kernel_sizes)):
        stride_f0 = math.prod(rates[i + 1:])
        x = F.leaky_relu(x, LRELU_SLOPE)
        up = params["ups"][i]
        # every RVC config has k - 2 * pad == u (T_out = T_in * u), the
        # form the conv-transpose kernel takes
        x = conv_transpose1d(x, up["w"], up["b"], stride=u,
                             padding=(int(k) - u) // 2, taps=up.get("w_taps"))
        if har is not None:
            nc = params["noise_convs"][i]
            x = x + conv1d(har, nc["w"], nc["b"], stride=stride_f0,
                           padding=stride_f0 // 2 if stride_f0 > 1 else 0)
        x = fused_resblock_group(
            x, params["resblocks"][i * n_k:(i + 1) * n_k], kernel_sizes, dilations
        )
    x = F.leaky_relu(x, 0.01)
    x = conv1d(x, params["conv_post"]["w"], None, padding=3)
    return torch.tanh(x)[:, 0, :]
