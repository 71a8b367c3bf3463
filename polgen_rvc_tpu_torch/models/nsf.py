"""NSF-source HiFi-GAN decoder: the port of polgen_rvc_tpu/models/nsf.py.

Harmonic sine source from F0, per-stage transposed-conv upsampling (the
conv-transpose kernel) with source injection, the mean of each stage's
ResBlock1 stacks (the resblock-group kernel), tanh output.

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


def pack_decoder_weights(params, cfg: SynthesizerConfig):
    """The decoder's parameters with the kernels' weight layouts added, made
    once when the weights load: each upsample gains "w_taps"
    (pack_phase_taps of its bf16 weight), each resblock conv its own
    (pack_resblock_weights)."""
    ups = []
    for up, u, k in zip(params["ups"], cfg.upsample_rates, cfg.upsample_kernel_sizes):
        taps = pack_phase_taps(up["w"].to(torch.bfloat16), int(u), (int(k) - int(u)) // 2)
        ups.append({**up, "w_taps": taps})
    return {**params, "ups": ups,
            "resblocks": pack_resblock_weights(params["resblocks"])}


def generator_nsf(params, cfg: SynthesizerConfig, x, f0, g=None, *, noise=None):
    """conv_pre -> per stage [lrelu -> upsample -> + noise_conv(source) ->
    mean(resblocks)] -> lrelu -> conv_post -> tanh.

    x: (B, inter, T); f0: (B, T) Hz; g: (B, gin, 1). Returns (B, T * upp).
    On the card, params come through pack_decoder_weights."""
    har = source_module(params["m_source"], f0, cfg.upp, cfg.sr, noise=noise,
                        dtype=x.dtype)[:, None, :]
    x = conv1d(x, params["conv_pre"]["w"], params["conv_pre"]["b"], padding=3)
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
        nc = params["noise_convs"][i]
        x = x + conv1d(har, nc["w"], nc["b"], stride=stride_f0,
                       padding=stride_f0 // 2 if stride_f0 > 1 else 0)
        x = fused_resblock_group(
            x, params["resblocks"][i * n_k:(i + 1) * n_k], kernel_sizes, dilations
        )
    x = F.leaky_relu(x, 0.01)
    x = conv1d(x, params["conv_post"]["w"], None, padding=3)
    return torch.tanh(x)[:, 0, :]
