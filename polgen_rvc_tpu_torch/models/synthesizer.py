"""RVC v2 VITS synthesizer (inference path) as functions of parameter
dictionaries: the port of polgen_rvc_tpu/models/synthesizer.py.

TextEncoder with windowed relative-position attention (the band-attention
kernel, ops/band_attention.py), conv FFN, the mean-only residual-coupling
flow over a gated dilated WaveNet, speaker conditioning, and the latent
z_p = m_p + exp(logs_p) * eps * noise_scale. Noise is an explicit tensor
(``eps``), never drawn here, so callers decide where it comes from.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops.band_attention import band_attention
from ..ops.conv import conv1d
from ..utils.tracing import span, spanned

WINDOW_SIZE = 10


@dataclasses.dataclass(frozen=True)
class SynthesizerConfig:
    """The 18 positional args stored in RVC .pth checkpoints plus derived
    fields (a copy of the JAX package's dataclass)."""

    spec_channels: int
    segment_size: int
    inter_channels: int
    hidden_channels: int
    filter_channels: int
    n_heads: int
    n_layers: int
    kernel_size: int
    p_dropout: float
    resblock: str
    resblock_kernel_sizes: tuple
    resblock_dilation_sizes: tuple
    upsample_rates: tuple
    upsample_initial_channel: int
    upsample_kernel_sizes: tuple
    spk_embed_dim: int
    gin_channels: int
    sr: int
    use_f0: bool = True
    input_dim: int = 768  # 768 for v2, 256 for v1

    @property
    def upp(self) -> int:
        return int(math.prod(self.upsample_rates))


def layer_norm_channels(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the channel axis of (B, C, T)."""
    mean = x.mean(dim=1, keepdim=True)
    var = x.var(dim=1, keepdim=True, unbiased=False)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * gamma.to(x.dtype)[None, :, None] + beta.to(x.dtype)[None, :, None]


def mask_lengths(x_mask):
    """(B, 1, T) contiguous-prefix mask -> (B,) valid lengths, at least 1."""
    return torch.clamp((x_mask[:, 0, :] > 0).sum(dim=-1), min=1)


def relative_attention(x, params, *, n_heads: int, lengths,
                       window_size: int = WINDOW_SIZE):
    """Windowed relative-position self-attention on (B, C, T); keys at
    t >= lengths[b] are masked, rows there are unspecified."""
    b, c, t = x.shape
    dk = c // n_heads
    q = conv1d(x, params["q"]["w"], params["q"]["b"])
    k = conv1d(x, params["k"]["w"], params["k"]["b"])
    v = conv1d(x, params["v"]["w"], params["v"]["b"])

    def split_heads(y):  # (B, C, T) -> (B*H, T, dk)
        return y.reshape(b, n_heads, dk, t).transpose(2, 3).reshape(
            b * n_heads, t, dk
        )

    q = split_heads(q) * (1.0 / math.sqrt(dk))
    out = band_attention(
        q, split_heads(k), split_heads(v),
        params["emb_rel_k"][0].to(x.dtype), params["emb_rel_v"][0].to(x.dtype),
        lengths.repeat_interleave(n_heads), window_size,
    )
    out = out.reshape(b, n_heads, t, dk).transpose(2, 3).reshape(b, c, t)
    return conv1d(out, params["o"]["w"], params["o"]["b"])


def ffn(x, x_mask, params, *, kernel_size: int, rows=None):
    """Conv feed-forward with same-padding and relu; conv2 runs at `rows`
    rows (ops/conv.py:at_rows)."""
    pad = ((kernel_size - 1) // 2, kernel_size // 2)
    y = conv1d(F.pad(x * x_mask, pad), params["conv1"]["w"], params["conv1"]["b"])
    y = torch.relu(y)
    y = conv1d(F.pad(y * x_mask, pad), params["conv2"]["w"], params["conv2"]["b"],
               rows=rows)
    return y * x_mask


def transformer_encoder(x, x_mask, layers, *, n_heads: int, kernel_size: int,
                        rows=None):
    """Rel-attention + FFN blocks with post-LN residuals."""
    lengths = mask_lengths(x_mask)
    x = x * x_mask
    for lp in layers:
        y = relative_attention(x, lp["attn"], n_heads=n_heads, lengths=lengths)
        x = layer_norm_channels(x + y, lp["norm1"]["gamma"], lp["norm1"]["beta"])
        y = ffn(x, x_mask, lp["ffn"], kernel_size=kernel_size, rows=rows)
        x = layer_norm_channels(x + y, lp["norm2"]["gamma"], lp["norm2"]["beta"])
    return x * x_mask


@spanned("polgen.enc_p")
def text_encoder(params, cfg: SynthesizerConfig, phone, pitch, x_mask, rows=None):
    """enc_p: (B, T, input_dim) features (+ coarse pitch embedding)
    -> (m_p, logs_p), each (B, inter, T); rows: as synthesizer_infer."""
    w = params["emb_phone"]
    x = phone @ w["w"].to(phone.dtype) + w["b"].to(phone.dtype)
    if pitch is not None:
        x = x + params["emb_pitch"].to(x.dtype)[pitch]
    x = x * math.sqrt(cfg.hidden_channels)
    x = F.leaky_relu(x, 0.1).transpose(1, 2)
    x = transformer_encoder(x, x_mask, params["encoder"], n_heads=cfg.n_heads,
                            kernel_size=cfg.kernel_size, rows=rows)
    stats = conv1d(x, params["proj"]["w"], params["proj"]["b"]) * x_mask
    return torch.chunk(stats, 2, dim=1)


def wavenet(x, x_mask, params, g, *, hidden_channels: int, n_layers: int,
            kernel_size: int, rows=None):
    """Gated dilation-1 conv stack with speaker conditioning; the in convs
    run at `rows` rows (ops/conv.py:at_rows)."""
    output = torch.zeros_like(x)
    g_all = conv1d(g, params["cond"]["w"], params["cond"]["b"]) if g is not None else None
    for i in range(n_layers):
        x_in = conv1d(x, params["in"][i]["w"], params["in"][i]["b"],
                      padding=(kernel_size - 1) // 2, rows=rows)
        if g_all is not None:
            x_in = x_in + g_all[:, 2 * hidden_channels * i: 2 * hidden_channels * (i + 1)]
        acts = torch.tanh(x_in[:, :hidden_channels]) * torch.sigmoid(x_in[:, hidden_channels:])
        res_skip = conv1d(acts, params["skip"][i]["w"], params["skip"][i]["b"])
        if i < n_layers - 1:
            x = (x + res_skip[:, :hidden_channels]) * x_mask
            output = output + res_skip[:, hidden_channels:]
        else:
            output = output + res_skip
    return output * x_mask


def _coupling_reverse(x, x_mask, params, g, cfg: SynthesizerConfig, rows=None):
    half = cfg.inter_channels // 2
    x0, x1 = x[:, :half], x[:, half:]
    h = conv1d(x0, params["pre"]["w"], params["pre"]["b"]) * x_mask
    h = wavenet(h, x_mask, params["enc"], g, hidden_channels=cfg.hidden_channels,
                n_layers=3, kernel_size=5, rows=rows)
    m = conv1d(h, params["post"]["w"], params["post"]["b"]) * x_mask
    return torch.cat([x0, (x1 - m) * x_mask], dim=1)


@spanned("polgen.flow")
def flow_reverse(params, cfg: SynthesizerConfig, z_p, x_mask, g, rows=None):
    """ResidualCouplingBlock reverse: 4x (coupling, flip) undone in reverse;
    rows: as synthesizer_infer."""
    x = z_p
    for layer_params in reversed(params):
        x = _coupling_reverse(torch.flip(x, dims=(1,)), x_mask, layer_params, g, cfg,
                              rows)
    return x


def synthesizer_infer(params: dict, cfg: SynthesizerConfig, phone, x_mask,
                      pitch=None, nsff0=None, sid=None, *, eps=None,
                      nsf_noise=None, noise_scale: float = 0.66666,
                      compute_dtype=torch.float32, dec_frames=None, rows=None):
    """Full generator inference.

    phone: (B, T, input_dim) content features (already 2x-upsampled);
    x_mask: (B, 1, T); pitch: (B, T) coarse bins and nsff0: (B, T) Hz (f0
    models; None for no-f0 models, whose decoder is the plain generator);
    sid: (B,) speaker ids (default 0); eps: (B, inter, >= T) latent noise
    and nsf_noise: (B, >= T*upp) source noise, each sliced to length (None =
    noise-free; no-f0 models have no source and ignore nsf_noise);
    dec_frames: the fixed frame length of the decoder's conv_pre (>= T;
    models/nsf.py), or None; rows: the row count of the engine's batch,
    at which the calls whose algorithm the card picks by row count run
    (ops/conv.py:at_rows), or None. Returns (B, T * upp) in compute_dtype.
    """
    from .nsf import generator, generator_nsf  # nsf imports SynthesizerConfig from here

    phone = phone.to(compute_dtype)
    x_mask = x_mask.to(compute_dtype)
    if sid is None:
        sid = torch.zeros(phone.shape[0], dtype=torch.long, device=phone.device)
    g = params["emb_g"].to(compute_dtype)[sid][:, :, None]
    m_p, logs_p = text_encoder(params["enc_p"], cfg, phone, pitch, x_mask, rows)

    # the latent stays fp32 whatever the compute dtype (exp(logs) * noise in
    # bf16 costs ~2.4 dB mel distortion in the JAX package's measurements)
    m32, logs32 = m_p.float(), logs_p.float()
    t = m_p.shape[-1]
    z_p = m32
    if eps is not None:
        z_p = m32 + torch.exp(logs32) * eps[..., :t].float() * noise_scale
    z_p = z_p * x_mask.float()
    z = flow_reverse(params["flow"], cfg, z_p.to(compute_dtype), x_mask, g, rows)
    z = z * x_mask
    with span("polgen.decoder"):
        if not cfg.use_f0:
            return generator(params["dec"], cfg, z, g, frames=dec_frames)
        return generator_nsf(params["dec"], cfg, z, nsff0, g, noise=nsf_noise,
                             frames=dec_frames)
