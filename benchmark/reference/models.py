"""HuBERT, the top-k retrieval blend and the RVC synthesizer (enc_p, the
flow, the NSF HiFi-GAN decoder) of the reference, on one chunk at its own
length, from the raw fairseq and RVC state dicts. Weight norm is folded
here (w = g v / |v|); nothing the port made is read."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def fold_wn(sd, prefix, dim: int = 0):
    """A weight-normed tensor's weight: g * v / |v| over every axis but dim."""
    g, v = sd[f"{prefix}.weight_g"].double(), sd[f"{prefix}.weight_v"].double()
    axes = tuple(i for i in range(v.dim()) if i != dim)
    return (g * v / v.square().sum(dim=axes, keepdim=True).sqrt()).float()


# --------------------------------------------------------------------------
# HuBERT (fairseq base layout, post-LN layers)
# --------------------------------------------------------------------------

def hubert(sd, cfg: dict, wav, ops, output_layer: int, final_proj: bool):
    """(L,) samples -> (frames, width) features of layer output_layer."""
    x = wav[None, None]
    for i, (dim, _, stride) in enumerate(cfg["conv_layers"]):
        x = ops.conv1d(x, sd[f"feature_extractor.conv_layers.{i}.0.weight"], stride=stride)
        if i == 0:
            x = F.group_norm(x, dim, sd["feature_extractor.conv_layers.0.2.weight"],
                             sd["feature_extractor.conv_layers.0.2.bias"], eps=1e-5)
        x = F.gelu(x)
    x = x[0].T
    x = F.layer_norm(x, (x.shape[-1],), sd["layer_norm.weight"], sd["layer_norm.bias"])
    x = ops.linear(x, sd["post_extract_proj.weight"], sd["post_extract_proj.bias"])
    kernel = cfg["pos_conv_kernel"]
    pos = ops.conv1d(x.T[None], fold_wn(sd, "encoder.pos_conv.0", dim=2),
                     sd["encoder.pos_conv.0.bias"], padding=kernel // 2,
                     groups=cfg["pos_conv_groups"])
    if kernel % 2 == 0:
        pos = pos[..., :-1]
    x = x + F.gelu(pos[0].T)
    d = x.shape[-1]
    x = F.layer_norm(x, (d,), sd["encoder.layer_norm.weight"], sd["encoder.layer_norm.bias"])
    heads = cfg["n_heads"]
    dk = d // heads
    for li in range(output_layer):
        p = f"encoder.layers.{li}"

        def lin(name, y):
            return ops.linear(y, sd[f"{p}.{name}.weight"], sd[f"{p}.{name}.bias"])

        q = lin("self_attn.q_proj", x).view(-1, heads, dk).transpose(0, 1)
        k = lin("self_attn.k_proj", x).view(-1, heads, dk).transpose(0, 1)
        v = lin("self_attn.v_proj", x).view(-1, heads, dk).transpose(0, 1)
        att = torch.softmax(ops.matmul(q / math.sqrt(dk), k.transpose(1, 2)), dim=-1)
        y = ops.matmul(att, v).transpose(0, 1).reshape(-1, d)
        x = F.layer_norm(x + lin("self_attn.out_proj", y), (d,),
                         sd[f"{p}.self_attn_layer_norm.weight"],
                         sd[f"{p}.self_attn_layer_norm.bias"])
        y = lin("fc2", F.gelu(lin("fc1", x)))
        x = F.layer_norm(x + y, (d,), sd[f"{p}.final_layer_norm.weight"],
                         sd[f"{p}.final_layer_norm.bias"])
    if final_proj:
        x = ops.linear(x, sd["final_proj.weight"], sd["final_proj.bias"])
    return x


def retrieval_blend(feats, bank, index_rate: float, k: int = 8):
    """Each frame blended with its k nearest bank vectors (squared L2),
    weighted 1/d^2 of the squared distance d, normalized; float32."""
    d2 = (feats * feats).sum(-1, keepdim=True) - 2.0 * feats @ bank.T \
        + (bank * bank).sum(-1)[None, :]
    neg, idx = torch.topk(-d2, k, dim=-1)
    d2k = torch.clamp(-neg, min=1e-12)
    w = 1.0 / (d2k * d2k)
    w = w / w.sum(-1, keepdim=True)
    retrieved = torch.einsum("tk,tkd->td", w, bank[idx])
    return index_rate * retrieved + (1.0 - index_rate) * feats


# --------------------------------------------------------------------------
# the synthesizer: enc_p, flow, NSF decoder
# --------------------------------------------------------------------------

def _ln_channels(x, gamma, beta):
    return F.layer_norm(x.transpose(1, 2), (x.shape[1],), gamma, beta, 1e-5).transpose(1, 2)


def _rel_attention(x, sd, a, heads: int, ops, window: int = 10):
    """VITS windowed relative-position attention on (1, C, T), dense."""
    _, c, t = x.shape
    dk = c // heads

    def conv(name, y):
        return ops.conv1d(y, sd[f"{a}.{name}.weight"], sd[f"{a}.{name}.bias"])

    def split(y):
        return y.view(heads, dk, t).transpose(1, 2)

    q = split(conv("conv_q", x)) / math.sqrt(dk)
    k, v = split(conv("conv_k", x)), split(conv("conv_v", x))
    rel_k, rel_v = sd[f"{a}.emb_rel_k"][0], sd[f"{a}.emb_rel_v"][0]
    pos = torch.arange(t, device=x.device)
    off = pos[None, :] - pos[:, None] + window
    in_band = (off >= 0) & (off <= 2 * window)
    s = ops.matmul(q, k.transpose(1, 2))
    s = s + torch.gather(ops.matmul(q, rel_k.T), 2,
                         off.clamp(0, 2 * window).expand(heads, t, t)) * in_band
    p = torch.softmax(s, dim=-1)
    out = ops.matmul(p, v)
    cols = pos[:, None] + torch.arange(-window, window + 1, device=x.device)[None, :]
    ok = (cols >= 0) & (cols < t)
    pb = torch.gather(p, 2, cols.clamp(0, t - 1).expand(heads, t, 2 * window + 1)) * ok
    out = out + ops.matmul(pb, rel_v)
    return conv("conv_o", out.transpose(1, 2).reshape(1, c, t))


def text_encoder(sd, cfg: list, phone, pitch, ops):
    """(T, content) features and coarse pitch -> (m_p, logs_p), (1, inter, T)."""
    hidden, heads, layers, kernel = cfg[3], cfg[5], cfg[6], cfg[7]
    x = ops.linear(phone, sd["enc_p.emb_phone.weight"], sd["enc_p.emb_phone.bias"])
    if pitch is not None:
        x = x + sd["enc_p.emb_pitch.weight"][pitch]
    x = F.leaky_relu(x * math.sqrt(hidden), 0.1).T[None]
    pad = ((kernel - 1) // 2, kernel // 2)
    for i in range(layers):
        y = _rel_attention(x, sd, f"enc_p.encoder.attn_layers.{i}", heads, ops)
        x = _ln_channels(x + y, sd[f"enc_p.encoder.norm_layers_1.{i}.gamma"],
                         sd[f"enc_p.encoder.norm_layers_1.{i}.beta"])
        f = f"enc_p.encoder.ffn_layers.{i}"
        y = torch.relu(ops.conv1d(F.pad(x, pad), sd[f"{f}.conv_1.weight"],
                                  sd[f"{f}.conv_1.bias"]))
        y = ops.conv1d(F.pad(y, pad), sd[f"{f}.conv_2.weight"], sd[f"{f}.conv_2.bias"])
        x = _ln_channels(x + y, sd[f"enc_p.encoder.norm_layers_2.{i}.gamma"],
                         sd[f"enc_p.encoder.norm_layers_2.{i}.beta"])
    stats = ops.conv1d(x, sd["enc_p.proj.weight"], sd["enc_p.proj.bias"])
    return torch.chunk(stats, 2, dim=1)


def _wavenet(x, sd, p, g, hidden: int, ops, n_layers: int = 3):
    out = torch.zeros_like(x)
    g_all = ops.conv1d(g, fold_wn(sd, f"{p}.cond_layer"), sd[f"{p}.cond_layer.bias"])
    for i in range(n_layers):
        x_in = ops.conv1d(x, fold_wn(sd, f"{p}.in_layers.{i}"), sd[f"{p}.in_layers.{i}.bias"],
                          padding=2)
        x_in = x_in + g_all[:, 2 * hidden * i: 2 * hidden * (i + 1)]
        acts = torch.tanh(x_in[:, :hidden]) * torch.sigmoid(x_in[:, hidden:])
        rs = ops.conv1d(acts, fold_wn(sd, f"{p}.res_skip_layers.{i}"),
                        sd[f"{p}.res_skip_layers.{i}.bias"])
        if i < n_layers - 1:
            x = x + rs[:, :hidden]
            out = out + rs[:, hidden:]
        else:
            out = out + rs
    return out


def flow_reverse(sd, cfg: list, z, g, ops):
    """The residual-coupling flow undone: (flip, coupling) x 4, last first."""
    inter, hidden = cfg[2], cfg[3]
    half = inter // 2
    for j in reversed(range(4)):
        p = f"flow.flows.{2 * j}"
        z = torch.flip(z, dims=(1,))
        x0, x1 = z[:, :half], z[:, half:]
        h = ops.conv1d(x0, sd[f"{p}.pre.weight"], sd[f"{p}.pre.bias"])
        h = _wavenet(h, sd, f"{p}.enc", g, hidden, ops)
        m = ops.conv1d(h, sd[f"{p}.post.weight"], sd[f"{p}.post.bias"])
        z = torch.cat([x0, x1 - m], dim=1)
    return z


def sine_source(f0, upp: int, sr: int, noise, sine_amp=0.1, noise_std=0.003):
    """(T,) Hz -> (T * upp,) sine (closed-form phase from a frame cumsum)
    plus gated noise: SineGen with no harmonics."""
    rad = torch.remainder(f0 / sr, 1.0)
    per_frame = torch.remainder(rad * upp, 1.0)
    start = torch.remainder(torch.cumsum(per_frame, 0) - per_frame, 1.0)
    k = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    phase = (start[:, None] + rad[:, None] * k).reshape(-1)
    uv = (f0 > 0).float().repeat_interleave(upp)
    sine = torch.sin(2.0 * math.pi * phase) * sine_amp * uv
    amp = uv * noise_std + (1.0 - uv) * (sine_amp / 3.0)
    return sine + amp * noise[:sine.shape[0]]


def decoder(sd, cfg: list, z, f0, g, nsf_noise, ops):
    """GeneratorNSF (or, without f0, the plain generator): (1, inter, T)
    -> (T * upp,) audio."""
    res_k, res_d, up_rates, up_k, sr = cfg[10], cfg[11], cfg[12], cfg[14], cfg[17]
    upp = math.prod(up_rates)
    har = None
    if f0 is not None:
        s = sine_source(f0, upp, sr, nsf_noise)
        har = torch.tanh(s * sd["dec.m_source.l_linear.weight"][0, 0]
                         + sd["dec.m_source.l_linear.bias"][0])[None, None]
    x = ops.conv1d(z, sd["dec.conv_pre.weight"], sd["dec.conv_pre.bias"], padding=3)
    x = x + ops.conv1d(g, sd["dec.cond.weight"], sd["dec.cond.bias"])
    for i, (u, k) in enumerate(zip(up_rates, up_k)):
        x = ops.conv_transpose1d(F.leaky_relu(x, 0.1), fold_wn(sd, f"dec.ups.{i}"),
                                 sd[f"dec.ups.{i}.bias"], stride=u, padding=(k - u) // 2)
        if har is not None:
            sf = math.prod(up_rates[i + 1:])
            x = x + ops.conv1d(har, sd[f"dec.noise_convs.{i}.weight"],
                               sd[f"dec.noise_convs.{i}.bias"], stride=sf,
                               padding=sf // 2 if sf > 1 else 0)
        acc = 0.0
        for j, (ks, dils) in enumerate(zip(res_k, res_d)):
            r = f"dec.resblocks.{i * len(res_k) + j}"
            y = x
            for l, d in enumerate(dils):
                t = ops.conv1d(F.leaky_relu(y, 0.1), fold_wn(sd, f"{r}.convs1.{l}"),
                               sd[f"{r}.convs1.{l}.bias"], padding=d * (ks - 1) // 2,
                               dilation=d)
                t = ops.conv1d(F.leaky_relu(t, 0.1), fold_wn(sd, f"{r}.convs2.{l}"),
                               sd[f"{r}.convs2.{l}.bias"], padding=(ks - 1) // 2)
                y = y + t
            acc = acc + y
        x = acc / len(res_k)
    x = ops.conv1d(F.leaky_relu(x, 0.01), sd["dec.conv_post.weight"], padding=3)
    return torch.tanh(x)[0, 0]


def synthesize(sd, cfg: list, phone, pitch, pitchf, speaker: int, eps, nsf_noise,
               noise_scale: float, ops):
    """One chunk of T frames -> (T * upp,) audio: enc_p, the latent
    m + exp(logs) * eps * noise_scale, the flow reversed, the decoder."""
    g = sd["emb_g.weight"][speaker][None, :, None]
    m, logs = text_encoder(sd, cfg, phone, pitch, ops)
    t = m.shape[-1]
    z = flow_reverse(sd, cfg, m + torch.exp(logs) * eps[None, :, :t] * noise_scale, g, ops)
    return decoder(sd, cfg, z, pitchf, g, nsf_noise, ops)
