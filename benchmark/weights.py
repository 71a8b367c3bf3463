"""Random weights of a configuration, made from the seed on the card, in the
public checkpoint layouts a user's files have: the RVC v2 ``.pth`` weight
dict (weight-normed convs as weight_g / weight_v), fairseq HuBERT's state
dict, the F0 model's (made by its module in ``f0/``), and the index bank.

The values follow the rule of the port's synthetic builders (a copy of the
rule, not a call): standard normals scaled by 1/sqrt(fan-in), weight-norm
gains |0.2 n| + 0.8 times the direction's norm, norms and batch norms near
identity, the flow's post convs zero. Every normal of a model set comes
from ``torch.randn`` on the device, in blocks of 64 Mi values under one
generator seeded with the run's seed; the leaves are views of them,
scaled. So the same seed gives the
same weights, and the draws are a few large calls, not one per leaf.
"""

from __future__ import annotations

import math

import torch

from . import f0
from .init import fan as _fan, linear as _linear


class Normals:
    """Hands out consecutive views of standard-normal blocks drawn from one
    generator on the device, BLOCK values (or one leaf, if larger) a draw:
    a model set of ~264 million values takes a handful of draws."""

    BLOCK = 1 << 26

    def __init__(self, gen: torch.Generator, device):
        self.gen, self.device = gen, device
        self.buf, self.pos = None, 0

    def __call__(self, *shape):
        n = math.prod(shape)
        if self.buf is None or self.pos + n > self.buf.numel():
            self.buf = torch.randn(max(self.BLOCK, n), generator=self.gen, device=self.device)
            self.pos = 0
        out = self.buf[self.pos:self.pos + n].view(shape)
        self.pos += n
        return out


def _wn(nrm, sd, prefix, shape, norm_dim=0, bias=True, fan=None):
    """weight_v (scaled by 1/sqrt(fan), by default every axis but the first)
    and weight_g (|0.2 n| + 0.8 times the norm of v over every axis but
    norm_dim) as torch's weight_norm saves them."""
    v = nrm(*shape) * _fan(*(fan or shape[1:]))
    axes = tuple(i for i in range(len(shape)) if i != norm_dim)
    gshape = tuple(s if i == norm_dim else 1 for i, s in enumerate(shape))
    g = (nrm(*gshape) * 0.2).abs() + 0.8
    sd[f"{prefix}.weight_g"] = g * v.square().sum(dim=axes, keepdim=True).sqrt()
    sd[f"{prefix}.weight_v"] = v
    if bias:
        sd[f"{prefix}.bias"] = nrm(shape[0]) * 0.02


def _conv(nrm, sd, prefix, out_c, in_c, k, bias=True):
    sd[f"{prefix}.weight"] = nrm(out_c, in_c, k) * _fan(in_c, k)
    if bias:
        sd[f"{prefix}.bias"] = nrm(out_c) * 0.02


def _norm(nrm, sd, prefix, c, names=("weight", "bias")):
    sd[f"{prefix}.{names[0]}"] = nrm(c) * 0.01 + 1.0
    sd[f"{prefix}.{names[1]}"] = nrm(c) * 0.01


def rvc_weights(nrm, config: list, use_f0: bool, content_dim: int) -> dict:
    """The RVC .pth "weight" dict of the 18-entry config list; content_dim
    is the content features' width (HuBERT's embed_dim for v2, its
    final_proj width for v1: 768 and 256 at full width)."""
    (_, _, inter, hidden, filt, heads, layers, kernel, _, _, res_k, res_d,
     up_rates, up0, up_k, spk, gin, _) = config
    dk = hidden // heads
    sd = {}
    _linear(nrm, sd, "enc_p.emb_phone", hidden, content_dim)
    if use_f0:
        sd["enc_p.emb_pitch.weight"] = nrm(256, hidden) * _fan(hidden)
    for i in range(layers):
        a = f"enc_p.encoder.attn_layers.{i}"
        for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv(nrm, sd, f"{a}.{name}", hidden, hidden, 1)
        sd[f"{a}.emb_rel_k"] = nrm(1, 21, dk) * dk ** -0.5
        sd[f"{a}.emb_rel_v"] = nrm(1, 21, dk) * dk ** -0.5
        _norm(nrm, sd, f"enc_p.encoder.norm_layers_1.{i}", hidden, ("gamma", "beta"))
        _conv(nrm, sd, f"enc_p.encoder.ffn_layers.{i}.conv_1", filt, hidden, kernel)
        _conv(nrm, sd, f"enc_p.encoder.ffn_layers.{i}.conv_2", hidden, filt, kernel)
        _norm(nrm, sd, f"enc_p.encoder.norm_layers_2.{i}", hidden, ("gamma", "beta"))
    _conv(nrm, sd, "enc_p.proj", 2 * inter, hidden, 1)
    for j in range(4):
        p = f"flow.flows.{2 * j}"
        _conv(nrm, sd, f"{p}.pre", hidden, inter // 2, 1)
        for l in range(3):
            _wn(nrm, sd, f"{p}.enc.in_layers.{l}", (2 * hidden, hidden, 5))
            _wn(nrm, sd, f"{p}.enc.res_skip_layers.{l}",
                (hidden if l == 2 else 2 * hidden, hidden, 1))
        _wn(nrm, sd, f"{p}.enc.cond_layer", (2 * hidden * 3, gin, 1))
        _conv(nrm, sd, f"{p}.post", inter // 2, hidden, 1)
        sd[f"{p}.post.weight"] = sd[f"{p}.post.weight"] * 0
        sd[f"{p}.post.bias"] = sd[f"{p}.post.bias"] * 0
    _conv(nrm, sd, "dec.conv_pre", up0, inter, 7)
    _conv(nrm, sd, "dec.cond", up0, gin, 1)
    if use_f0:
        sd["dec.m_source.l_linear.weight"] = nrm(1, 1)
        sd["dec.m_source.l_linear.bias"] = nrm(1) * 0.02
    channels = [up0 // 2 ** (i + 1) for i in range(len(up_rates))]
    for i, (u, k) in enumerate(zip(up_rates, up_k)):
        c_in = up0 // 2 ** i
        # ConvTranspose1d: (in, out, k), weight norm over dim 0
        _wn(nrm, sd, f"dec.ups.{i}", (c_in, channels[i], k), bias=False, fan=(c_in, k))
        sd[f"dec.ups.{i}.bias"] = nrm(channels[i]) * 0.02
        if use_f0:
            stride_f0 = math.prod(up_rates[i + 1:])
            _conv(nrm, sd, f"dec.noise_convs.{i}", channels[i], 1,
                  stride_f0 * 2 if stride_f0 > 1 else 1)
        for j, (ks, dils) in enumerate(zip(res_k, res_d)):
            r = i * len(res_k) + j
            for l in range(len(dils)):
                _wn(nrm, sd, f"dec.resblocks.{r}.convs1.{l}", (channels[i], channels[i], ks))
                _wn(nrm, sd, f"dec.resblocks.{r}.convs2.{l}", (channels[i], channels[i], ks))
    _conv(nrm, sd, "dec.conv_post", 1, channels[-1], 7, bias=False)
    sd["emb_g.weight"] = nrm(spk, gin)
    return sd


def hubert_weights(nrm, cfg: dict) -> dict:
    """A fairseq HubertModel state dict."""
    sd = {}
    in_c = 1
    for i, (dim, k, _) in enumerate(cfg["conv_layers"]):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = nrm(dim, in_c, k) * _fan(in_c, k)
        if i == 0:
            _norm(nrm, sd, "feature_extractor.conv_layers.0.2", dim)
        in_c = dim
    d, groups, kernel = cfg["embed_dim"], cfg["pos_conv_groups"], cfg["pos_conv_kernel"]
    _linear(nrm, sd, "post_extract_proj", d, in_c)
    _norm(nrm, sd, "layer_norm", in_c)
    _wn(nrm, sd, "encoder.pos_conv.0", (d, d // groups, kernel), norm_dim=2)
    _norm(nrm, sd, "encoder.layer_norm", d)
    for i in range(cfg["n_layers"]):
        p = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(nrm, sd, f"{p}.self_attn.{name}", d, d)
        _norm(nrm, sd, f"{p}.self_attn_layer_norm", d)
        _linear(nrm, sd, f"{p}.fc1", cfg["ffn_dim"], d)
        _linear(nrm, sd, f"{p}.fc2", d, cfg["ffn_dim"])
        _norm(nrm, sd, f"{p}.final_layer_norm", d)
    _linear(nrm, sd, "final_proj", cfg["final_dim"], d)
    return sd


def _model_set(nrm, config: dict) -> dict:
    syn = config["synthesizer"]
    hub = config["hubert"]
    content_dim = hub["embed_dim"] if syn["version"] == "v2" else hub["final_dim"]
    out = {"rvc": rvc_weights(nrm, syn["config"], bool(syn["f0"]), content_dim),
           "hubert": hubert_weights(nrm, config["hubert"])}
    f0_model = f0.model(config)
    if f0_model is not None:
        out[config["f0_model"]] = f0_model.make_weights(nrm, config)
    if config.get("index_vectors"):
        out["index"] = nrm(config["index_vectors"], content_dim) * 0.5
    return out


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> dict:
    """{"rvc", "hubert", the F0 model's name (benchmark/f0/), "index"} ->
    the state dicts (and the bank) of the configuration, float32 on
    `device`, drawn in that order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return _model_set(Normals(gen, device), config)
