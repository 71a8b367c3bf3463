"""Synthetic checkpoint factories.

No real RVC/HuBERT/RMVPE weights are reachable in a zero-egress environment,
so tests and benchmarks fabricate checkpoints with the exact torch
state-dict key schema + shapes and random (seeded, small-scale) values.
This module is also living documentation of each format.
"""

from __future__ import annotations

import math

import numpy as np

from ..models.hubert import HubertConfig
from .rvc_ckpt import build_config

# canonical RVC v2 configs (community-standard pretrained shapes)
V2_CONFIGS = {
    32000: dict(spec=513, up_rates=[10, 8, 2, 2], up_k=[20, 16, 4, 4]),
    40000: dict(spec=1025, up_rates=[10, 10, 2, 2], up_k=[16, 16, 4, 4]),
    48000: dict(spec=1025, up_rates=[12, 10, 2, 2], up_k=[24, 20, 4, 4]),
}
# RVC-Project configs/v1/{32k,40k,48k}.json: five decoder stages from 512
# channels at 32 and 48 kHz (the last 16 wide; 32 kHz's second stage has
# padding 6 > stride 4); 40 kHz is v2's
V1_CONFIGS = {
    32000: dict(spec=513, up_rates=[10, 4, 2, 2, 2], up_k=[16, 16, 4, 4, 4]),
    40000: V2_CONFIGS[40000],
    48000: dict(spec=1025, up_rates=[10, 6, 2, 2, 2], up_k=[16, 16, 4, 4, 4]),
}
CONFIGS = {"v1": V1_CONFIGS, "v2": V2_CONFIGS}


def rvc_config_list(sr: int = 48000, *, spk: int = 1, tiny: bool = False,
                    version: str = "v2"):
    """The 18-element `config` list stored in .pth files (infer.py:86-97),
    with the decoder rates of `version`'s published config at `sr`."""
    c = CONFIGS[version][sr]
    if tiny:
        return [
            c["spec"], 32, 32, 32, 64, 2, 2, 3, 0, "1",
            [3, 5], [[1, 3], [1, 3]], c["up_rates"], 64, c["up_k"], spk, 16, sr,
        ]
    return [
        c["spec"], 32, 192, 192, 768, 2, 6, 3, 0, "1",
        [3, 7, 11], [[1, 3, 5]] * 3, c["up_rates"], 512, c["up_k"], spk, 256, sr,
    ]


def _rand(rng, *shape, scale=0.1):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _fan_scale(*fan_dims):
    """Kaiming-ish init so deep synthetic stacks stay numerically sane."""
    fan_in = int(np.prod(fan_dims))
    return 1.0 / max(np.sqrt(fan_in), 1.0)


def _conv_wn(sd, rng, prefix, out_c, in_c, k, bias=True):
    """Emit weight_g/weight_v keys like torch weight_norm(dim=0) saves."""
    v = _rand(rng, out_c, in_c, k, scale=_fan_scale(in_c, k))
    g = np.abs(_rand(rng, out_c, 1, 1, scale=0.2)) + 0.8
    sd[f"{prefix}.weight_g"] = (g * np.sqrt((v**2).sum(axis=(1, 2), keepdims=True))).astype(np.float32)
    sd[f"{prefix}.weight_v"] = v
    if bias:
        sd[f"{prefix}.bias"] = _rand(rng, out_c, scale=0.02)


def _conv(sd, rng, prefix, out_c, in_c, k, bias=True):
    sd[f"{prefix}.weight"] = _rand(rng, out_c, in_c, k, scale=_fan_scale(in_c, k))
    if bias:
        sd[f"{prefix}.bias"] = _rand(rng, out_c, scale=0.02)


def _linear(sd, rng, prefix, out_c, in_c, bias=True):
    sd[f"{prefix}.weight"] = _rand(rng, out_c, in_c, scale=_fan_scale(in_c))
    if bias:
        sd[f"{prefix}.bias"] = _rand(rng, out_c, scale=0.02)


def _norm(sd, rng, prefix, c, torch_names=False):
    a, b = ("weight", "bias") if torch_names else ("gamma", "beta")
    sd[f"{prefix}.{a}"] = np.ones(c, np.float32) + _rand(rng, c, scale=0.01)
    sd[f"{prefix}.{b}"] = _rand(rng, c, scale=0.01)


def make_rvc_checkpoint(
    sr: int = 48000, *, version: str = "v2", use_f0: bool = True,
    spk: int = 1, tiny: bool = True, seed: int = 0,
):
    """Fabricate an RVC .pth-equivalent dict {config, weight, f0, version}."""
    rng = np.random.default_rng(seed)
    config = rvc_config_list(sr, spk=spk, tiny=tiny, version=version)
    cfg = build_config(config, use_f0=use_f0, version=version)
    H, F_, I = cfg.hidden_channels, cfg.filter_channels, cfg.inter_channels
    dk = H // cfg.n_heads
    sd = {}

    # ---- enc_p ----
    _linear(sd, rng, "enc_p.emb_phone", H, cfg.input_dim)
    if use_f0:
        sd["enc_p.emb_pitch.weight"] = _rand(rng, 256, H, scale=_fan_scale(H))
    for i in range(cfg.n_layers):
        a = f"enc_p.encoder.attn_layers.{i}"
        for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv(sd, rng, f"{a}.{nm}", H, H, 1)
        sd[f"{a}.emb_rel_k"] = _rand(rng, 1, 21, dk, scale=dk**-0.5)
        sd[f"{a}.emb_rel_v"] = _rand(rng, 1, 21, dk, scale=dk**-0.5)
        _norm(sd, rng, f"enc_p.encoder.norm_layers_1.{i}", H)
        _conv(sd, rng, f"enc_p.encoder.ffn_layers.{i}.conv_1", F_, H, cfg.kernel_size)
        _conv(sd, rng, f"enc_p.encoder.ffn_layers.{i}.conv_2", H, F_, cfg.kernel_size)
        _norm(sd, rng, f"enc_p.encoder.norm_layers_2.{i}", H)
    _conv(sd, rng, "enc_p.proj", 2 * I, H, 1)

    # ---- flow (4 couplings at even indices) ----
    for j in range(4):
        p = f"flow.flows.{2 * j}"
        _conv(sd, rng, f"{p}.pre", H, I // 2, 1)
        for l in range(3):
            _conv_wn(sd, rng, f"{p}.enc.in_layers.{l}", 2 * H, H, 5)
            out_c = H if l == 2 else 2 * H
            _conv_wn(sd, rng, f"{p}.enc.res_skip_layers.{l}", out_c, H, 1)
        _conv_wn(sd, rng, f"{p}.enc.cond_layer", 2 * H * 3, cfg.gin_channels, 1)
        _conv(sd, rng, f"{p}.post", I // 2, H, 1)
        sd[f"{p}.post.weight"] *= 0  # zero-initialized in reference
        sd[f"{p}.post.bias"] *= 0

    # ---- dec (GeneratorNSF) ----
    up0 = cfg.upsample_initial_channel
    _conv(sd, rng, "dec.conv_pre", up0, I, 7)
    _conv(sd, rng, "dec.cond", up0, cfg.gin_channels, 1)
    if use_f0:
        sd["dec.m_source.l_linear.weight"] = _rand(rng, 1, 1, scale=1.0)
        sd["dec.m_source.l_linear.bias"] = _rand(rng, 1, scale=0.02)
    channels = [up0 // (2 ** (i + 1)) for i in range(len(cfg.upsample_rates))]
    n_kernels = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        in_c = up0 // (2**i)
        # ConvTranspose1d weight layout: (in, out, k)
        v = _rand(rng, in_c, channels[i], k, scale=_fan_scale(in_c, k))
        g = (np.abs(_rand(rng, in_c, 1, 1, scale=0.2)) + 0.8) * np.sqrt(
            (v**2).sum(axis=(1, 2), keepdims=True)
        )
        sd[f"dec.ups.{i}.weight_g"] = g
        sd[f"dec.ups.{i}.weight_v"] = v
        sd[f"dec.ups.{i}.bias"] = _rand(rng, channels[i], scale=0.02)
        if use_f0:
            stride_f0 = int(math.prod(cfg.upsample_rates[i + 1 :]))
            nk = stride_f0 * 2 if stride_f0 > 1 else 1
            _conv(sd, rng, f"dec.noise_convs.{i}", channels[i], 1, nk)
        for j in range(n_kernels):
            ridx = i * n_kernels + j
            ks = cfg.resblock_kernel_sizes[j]
            dils = cfg.resblock_dilation_sizes[j]
            for l in range(len(dils)):
                _conv_wn(sd, rng, f"dec.resblocks.{ridx}.convs1.{l}", channels[i], channels[i], ks)
                _conv_wn(sd, rng, f"dec.resblocks.{ridx}.convs2.{l}", channels[i], channels[i], ks)
    _conv(sd, rng, "dec.conv_post", 1, channels[-1], 7, bias=False)

    sd["emb_g.weight"] = _rand(rng, spk, cfg.gin_channels, scale=1.0)

    return {"config": config, "weight": sd, "f0": int(use_f0), "version": version}


def make_hubert_state(*, tiny: bool = True, seed: int = 0,
                      with_final_proj: bool = True, embed_dim: int = 64):
    """Fabricate a fairseq HubertModel state_dict (+ its HubertConfig)."""
    rng = np.random.default_rng(seed)
    if tiny:
        d = embed_dim
        cfg = HubertConfig(
            conv_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)),
            embed_dim=d, ffn_dim=2 * d, n_heads=4, n_layers=3,
            pos_conv_kernel=16, pos_conv_groups=4, final_dim=max(d // 2, 4),
        )
    else:
        cfg = HubertConfig()
    sd = {}
    in_c = 1
    for i, (dim, k, s) in enumerate(cfg.conv_layers):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = _rand(
            rng, dim, in_c, k, scale=_fan_scale(in_c, k))
        if i == 0:
            _norm(sd, rng, "feature_extractor.conv_layers.0.2", dim, torch_names=True)
        in_c = dim
    d = cfg.embed_dim
    _linear(sd, rng, "post_extract_proj", d, in_c)
    _norm(sd, rng, "layer_norm", in_c, torch_names=True)
    # pos conv with weight norm over dim=2
    v = _rand(rng, d, d // cfg.pos_conv_groups, cfg.pos_conv_kernel,
              scale=_fan_scale(d // cfg.pos_conv_groups, cfg.pos_conv_kernel))
    g = (np.abs(_rand(rng, 1, 1, cfg.pos_conv_kernel, scale=0.2)) + 0.8) * np.sqrt(
        (v**2).sum(axis=(0, 1), keepdims=True)
    )
    sd["encoder.pos_conv.0.weight_g"] = g
    sd["encoder.pos_conv.0.weight_v"] = v
    sd["encoder.pos_conv.0.bias"] = _rand(rng, d, scale=0.02)
    _norm(sd, rng, "encoder.layer_norm", d, torch_names=True)
    for i in range(cfg.n_layers):
        p = f"encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, rng, f"{p}.self_attn.{nm}", d, d)
        _norm(sd, rng, f"{p}.self_attn_layer_norm", d, torch_names=True)
        _linear(sd, rng, f"{p}.fc1", cfg.ffn_dim, d)
        _linear(sd, rng, f"{p}.fc2", d, cfg.ffn_dim)
        _norm(sd, rng, f"{p}.final_layer_norm", d, torch_names=True)
    if with_final_proj:
        _linear(sd, rng, "final_proj", cfg.final_dim, d)
    return cfg, sd


def make_rmvpe_state(*, seed: int = 0, n_blocks: int = 4):
    """Fabricate the rmvpe.pt E2E(4, 1, (2,2)) state_dict."""
    rng = np.random.default_rng(seed)
    sd = {}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = np.ones(c, np.float32) + _rand(rng, c, scale=0.01)
        sd[f"{prefix}.bias"] = _rand(rng, c, scale=0.01)
        sd[f"{prefix}.running_mean"] = _rand(rng, c, scale=0.1)
        sd[f"{prefix}.running_var"] = np.abs(_rand(rng, c, scale=0.1)) + 1.0
        sd[f"{prefix}.num_batches_tracked"] = np.array(0, np.int64)

    def conv_block(prefix, in_c, out_c):
        sd[f"{prefix}.conv.0.weight"] = _rand(rng, out_c, in_c, 3, 3, scale=_fan_scale(in_c, 3, 3))
        bn(f"{prefix}.conv.1", out_c)
        sd[f"{prefix}.conv.3.weight"] = _rand(rng, out_c, out_c, 3, 3, scale=_fan_scale(out_c, 3, 3))
        bn(f"{prefix}.conv.4", out_c)
        if in_c != out_c:
            sd[f"{prefix}.shortcut.weight"] = _rand(rng, out_c, in_c, 1, 1, scale=_fan_scale(in_c))
            sd[f"{prefix}.shortcut.bias"] = _rand(rng, out_c, scale=0.02)

    bn("unet.encoder.bn", 1)
    in_c, out_c = 1, 16
    enc_channels = []
    for i in range(5):
        for j in range(n_blocks):
            conv_block(f"unet.encoder.layers.{i}.conv.{j}", in_c if j == 0 else out_c, out_c)
        enc_channels.append(out_c)
        in_c, out_c = out_c, out_c * 2
    # intermediate: (256 -> 512) then 512 x3
    inter_in, inter_out = enc_channels[-1], enc_channels[-1] * 2
    for i in range(4):
        for j in range(n_blocks):
            c_in = inter_in if (i == 0 and j == 0) else inter_out
            conv_block(f"unet.intermediate.layers.{i}.conv.{j}", c_in, inter_out)
    # decoder: 512 -> 256 ... -> 16
    c = inter_out
    for i in range(5):
        oc = c // 2
        sd[f"unet.decoder.layers.{i}.conv1.0.weight"] = _rand(rng, c, oc, 3, 3, scale=_fan_scale(c, 3, 3))
        bn(f"unet.decoder.layers.{i}.conv1.1", oc)
        for j in range(n_blocks):
            conv_block(f"unet.decoder.layers.{i}.conv2.{j}", oc * 2 if j == 0 else oc, oc)
        c = oc

    sd["cnn.weight"] = _rand(rng, 3, 16, 3, 3, scale=_fan_scale(16, 3, 3))
    sd["cnn.bias"] = _rand(rng, 3, scale=0.02)
    for suffix in ("", "_reverse"):
        sd[f"fc.0.gru.weight_ih_l0{suffix}"] = _rand(rng, 3 * 256, 384, scale=_fan_scale(384))
        sd[f"fc.0.gru.weight_hh_l0{suffix}"] = _rand(rng, 3 * 256, 256, scale=_fan_scale(256))
        sd[f"fc.0.gru.bias_ih_l0{suffix}"] = _rand(rng, 3 * 256, scale=0.02)
        sd[f"fc.0.gru.bias_hh_l0{suffix}"] = _rand(rng, 3 * 256, scale=0.02)
    _linear(sd, rng, "fc.1", 360, 512)
    return sd
