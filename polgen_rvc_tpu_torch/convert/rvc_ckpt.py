"""RVC .pth checkpoint -> (SynthesizerConfig, parameter dictionary).

Checkpoint schema (the upstream RVC get_vc): dict with
  config:  18 positional Synthesizer args, last = tgt_sr
  weight:  state_dict (posterior encoder enc_q keys absent/dropped)
  f0:      pitch-guidance flag (default 1)
  version: "v1" (input_dim 256) | "v2" (input_dim 768)
The speaker count is patched from emb_g.weight's shape, as the upstream
get_vc does. Weight norm is folded here.
"""

from __future__ import annotations

import numpy as np

from ..models.synthesizer import SynthesizerConfig
from .common import conv_params, linear_params, norm_params, to_numpy


def build_config(config_list, *, use_f0: bool, version: str) -> SynthesizerConfig:
    (
        spec_channels, segment_size, inter, hidden, filt, heads, layers,
        kernel, p_drop, resblock, res_k, res_d, up_rates, up_init, up_k,
        spk_dim, gin, sr,
    ) = config_list
    if isinstance(sr, str):  # some forks store "48k"-style strings
        sr = {"32k": 32000, "40k": 40000, "48k": 48000}[sr]
    return SynthesizerConfig(
        spec_channels=int(spec_channels),
        segment_size=int(segment_size),
        inter_channels=int(inter),
        hidden_channels=int(hidden),
        filter_channels=int(filt),
        n_heads=int(heads),
        n_layers=int(layers),
        kernel_size=int(kernel),
        p_dropout=float(p_drop),
        resblock=str(resblock),
        resblock_kernel_sizes=tuple(int(x) for x in res_k),
        resblock_dilation_sizes=tuple(tuple(int(y) for y in d) for d in res_d),
        upsample_rates=tuple(int(x) for x in up_rates),
        upsample_initial_channel=int(up_init),
        upsample_kernel_sizes=tuple(int(x) for x in up_k),
        spk_embed_dim=int(spk_dim),
        gin_channels=int(gin),
        sr=int(sr),
        use_f0=bool(use_f0),
        input_dim=768 if version == "v2" else 256,
    )


def _convert_enc_p(sd, cfg: SynthesizerConfig):
    enc = []
    for i in range(cfg.n_layers):
        a = f"enc_p.encoder.attn_layers.{i}"
        enc.append(
            {
                "attn": {
                    "q": conv_params(sd, f"{a}.conv_q"),
                    "k": conv_params(sd, f"{a}.conv_k"),
                    "v": conv_params(sd, f"{a}.conv_v"),
                    "o": conv_params(sd, f"{a}.conv_o"),
                    "emb_rel_k": to_numpy(sd[f"{a}.emb_rel_k"]).astype(np.float32),
                    "emb_rel_v": to_numpy(sd[f"{a}.emb_rel_v"]).astype(np.float32),
                },
                "norm1": norm_params(sd, f"enc_p.encoder.norm_layers_1.{i}"),
                "ffn": {
                    "conv1": conv_params(sd, f"enc_p.encoder.ffn_layers.{i}.conv_1"),
                    "conv2": conv_params(sd, f"enc_p.encoder.ffn_layers.{i}.conv_2"),
                },
                "norm2": norm_params(sd, f"enc_p.encoder.norm_layers_2.{i}"),
            }
        )
    out = {
        "emb_phone": linear_params(sd, "enc_p.emb_phone"),
        "encoder": enc,
        "proj": conv_params(sd, "enc_p.proj"),
    }
    if "enc_p.emb_pitch.weight" in sd:
        out["emb_pitch"] = to_numpy(sd["enc_p.emb_pitch.weight"]).astype(np.float32)
    return out


def _convert_wavenet(sd, prefix: str, n_layers: int, has_cond: bool):
    p = {
        "in": [
            conv_params(sd, f"{prefix}.in_layers.{i}", weight_norm=True)
            for i in range(n_layers)
        ],
        "skip": [
            conv_params(sd, f"{prefix}.res_skip_layers.{i}", weight_norm=True)
            for i in range(n_layers)
        ],
    }
    if has_cond:
        p["cond"] = conv_params(sd, f"{prefix}.cond_layer", weight_norm=True)
    return p


def _convert_flow(sd, cfg: SynthesizerConfig):
    flows = []
    for j in range(4):  # couplings live at even indices (Flips between)
        pre = f"flow.flows.{2 * j}"
        flows.append(
            {
                "pre": conv_params(sd, f"{pre}.pre"),
                "enc": _convert_wavenet(sd, f"{pre}.enc", 3, cfg.gin_channels > 0),
                "post": conv_params(sd, f"{pre}.post"),
            }
        )
    return flows


def _convert_dec(sd, cfg: SynthesizerConfig):
    n_up = len(cfg.upsample_rates)
    n_res = n_up * len(cfg.resblock_kernel_sizes)
    dec = {
        "conv_pre": conv_params(sd, "dec.conv_pre"),
        "conv_post": conv_params(sd, "dec.conv_post"),
        "ups": [
            conv_params(sd, f"dec.ups.{i}", weight_norm=True) for i in range(n_up)
        ],
        "resblocks": [
            {
                "convs1": [
                    conv_params(sd, f"dec.resblocks.{j}.convs1.{k}", weight_norm=True)
                    for k in range(len(cfg.resblock_dilation_sizes[j % len(cfg.resblock_kernel_sizes)]))
                ],
                "convs2": [
                    conv_params(sd, f"dec.resblocks.{j}.convs2.{k}", weight_norm=True)
                    for k in range(len(cfg.resblock_dilation_sizes[j % len(cfg.resblock_kernel_sizes)]))
                ],
            }
            for j in range(n_res)
        ],
    }
    if cfg.gin_channels > 0:
        dec["cond"] = conv_params(sd, "dec.cond")
    if cfg.use_f0:
        dec["m_source"] = {"l_linear": {
            "w": to_numpy(sd["dec.m_source.l_linear.weight"]).astype(np.float32),
            "b": to_numpy(sd["dec.m_source.l_linear.bias"]).astype(np.float32),
        }}
        dec["noise_convs"] = [
            conv_params(sd, f"dec.noise_convs.{i}") for i in range(n_up)
        ]
    return dec


def convert_synthesizer_state(sd: dict, cfg: SynthesizerConfig) -> dict:
    """torch state_dict (enc_q-free) -> parameter dictionary for models.synthesizer."""
    return {
        "enc_p": _convert_enc_p(sd, cfg),
        "flow": _convert_flow(sd, cfg),
        "dec": _convert_dec(sd, cfg),
        "emb_g": to_numpy(sd["emb_g.weight"]).astype(np.float32),
    }


def load_rvc_checkpoint(path: str):
    """Load an RVC .pth -> (cfg, params, tgt_sr)."""
    import torch

    cpt = torch.load(path, map_location="cpu", weights_only=True)
    if "config" not in cpt or "weight" not in cpt:
        raise ValueError(
            f"Invalid checkpoint format for {path}: expected an RVC voice "
            "model with 'config' and 'weight' entries."
        )
    config_list = list(cpt["config"])
    # the speaker count comes from the embedding table
    config_list[-3] = cpt["weight"]["emb_g.weight"].shape[0]
    use_f0 = bool(cpt.get("f0", 1))
    version = cpt.get("version", "v1")
    cfg = build_config(config_list, use_f0=use_f0, version=version)
    params = convert_synthesizer_state(cpt["weight"], cfg)
    return cfg, params, cfg.sr
