"""Builders assembling a VoiceConverter (synthetic weights for now; real
checkpoint loading is a later slice)."""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..convert.crepe_ckpt import convert_crepe_state, make_crepe_state
from ..convert.fcpe_ckpt import convert_fcpe_state, make_fcpe_state
from ..convert.hubert_ckpt import convert_hubert_state
from ..convert.rmvpe_ckpt import convert_rmvpe_state
from ..convert.rvc_ckpt import build_config, convert_synthesizer_state
from ..convert.synthetic import make_hubert_state, make_rmvpe_state, make_rvc_checkpoint
from .config import EngineConfig
from .engine import VoiceConverter, torch_noise


def synthetic_params(*, tiny: bool = True, sr: int = 48000,
                     index_vectors: int = 0, seed: int = 0, use_f0: bool = True,
                     version: str = "v2", with_crepe: bool = False,
                     with_fcpe: bool = False):
    """The numpy model set the JAX package's build_synthetic_converter
    fabricates from the same arguments, bit for bit:
    (synth_cfg, synth_params, hubert_cfg, hubert_params, rmvpe_params, bank),
    rmvpe_params None without F0; with_crepe appends the full-width CREPE
    parameters (seed + 5), with_fcpe the FCPE (config, parameters) (seed +
    6; tiny or full width as the rest). version "v1" builds a 256-wide
    content input fed by HuBERT's final_proj (the JAX factory makes v2
    only): the content width and the index vectors are final_proj's."""
    cpt = make_rvc_checkpoint(sr=sr, tiny=tiny, seed=seed, use_f0=use_f0,
                              version=version)
    synth_cfg = build_config(cpt["config"], use_f0=use_f0, version=version)
    synth_params = convert_synthesizer_state(cpt["weight"], synth_cfg)
    hub_cfg, hub_sd = make_hubert_state(tiny=tiny, seed=seed + 1)
    feat_dim = hub_cfg.embed_dim if version == "v2" else hub_cfg.final_dim
    if feat_dim != synth_cfg.input_dim:
        rng = np.random.default_rng(seed + 2)
        synth_params["enc_p"]["emb_phone"]["w"] = (
            rng.standard_normal((feat_dim, synth_cfg.hidden_channels))
            / np.sqrt(feat_dim)
        ).astype(np.float32)
    bank = None
    if index_vectors:
        rng = np.random.default_rng(seed + 3)
        bank = (rng.standard_normal((index_vectors, feat_dim)) * 0.5
                ).astype(np.float32)
    rmvpe_params = (convert_rmvpe_state(make_rmvpe_state(seed=seed + 4))
                    if use_f0 else None)
    model = (synth_cfg, synth_params, hub_cfg,
             convert_hubert_state(hub_sd, hub_cfg), rmvpe_params, bank)
    if with_crepe:
        model += (convert_crepe_state(make_crepe_state(seed=seed + 5)),)
    if with_fcpe:
        fcpe_cfg, fcpe_sd = make_fcpe_state(tiny=tiny, seed=seed + 6)
        model += ((fcpe_cfg, convert_fcpe_state(fcpe_sd, fcpe_cfg)),)
    return model


def build_synthetic_converter(*, tiny: bool = True, sr: int = 48000,
                              index_vectors: int = 0,
                              engine: EngineConfig = EngineConfig(),
                              seed: int = 0, device=None,
                              noise_provider=torch_noise, use_f0: bool = True,
                              version: str = "v2", with_crepe: bool = False,
                              with_fcpe: bool = False) -> VoiceConverter:
    """A converter over fabricated weights on `device` (default CUDA; raises
    without it unless device="cpu"); use_f0=False builds a no-f0 model
    (and no RMVPE), with_crepe adds full-width CREPE, with_fcpe an FCPE of
    the model's width."""
    device = resolve_device(device)
    synth_cfg, synth_params, hub_cfg, hub_params, rmvpe_params, bank, *extra = (
        synthetic_params(tiny=tiny, sr=sr, index_vectors=index_vectors, seed=seed,
                         use_f0=use_f0, version=version, with_crepe=with_crepe,
                         with_fcpe=with_fcpe)
    )
    crepe = extra.pop(0) if with_crepe else None
    fcpe_cfg, fcpe_params = extra.pop(0) if with_fcpe else (None, None)
    return VoiceConverter(
        synth_cfg=synth_cfg, synth_params=synth_params, hubert_cfg=hub_cfg,
        hubert_params=hub_params, rmvpe_params=rmvpe_params, index_bank=bank,
        engine=engine, device=device, noise_provider=noise_provider,
        crepe_params=crepe, fcpe_params=fcpe_params, fcpe_cfg=fcpe_cfg,
    )
