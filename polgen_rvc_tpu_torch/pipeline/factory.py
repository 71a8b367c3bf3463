"""Builders assembling a VoiceConverter (synthetic weights for now; real
checkpoint loading is a later slice)."""

from __future__ import annotations

import numpy as np

from .. import resolve_device
from ..convert.crepe_ckpt import convert_crepe_state, make_crepe_state
from ..convert.hubert_ckpt import convert_hubert_state
from ..convert.rmvpe_ckpt import convert_rmvpe_state
from ..convert.rvc_ckpt import build_config, convert_synthesizer_state
from ..convert.synthetic import make_hubert_state, make_rmvpe_state, make_rvc_checkpoint
from .config import EngineConfig
from .engine import VoiceConverter, torch_noise


def synthetic_params(*, tiny: bool = True, sr: int = 48000,
                     index_vectors: int = 0, seed: int = 0,
                     with_crepe: bool = False):
    """The numpy model set the JAX package's build_synthetic_converter
    fabricates from the same arguments, bit for bit:
    (synth_cfg, synth_params, hubert_cfg, hubert_params, rmvpe_params, bank),
    and with_crepe appends the full-width CREPE parameters (seed + 5)."""
    cpt = make_rvc_checkpoint(sr=sr, tiny=tiny, seed=seed, use_f0=True)
    synth_cfg = build_config(cpt["config"], use_f0=True, version="v2")
    synth_params = convert_synthesizer_state(cpt["weight"], synth_cfg)
    hub_cfg, hub_sd = make_hubert_state(tiny=tiny, seed=seed + 1)
    if hub_cfg.embed_dim != synth_cfg.input_dim:
        rng = np.random.default_rng(seed + 2)
        synth_params["enc_p"]["emb_phone"]["w"] = (
            rng.standard_normal((hub_cfg.embed_dim, synth_cfg.hidden_channels))
            / np.sqrt(hub_cfg.embed_dim)
        ).astype(np.float32)
    bank = None
    if index_vectors:
        rng = np.random.default_rng(seed + 3)
        bank = (rng.standard_normal((index_vectors, hub_cfg.embed_dim)) * 0.5
                ).astype(np.float32)
    rmvpe_params = convert_rmvpe_state(make_rmvpe_state(seed=seed + 4))
    model = (synth_cfg, synth_params, hub_cfg,
             convert_hubert_state(hub_sd, hub_cfg), rmvpe_params, bank)
    if with_crepe:
        model += (convert_crepe_state(make_crepe_state(seed=seed + 5)),)
    return model


def build_synthetic_converter(*, tiny: bool = True, sr: int = 48000,
                              index_vectors: int = 0,
                              engine: EngineConfig = EngineConfig(),
                              seed: int = 0, device=None,
                              noise_provider=torch_noise,
                              with_crepe: bool = False) -> VoiceConverter:
    """A converter over fabricated weights on `device` (default CUDA; raises
    without it unless device="cpu"); with_crepe adds full-width CREPE."""
    device = resolve_device(device)
    synth_cfg, synth_params, hub_cfg, hub_params, rmvpe_params, bank, *crepe = (
        synthetic_params(tiny=tiny, sr=sr, index_vectors=index_vectors, seed=seed,
                         with_crepe=with_crepe)
    )
    return VoiceConverter(
        synth_cfg=synth_cfg, synth_params=synth_params, hubert_cfg=hub_cfg,
        hubert_params=hub_params, rmvpe_params=rmvpe_params, index_bank=bank,
        engine=engine, device=device, noise_provider=noise_provider,
        crepe_params=crepe[0] if crepe else None,
    )
