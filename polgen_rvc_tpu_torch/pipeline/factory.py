"""Assembling a VoiceConverter: from checkpoint files
(build_converter) or from fabricated weights (build_synthetic_converter)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import resolve_device
from ..convert.crepe_ckpt import convert_crepe_state, load_crepe_checkpoint, make_crepe_state
from ..convert.fcpe_ckpt import convert_fcpe_state, load_fcpe_checkpoint, make_fcpe_state
from ..convert.hubert_ckpt import convert_hubert_state, load_hubert_checkpoint
from ..convert.rmvpe_ckpt import convert_rmvpe_state, load_rmvpe_checkpoint
from ..convert.rvc_ckpt import build_config, convert_synthesizer_state, load_rvc_checkpoint
from ..convert.synthetic import make_hubert_state, make_rmvpe_state, make_rvc_checkpoint
from ..retrieval.topk import load_index_bank
from .config import EngineConfig
from .engine import VoiceConverter, torch_noise


def build_converter(rvc_path: str, hubert_path: str,
                    rmvpe_path: Optional[str] = None,
                    index_path: Optional[str] = None, *,
                    crepe_path: Optional[str] = None,
                    fcpe_path: Optional[str] = None,
                    engine: EngineConfig = EngineConfig(),
                    device=None, mesh=None) -> VoiceConverter:
    """A converter over checkpoint files on `device` (default CUDA; raises
    without it unless device="cpu"), or over a mesh (parallel/mesh.py; a
    device given with it must be its primary): the RVC .pth, fairseq's
    HuBERT .pt, optionally rmvpe.pt, a faiss .index, CREPE's full.pth and
    fcpe.pt."""
    if mesh is None:
        device = resolve_device(device)
    synth_cfg, synth_params, _ = load_rvc_checkpoint(rvc_path)
    hub_cfg, hub_params = load_hubert_checkpoint(hubert_path)
    rmvpe_params = load_rmvpe_checkpoint(rmvpe_path) if rmvpe_path else None
    bank = load_index_bank(index_path) if index_path else None
    crepe_params = load_crepe_checkpoint(crepe_path) if crepe_path else None
    fcpe_cfg, fcpe_params = (load_fcpe_checkpoint(fcpe_path) if fcpe_path
                             else (None, None))
    return VoiceConverter(
        synth_cfg=synth_cfg, synth_params=synth_params, hubert_cfg=hub_cfg,
        hubert_params=hub_params, rmvpe_params=rmvpe_params, index_bank=bank,
        engine=engine, device=device, crepe_params=crepe_params,
        fcpe_params=fcpe_params, fcpe_cfg=fcpe_cfg, mesh=mesh,
    )


def synthetic_states(*, tiny: bool = True, sr: int = 48000,
                     index_vectors: int = 0, seed: int = 0, use_f0: bool = True,
                     version: str = "v2"):
    """The fabricated raw model set, as files hold it: (RVC checkpoint dict,
    HubertConfig, HuBERT state dict, RMVPE state dict or None, index bank
    or None). The checkpoint's content input (emb_phone) is redrawn at
    HuBERT's width (seed + 2) where the two differ; the bank (seed + 3) has
    final_proj's width for v1, HuBERT's for v2."""
    cpt = make_rvc_checkpoint(sr=sr, tiny=tiny, seed=seed, use_f0=use_f0,
                              version=version)
    synth_cfg = build_config(cpt["config"], use_f0=use_f0, version=version)
    hub_cfg, hub_sd = make_hubert_state(tiny=tiny, seed=seed + 1)
    feat_dim = hub_cfg.embed_dim if version == "v2" else hub_cfg.final_dim
    if feat_dim != synth_cfg.input_dim:
        rng = np.random.default_rng(seed + 2)
        w = (rng.standard_normal((feat_dim, synth_cfg.hidden_channels))
             / np.sqrt(feat_dim)).astype(np.float32)
        cpt["weight"]["enc_p.emb_phone.weight"] = w.T.copy()
    bank = None
    if index_vectors:
        rng = np.random.default_rng(seed + 3)
        bank = (rng.standard_normal((index_vectors, feat_dim)) * 0.5
                ).astype(np.float32)
    rmvpe_sd = make_rmvpe_state(seed=seed + 4) if use_f0 else None
    return cpt, hub_cfg, hub_sd, rmvpe_sd, bank


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
    cpt, hub_cfg, hub_sd, rmvpe_sd, bank = synthetic_states(
        tiny=tiny, sr=sr, index_vectors=index_vectors, seed=seed, use_f0=use_f0,
        version=version)
    synth_cfg = build_config(cpt["config"], use_f0=use_f0, version=version)
    synth_params = convert_synthesizer_state(cpt["weight"], synth_cfg)
    rmvpe_params = None if rmvpe_sd is None else convert_rmvpe_state(rmvpe_sd)
    model = (synth_cfg, synth_params, hub_cfg,
             convert_hubert_state(hub_sd, hub_cfg), rmvpe_params, bank)
    if with_crepe:
        model += (convert_crepe_state(make_crepe_state(seed=seed + 5)),)
    if with_fcpe:
        fcpe_cfg, fcpe_sd = make_fcpe_state(tiny=tiny, seed=seed + 6)
        model += ((fcpe_cfg, convert_fcpe_state(fcpe_sd, fcpe_cfg)),)
    return model


def _tensors(sd: dict) -> dict:
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def write_synthetic_files(root: str, name: str = "synthetic", *, tiny: bool = True,
                          sr: int = 48000, index_vectors: int = 0, seed: int = 0,
                          use_f0: bool = True, version: str = "v2") -> dict:
    """Write the model set synthetic_params makes from the same arguments
    as the files a user has, in the layout the app reads, under root:
    models/<name>/<name>.pth (torch.save of config, weight, f0, version),
    models/<name>/<name>.index (IVF-Flat, one list, so ids keep their
    order; with index_vectors), assets/embedders/hubert_base.pt (fairseq
    layout: {"model": state dict, "cfg": {"model": {heads}}}) and
    assets/predictors/rmvpe.pt (the raw state dict; f0 models). Returns
    {"rvc", "index", "hubert", "rmvpe"} -> path (None where not written).
    build_converter over these files gives synthetic_params' parameters."""
    import os

    import torch

    from ..convert.faiss_index import write_ivf_flat

    cpt, hub_cfg, hub_sd, rmvpe_sd, bank = synthetic_states(
        tiny=tiny, sr=sr, index_vectors=index_vectors, seed=seed, use_f0=use_f0,
        version=version)
    model_dir = os.path.join(root, "models", name)
    emb_dir = os.path.join(root, "assets", "embedders")
    pred_dir = os.path.join(root, "assets", "predictors")
    for d in (model_dir, emb_dir, pred_dir):
        os.makedirs(d, exist_ok=True)
    paths = {"rvc": os.path.join(model_dir, f"{name}.pth"), "index": None,
             "hubert": os.path.join(emb_dir, "hubert_base.pt"), "rmvpe": None}
    torch.save({"config": cpt["config"], "weight": _tensors(cpt["weight"]),
                "f0": cpt["f0"], "version": cpt["version"]}, paths["rvc"])
    torch.save({"model": _tensors(hub_sd),
                "cfg": {"model": {"encoder_attention_heads": hub_cfg.n_heads}}},
               paths["hubert"])
    if rmvpe_sd is not None:
        paths["rmvpe"] = os.path.join(pred_dir, "rmvpe.pt")
        torch.save(_tensors(rmvpe_sd), paths["rmvpe"])
    if bank is not None:
        paths["index"] = os.path.join(model_dir, f"{name}.index")
        write_ivf_flat(paths["index"], bank, bank.mean(0, keepdims=True),
                       np.zeros(bank.shape[0], np.int64))
    return paths


def build_synthetic_converter(*, tiny: bool = True, sr: int = 48000,
                              index_vectors: int = 0,
                              engine: EngineConfig = EngineConfig(),
                              seed: int = 0, device=None,
                              noise_provider=torch_noise, use_f0: bool = True,
                              version: str = "v2", with_crepe: bool = False,
                              with_fcpe: bool = False, mesh=None) -> VoiceConverter:
    """A converter over fabricated weights on `device` (default CUDA; raises
    without it unless device="cpu"), or over a mesh (a device given with it
    must be its primary); use_f0=False builds a no-f0 model (and no RMVPE),
    with_crepe adds full-width CREPE, with_fcpe an FCPE of the model's
    width."""
    if mesh is None:
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
        crepe_params=crepe, fcpe_params=fcpe_params, fcpe_cfg=fcpe_cfg, mesh=mesh,
    )
