"""The port's own copy of the weight builders against the JAX package's:
the same seed gives bitwise the same numpy parameter dictionaries, and
params_to_torch carries them onto tensors without changing a bit."""

import functools

import numpy as np
import pytest
import torch

from polgen_rvc_tpu.convert import synthetic as jax_synth
from polgen_rvc_tpu.convert.hubert_ckpt import convert_hubert_state as jax_hubert
from polgen_rvc_tpu.convert.rmvpe_ckpt import convert_rmvpe_state as jax_rmvpe
from polgen_rvc_tpu.convert.rvc_ckpt import (
    build_config as jax_build_config,
    convert_synthesizer_state as jax_synth_state,
)
from polgen_rvc_tpu_torch.convert.hubert_ckpt import infer_hubert_config
from polgen_rvc_tpu_torch.convert.params import params_to_torch
from polgen_rvc_tpu_torch.pipeline.factory import synthetic_params


def _assert_tree_equal(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


@pytest.mark.parametrize("sr", [48000, 40000])
def test_full_width_configs_equal(sr):
    """The full-width configs (what the card runs) without building their
    weights: the same 18-element config list, SynthesizerConfig and
    HubertConfig as the JAX package."""
    from polgen_rvc_tpu.models.hubert import HubertConfig as JaxHubertConfig
    from polgen_rvc_tpu_torch.convert.rvc_ckpt import build_config
    from polgen_rvc_tpu_torch.convert.synthetic import rvc_config_list
    from polgen_rvc_tpu_torch.models.hubert import HubertConfig

    cfg_list = rvc_config_list(sr, tiny=False)
    assert cfg_list == jax_synth.rvc_config_list(sr, tiny=False)
    cfg = build_config(cfg_list, use_f0=True, version="v2")
    jcfg = jax_build_config(cfg_list, use_f0=True, version="v2")
    assert cfg.__dict__ == jcfg.__dict__ and cfg.upp == jcfg.upp
    assert HubertConfig().__dict__ == JaxHubertConfig().__dict__


@functools.lru_cache(maxsize=None)
def _port_params(seed):
    """The port's tiny model set (its RMVPE is always full width, the
    costly part to build): built once per seed for this file's tests."""
    return synthetic_params(tiny=True, sr=48000, index_vectors=16, seed=seed)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_weights_bitwise_equal(seed):
    tiny = True
    cfg, synth, hub_cfg, hub, rmvpe, bank = _port_params(seed)

    cpt = jax_synth.make_rvc_checkpoint(sr=48000, tiny=tiny, seed=seed, use_f0=True)
    jcfg = jax_build_config(cpt["config"], use_f0=True, version="v2")
    jsynth = jax_synth_state(cpt["weight"], jcfg)
    jhub_cfg, hub_sd = jax_synth.make_hubert_state(tiny=tiny, seed=seed + 1)
    if jhub_cfg.embed_dim != jcfg.input_dim:  # the JAX factory's emb_phone swap
        rng = np.random.default_rng(seed + 2)
        jsynth["enc_p"]["emb_phone"]["w"] = (
            rng.standard_normal((jhub_cfg.embed_dim, jcfg.hidden_channels))
            / np.sqrt(jhub_cfg.embed_dim)).astype(np.float32)
    rng = np.random.default_rng(seed + 3)
    jbank = (rng.standard_normal((16, jhub_cfg.embed_dim)) * 0.5).astype(np.float32)

    assert cfg.__dict__ == jcfg.__dict__ and cfg.upp == jcfg.upp
    assert hub_cfg.__dict__ == jhub_cfg.__dict__
    _assert_tree_equal(synth, jsynth)
    _assert_tree_equal(hub, jax_hubert(hub_sd, jhub_cfg))
    _assert_tree_equal(rmvpe, jax_rmvpe(jax_synth.make_rmvpe_state(seed=seed + 4)))
    _assert_tree_equal(bank, jbank)


def test_infer_hubert_config_matches_full_state():
    cfg, sd = jax_synth.make_hubert_state(tiny=False, seed=1)
    assert infer_hubert_config(sd).__dict__ == cfg.__dict__


def test_params_to_torch_round_trip():
    _, synth, _, _, rmvpe, _ = _port_params(0)
    for tree in (synth, rmvpe):
        t = params_to_torch(tree, "cpu")
        back = _to_numpy(t)
        _assert_tree_equal(back, tree)
    half = params_to_torch(rmvpe, "cpu", torch.bfloat16)
    assert half["cnn"]["w"].dtype == torch.bfloat16


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree
