"""The port's no-f0 generator, v1 models and the 40 and 32 kHz configs
against the JAX package, on the CPU.

Weights are the same numpy trees on both sides (the port's own copy of the
factories gives them bit for bit); inputs are made with numpy from a seed.
The converts run bench.py's CPU-smoke engine with the JAX engine's own
noise draws, so two renditions differ only by float32 arithmetic order;
the gate is the repo's 0.5 dB mel distortion.

The published v1 decoders (RVC-Project configs/v1) start from 512 channels
like v2 but have five stages, so their last stage is 16 wide, and v1
32 kHz's second stage (u = 4, k = 16) has padding 6 > stride: offsets
-2..2. Both are run here at tiny width through the port's load-time
packing (the zero-padded stages, pack_phase_taps) and plain twins. The
port's factory builds those rates for version "v1"; the JAX factory knows
v2's only, so its V2_CONFIGS is patched to them.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polgen_rvc_tpu.convert.synthetic as jax_synthetic
import polgen_rvc_tpu_torch.convert.synthetic as port_synthetic
from polgen_rvc_tpu.convert.hubert_ckpt import convert_hubert_state as jax_hubert_state
from polgen_rvc_tpu.convert.rmvpe_ckpt import convert_rmvpe_state as jax_rmvpe_state
from polgen_rvc_tpu.convert.rvc_ckpt import (
    build_config as jax_build_config,
    convert_synthesizer_state as jax_synth_state,
)
from polgen_rvc_tpu.models.nsf import generator as jax_generator
from polgen_rvc_tpu.models.nsf import generator_nsf as jax_generator_nsf
from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.engine import VoiceConverter as JaxVoiceConverter
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_build_converter
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.convert.params import params_to_torch
from polgen_rvc_tpu_torch.convert.rvc_ckpt import build_config, convert_synthesizer_state
from polgen_rvc_tpu_torch.models.nsf import generator, generator_nsf, pack_decoder_weights
from polgen_rvc_tpu_torch.ops.conv_transpose import phase_taps
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter
from polgen_rvc_tpu_torch.pipeline.factory import synthetic_params
from test_torch_pipeline import one_intra_op_thread  # noqa: F401

SMOKE_ENGINE = dict(x_pad=1, x_query=2, x_center=3, x_max=4, chunk_batch=2,
                    bucket_step_s=2)
BENCH_OPTS = dict(index_rate=0.5, protect=0.33, volume_envelope=0.25)
MODEL_NAMES = ("synth_cfg", "synth_params", "hubert_cfg", "hubert_params",
               "rmvpe_params", "index_bank")
# RVC-Project configs/v1/{48k,32k}.json: upsample rates and kernel sizes
V1_RATES = {
    48000: dict(spec=1025, up_rates=[10, 6, 2, 2, 2], up_k=[16, 16, 4, 4, 4]),
    32000: dict(spec=513, up_rates=[10, 4, 2, 2, 2], up_k=[16, 16, 4, 4, 4]),
}


def _bench_song(seconds: float) -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * 16000)) / 16000
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    return (0.4 * np.sin(2 * np.pi * 220.0 * t * vibrato)
            + 0.1 * np.sin(2 * np.pi * 440.0 * t)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _jax_noise(seed, chunk_id, lat_shape, nsf_len, device):
    """The JAX engine's per-chunk draws (see test_torch_pipeline.py)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), chunk_id)
    k_lat, k_nsf = jax.random.split(key)
    eps = np.array(jax.random.normal(k_lat, lat_shape, jnp.float32))
    nsf = np.array(jax.random.normal(k_nsf, (nsf_len,), jnp.float32))
    return torch.from_numpy(eps).to(device), torch.from_numpy(nsf).to(device)


def _port_converter(**kw):
    model = synthetic_params(tiny=True, index_vectors=256, seed=0, **kw)
    return VoiceConverter(**dict(zip(MODEL_NAMES, model)),
                          engine=EngineConfig(**SMOKE_ENGINE), device="cpu",
                          noise_provider=_jax_noise), model


def _jax_v1_converter(sr: int):
    """The JAX converter over the model the port's synthetic_params(version=
    "v1") fabricates: the JAX factory's recipe with a v1 checkpoint, the
    content input fed by HuBERT's final_proj."""
    cpt = jax_synthetic.make_rvc_checkpoint(sr=sr, tiny=True, seed=0, version="v1")
    cfg = jax_build_config(cpt["config"], use_f0=True, version="v1")
    params = jax_synth_state(cpt["weight"], cfg)
    hub_cfg, hub_sd = jax_synthetic.make_hubert_state(tiny=True, seed=1)
    rng = np.random.default_rng(2)
    params["enc_p"]["emb_phone"]["w"] = (
        rng.standard_normal((hub_cfg.final_dim, cfg.hidden_channels))
        / np.sqrt(hub_cfg.final_dim)).astype(np.float32)
    rng = np.random.default_rng(3)
    bank = (rng.standard_normal((256, hub_cfg.final_dim)) * 0.5).astype(np.float32)
    return JaxVoiceConverter(
        synth_cfg=cfg, synth_params=params, hubert_cfg=hub_cfg,
        hubert_params=jax_hubert_state(hub_sd, hub_cfg),
        rmvpe_params=jax_rmvpe_state(jax_synthetic.make_rmvpe_state(seed=4)),
        index_bank=bank, engine=JaxEngineConfig(**SMOKE_ENGINE))


def _assert_same_tree(a, b, path="root"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def _convert_both(vc, jvc, seconds, opts):
    song = _bench_song(seconds)
    out, sr = vc.convert(song, ConversionOptions(**opts))
    ref, jsr = jvc.convert(song, JaxOptions(**opts))
    assert sr == jsr and out.dtype == np.int16 and out.shape == ref.shape
    assert np.abs(out).max() > 1000  # not silent
    return mel_distortion_db(out, ref, sr)


@pytest.fixture(scope="module")
def nof0():
    """A no-f0 model (use_f0=False: no pitch embedding, no source, no
    RMVPE), on both sides, built once for this file."""
    vc, model = _port_converter(use_f0=False)
    jvc = jax_build_converter(tiny=True, sr=48000, index_vectors=256, use_f0=False,
                              engine=JaxEngineConfig(**SMOKE_ENGINE))
    return vc, jvc, model


def test_nof0_model_set_matches_the_jax_factory(nof0):
    _, jvc, (cfg, params, _, _, rmvpe, bank) = nof0
    assert not cfg.use_f0 and rmvpe is None and jvc.rmvpe_params is None
    assert "emb_pitch" not in params["enc_p"] and "m_source" not in params["dec"]
    _assert_same_tree(params, jax.tree.map(np.asarray, jvc.synth_params))
    assert np.array_equal(bank, np.asarray(jvc.index_bank))


def test_generator_matches_jax(nof0):
    """The no-f0 generator through the load-time packing (the tiny stages,
    16, 8 and 4 wide, padded to 32) against JAX's, noise-free: fp32 order
    through the padded convs, 2e-4 absolute."""
    _, _, (cfg, params, *_) = nof0
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, cfg.inter_channels, 40)) * 0.5).astype(np.float32)
    g = rng.standard_normal((2, cfg.gin_channels, 1)).astype(np.float32)
    dec = pack_decoder_weights(params_to_torch(params["dec"]), cfg)
    assert [up["w"].shape[1] for up in dec["ups"]] == [32] * 4
    got = generator(dec, cfg, torch.from_numpy(x), torch.from_numpy(g)).numpy()
    ref = np.asarray(jax_generator(jax.tree.map(jnp.asarray, params["dec"]), cfg,
                                   jnp.asarray(x), jnp.asarray(g)))
    assert got.shape == ref.shape == (2, 40 * cfg.upp)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("seconds", [3.0, 0.5])
def test_convert_nof0_matches_jax(nof0, seconds):
    """No F0 pass, no pitch into the synthesizer, protect off; the source
    noise is drawn and unused on both sides. 0.5 s: a sub-second input in
    one chunk, HuBERT's minimum window respected."""
    vc, jvc, _ = nof0
    calls = []
    vc2 = copy.copy(vc)
    vc2.compute_f0 = lambda *a, **k: calls.append(a)
    dist = _convert_both(vc2, jvc, seconds, dict(BENCH_OPTS))
    assert calls == []
    assert dist < 0.5, f"mel distortion {dist:.3f} dB"


@pytest.mark.parametrize("sr", [40000, 32000])
def test_convert_f0_model_matches_jax_at(sr):
    """The v2 f0 model at 40 kHz (u = 10, 10, 2, 2; k = 16 gives one-tap
    phases) and 32 kHz (u = 10, 8, 2, 2), on rmvpe+."""
    vc, _ = _port_converter(sr=sr)
    jvc = jax_build_converter(tiny=True, sr=sr, index_vectors=256,
                              engine=JaxEngineConfig(**SMOKE_ENGINE))
    dist = _convert_both(vc, jvc, 2.0, dict(BENCH_OPTS))
    assert dist < 0.5, f"mel distortion {dist:.3f} dB at {sr} Hz"


def test_convert_v1_matches_jax(monkeypatch):
    """A v1 model of the published 48 kHz v1 shape (five stages): HuBERT's
    layer-9-or-last output through final_proj into a 256-wide content
    input (final_proj's width at tiny size), on rmvpe+."""
    monkeypatch.setitem(jax_synthetic.V2_CONFIGS, 48000, V1_RATES[48000])
    vc, model = _port_converter(version="v1")
    jvc = _jax_v1_converter(48000)
    assert vc.version == jvc.version == "v1"
    assert model[0].input_dim == 256 and len(model[0].upsample_rates) == 5
    _assert_same_tree(model[1], jax.tree.map(np.asarray, jvc.synth_params))
    dist = _convert_both(vc, jvc, 2.0, dict(BENCH_OPTS))
    assert dist < 0.5, f"mel distortion {dist:.3f} dB"


@pytest.mark.parametrize("sr", [32000, 40000, 48000])
def test_v1_config_list_is_the_published_one(sr):
    """version="v1" picks configs/v1's decoder (40 kHz: v2's rates, as
    published); v2 keeps the JAX factory's list."""
    v1 = V1_RATES.get(sr, jax_synthetic.V2_CONFIGS[sr])
    for tiny in (True, False):
        got = port_synthetic.rvc_config_list(sr, tiny=tiny, version="v1")
        assert (got[0], got[12], got[14]) == (v1["spec"], v1["up_rates"], v1["up_k"])
        v2 = jax_synthetic.rvc_config_list(sr, tiny=tiny)
        assert got[:12] + got[13:14] + got[15:] == v2[:12] + v2[13:14] + v2[15:]
        assert port_synthetic.rvc_config_list(sr, tiny=tiny) == v2


@pytest.mark.parametrize("sr", [48000, 32000])
def test_v1_decoder_shapes_match_jax(sr, monkeypatch):
    """The published v1 decoders at tiny width: five stages (64 -> 32, 16,
    8, 4, 2 channels, each padded to 32 at load), and at 32 kHz a second
    stage of u = 4, k = 16, padding 6: four taps a phase at offsets -2..2.
    The port's generator_nsf through pack_decoder_weights against JAX's
    (XLA's conv_transpose keeps every tap), noise-free, 2e-4 absolute."""
    monkeypatch.setitem(jax_synthetic.V2_CONFIGS, sr, V1_RATES[sr])
    cpt = port_synthetic.make_rvc_checkpoint(sr=sr, tiny=True, seed=7, version="v1")
    jcpt = jax_synthetic.make_rvc_checkpoint(sr=sr, tiny=True, seed=7, version="v1")
    cfg = build_config(cpt["config"], use_f0=True, version="v1")
    jcfg = jax_build_config(jcpt["config"], use_f0=True, version="v1")
    params = convert_synthesizer_state(cpt["weight"], cfg)["dec"]
    jparams = jax_synth_state(jcpt["weight"], jcfg)["dec"]
    _assert_same_tree(params, jparams)
    if sr == 32000:
        assert phase_taps(4, 6) == [[-2, -1, 0, 1]] * 2 + [[-1, 0, 1, 2]] * 2
    dec = pack_decoder_weights(params_to_torch(params), cfg)
    assert [up["w"].shape[1] for up in dec["ups"]] == [32] * 5
    assert dec["conv_post"]["w"].shape == (1, 32, 7)
    rng = np.random.default_rng(sr)
    t = 24
    x = (rng.standard_normal((2, cfg.inter_channels, t)) * 0.5).astype(np.float32)
    f0 = (150.0 + 100.0 * rng.random((2, t))).astype(np.float32)
    f0[:, :4] = 0.0
    g = rng.standard_normal((2, cfg.gin_channels, 1)).astype(np.float32)
    got = generator_nsf(dec, cfg, *map(torch.from_numpy, (x, f0, g))).numpy()
    ref = np.asarray(jax_generator_nsf(jax.tree.map(jnp.asarray, jparams), jcfg,
                                       jnp.asarray(x), jnp.asarray(f0), jnp.asarray(g)))
    assert got.shape == ref.shape == (2, t * cfg.upp)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
