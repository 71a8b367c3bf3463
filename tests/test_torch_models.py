"""Module parity on the CPU: each model function of the port against its JAX
counterpart, with identical weights (the same synthetic seed) and inputs
made with numpy. Both sides run fp32 here; the JAX side takes its XLA path,
the port its kernels' plain twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polgen_rvc_tpu.models import hubert as jhub
from polgen_rvc_tpu.models import nsf as jnsf
from polgen_rvc_tpu.models import rmvpe as jrmvpe
from polgen_rvc_tpu.models import synthesizer as jsyn
from polgen_rvc_tpu.pipeline.config import EngineConfig as JaxEngineConfig
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_builder
from polgen_rvc_tpu.retrieval.topk import retrieval_blend as jax_blend
from polgen_rvc_tpu_torch.convert.params import params_to_torch
from polgen_rvc_tpu_torch.models import hubert, nsf, rmvpe, synthesizer
from polgen_rvc_tpu_torch.ops.filters import highpass_pad_quant
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter
from polgen_rvc_tpu_torch.pipeline.factory import synthetic_params
from polgen_rvc_tpu_torch.retrieval.topk import retrieval_blend, topk_neighbours


@pytest.fixture(scope="module")
def tiny():
    return synthetic_params(tiny=True, sr=48000, index_vectors=256, seed=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rmvpe_mel_and_salience(tiny):
    rmvpe_np = tiny[4]
    rng = np.random.default_rng(0)
    # 32 frames: the U-Net's smallest input (pooled 16x, then 2x more)
    audio = (rng.standard_normal((1, 160 * 31)) * 0.1).astype(np.float32)
    mel = rmvpe.rmvpe_mel(_t(audio))
    jmel = np.asarray(jrmvpe.rmvpe_mel(jnp.asarray(audio)))
    # torch.stft (FFT) vs a float32 DFT matmul: ~1e-6 relative on |X|,
    # and log(mel) of a 0.1-amplitude signal: 1e-4 absolute
    np.testing.assert_allclose(mel.numpy(), jmel, rtol=0, atol=1e-4)

    mel_p, n = rmvpe.pad_frames_to_32(_t(jmel))
    jmel_p, jn = jrmvpe.pad_frames_to_32(jnp.asarray(jmel))
    assert n == jn and np.array_equal(mel_p.numpy(), np.asarray(jmel_p))
    sal = rmvpe.rmvpe_salience(params_to_torch(rmvpe_np), mel_p)
    jsal = np.asarray(jrmvpe.rmvpe_salience(
        jax.tree.map(jnp.asarray, rmvpe_np), jnp.asarray(jmel_p)))
    # fp32 U-Net + BiGRU on both sides: sigmoid outputs agree to 1e-4
    np.testing.assert_allclose(sal.numpy(), jsal, rtol=0, atol=1e-4)


def test_rmvpe_plus_f0_step_coarse_pitch_exact(tiny):
    """The engine's full-signal rmvpe+ F0 step: dequantized int16 signal ->
    mel -> U-Net -> BiGRU -> cents -> range gate -> shift -> coarse bins."""
    eng = dict(x_pad=1, x_query=2, x_center=3, x_max=4, chunk_batch=2,
               bucket_step_s=2)
    # the fixture's weights are build_synthetic_converter's (same seed)
    names = ("synth_cfg", "synth_params", "hubert_cfg", "hubert_params",
             "rmvpe_params", "index_bank")
    vc = VoiceConverter(**dict(zip(names, tiny)), engine=EngineConfig(**eng),
                        device="cpu")
    jvc = jax_builder(tiny=True, engine=JaxEngineConfig(**eng))
    t = np.arange(int(1.5 * 16000)) / 16000
    song = (0.4 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
            ).astype(np.float32)
    opts = ConversionOptions(pitch=3.0)
    _, qbuf, inv_scale, _ = highpass_pad_quant(song, 16000)
    pitch, pitchf = vc.compute_f0(_t(qbuf).float() * float(inv_scale), opts)
    shift = np.float32(2.0 ** (opts.pitch / 12.0))
    _, jpitch, jpitchf = jvc._f0_fn(qbuf.shape[0], 50.0, 1100.0)(
        jvc.rmvpe_params, jnp.asarray(qbuf)[None], inv_scale, 0.03, shift)
    assert np.array_equal(pitch.numpy(), np.asarray(jpitch)[0])  # exact bins
    # Hz after the cents decode: 1e-3 relative (float32 salience ~1e-5)
    np.testing.assert_allclose(pitchf.numpy(), np.asarray(jpitchf)[0],
                               rtol=1e-3, atol=1e-3)


def test_hubert_extract_with_padding_mask(tiny):
    hub_cfg, hub_np = tiny[2], tiny[3]
    rng = np.random.default_rng(1)
    wav = (rng.standard_normal((2, 8000)) * 0.2).astype(np.float32)
    valid = np.array([8000, 5000])
    wav[1, 5000:] = 0.0
    frames = hub_cfg.num_frames(8000)
    hub_valid = np.array([hub_cfg.num_frames(int(v)) for v in valid])
    pad = np.arange(frames)[None, :] >= hub_valid[:, None]
    got = hubert.hubert_extract(params_to_torch(hub_np), hub_cfg, _t(wav),
                                padding_mask=_t(pad), valid_samples=_t(valid))
    ref = jhub.hubert_extract(jax.tree.map(jnp.asarray, hub_np), hub_cfg,
                              jnp.asarray(wav), padding_mask=jnp.asarray(pad),
                              valid_samples=jnp.asarray(valid))
    # fp32 conv/attention stack: 1e-4 on LayerNorm-scale features
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_retrieval_blend_topk_indices_equal(tiny):
    bank = tiny[5]
    rng = np.random.default_rng(2)
    feats = (rng.standard_normal((2, 30, bank.shape[1])) * 0.5).astype(np.float32)
    _, idx = topk_neighbours(_t(feats), _t(bank), 8)
    f, b = jnp.asarray(feats), jnp.asarray(bank)
    d2 = (jnp.sum(f * f, -1, keepdims=True) - 2.0 * jnp.einsum("btd,nd->btn", f, b)
          + jnp.sum(b * b, -1)[None, None, :])
    _, jidx = jax.lax.top_k(-d2, 8)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    got = retrieval_blend(_t(feats), _t(bank), 0.5)
    ref = jax_blend(f, b, 0.5, exact=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _synth_inputs(dim, b=2, t=64):
    rng = np.random.default_rng(3)
    phone = (rng.standard_normal((b, t, dim)) * 0.5).astype(np.float32)
    lens = np.array([t, 40])[:b]
    mask = (np.arange(t)[None, None, :] < lens[:, None, None]).astype(np.float32)
    f0 = rng.uniform(100, 400, (b, t)).astype(np.float32)
    f0[:, 10:14] = 0.0  # an unvoiced stretch
    pitch = rng.integers(1, 256, (b, t)).astype(np.int64)
    return phone, mask, pitch, f0


def test_synthesizer_infer_noise_free(tiny):
    cfg, params_np = tiny[0], tiny[1]
    # the tiny HuBERT is 64 wide: the builder sized emb_phone to it
    phone, mask, pitch, f0 = _synth_inputs(params_np["enc_p"]["emb_phone"]["w"].shape[0])
    got = synthesizer.synthesizer_infer(
        params_to_torch(params_np), cfg, _t(phone), _t(mask), _t(pitch), _t(f0))
    ref = jsyn.synthesizer_infer(
        jax.tree.map(jnp.asarray, params_np), cfg, jnp.asarray(phone),
        jnp.asarray(mask), jnp.asarray(pitch.astype(np.int32)), jnp.asarray(f0),
        sid=0, rng=None)
    assert got.shape == ref.shape == (2, 64 * cfg.upp)
    # fp32 through enc_p, the flow and the decoder to a tanh waveform:
    # 2e-4 absolute (summation order across ~40 layers)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-4)


def test_generator_nsf_with_injected_noise(tiny):
    cfg, params_np = tiny[0], tiny[1]
    rng = np.random.default_rng(4)
    b, t, nf = 2, 24, 30
    x = (rng.standard_normal((b, cfg.inter_channels, t)) * 0.5).astype(np.float32)
    f0 = rng.uniform(80, 300, (b, t)).astype(np.float32)
    f0[0, :5] = 0.0
    g = rng.standard_normal((b, cfg.gin_channels, 1)).astype(np.float32)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(
        jnp.arange(b))
    noise = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (nf * cfg.upp,), jnp.float32))(keys))
    dec = params_np["dec"]
    got = nsf.generator_nsf(params_to_torch(dec), cfg, _t(x), _t(f0), _t(g),
                            noise=_t(noise))
    ref = jnsf.generator_nsf(jax.tree.map(jnp.asarray, dec), cfg, jnp.asarray(x),
                             jnp.asarray(f0), jnp.asarray(g), rng=keys,
                             noise_frames=nf)
    # fp32 decoder on the same noise; the closed-form sine phase cumsum
    # runs in another order: 2e-4 absolute on the tanh waveform
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-4)
