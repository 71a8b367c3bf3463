"""The port's mangio-crepe F0 path against the JAX package's, on the CPU.

Weights are the same numpy tree on both sides (the port's own copy of the
builders gives it bit for bit); inputs are made with numpy from a seed. The
salience runs at a narrow CrepeConfig (FULL_LAYERS' kernels, strides and
pads at 32/16/16/16/16/32 channels), which the JAX engine also runs, since
it reads only strides and pads from its default config. The JAX side runs
as its own tests run it on the CPU: XLA, with the Viterbi's Pallas kernel
in interpret mode.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polgen_rvc_tpu.convert import crepe_ckpt as jax_ckpt
from polgen_rvc_tpu.models import crepe as jcrepe
from polgen_rvc_tpu.ops.pallas_viterbi import viterbi_path_pallas
from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_builder
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.convert import crepe_ckpt
from polgen_rvc_tpu_torch.convert.params import params_to_torch
from polgen_rvc_tpu_torch.models import crepe
from polgen_rvc_tpu_torch.ops.filters import highpass_pad_quant
from polgen_rvc_tpu_torch.ops.viterbi import LOG_EPS, LOG_INIT, band_table, viterbi_path
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter
from polgen_rvc_tpu_torch.pipeline.factory import synthetic_params

NARROW_LAYERS = ((32, 512, 4, 254, 254), (16, 64, 1, 31, 32), (16, 64, 1, 31, 32),
                 (16, 64, 1, 31, 32), (16, 64, 1, 31, 32), (32, 64, 1, 31, 32))
NARROW = dict(layers=NARROW_LAYERS, in_features=128)  # 32 channels x 4 rows
SMOKE_ENGINE = dict(x_pad=1, x_query=2, x_center=3, x_max=4, chunk_batch=2,
                    bucket_step_s=2)
BENCH_OPTS = dict(index_rate=0.5, protect=0.33, volume_envelope=0.25)
MODEL_NAMES = ("synth_cfg", "synth_params", "hubert_cfg", "hubert_params",
               "rmvpe_params", "index_bank")


def _assert_tree_equal(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def _narrow_params(seed=5):
    cfg = crepe.CrepeConfig(**NARROW)
    return crepe_ckpt.convert_crepe_state(crepe_ckpt.make_crepe_state(seed=seed, cfg=cfg), cfg)


@pytest.mark.parametrize("width", ["full", "narrow"])
def test_crepe_state_bitwise_equal(width):
    kw = {} if width == "full" else NARROW
    cfg, jcfg = crepe.CrepeConfig(**kw), jcrepe.CrepeConfig(**kw)
    sd = crepe_ckpt.make_crepe_state(seed=5, cfg=cfg)
    jsd = jax_ckpt.make_crepe_state(seed=5, cfg=jcfg)
    _assert_tree_equal(sd, jsd)
    _assert_tree_equal(crepe_ckpt.convert_crepe_state(sd, cfg),
                       jax_ckpt.convert_crepe_state(jsd, jcfg))


@pytest.mark.parametrize("start,hop,n_frames", [
    (0, 128, 40),    # the first frames' left halves read the zero pad
    (30, 160, 80),
    (110, 128, 30),  # frames past the end of the buffer
])
def test_crepe_salience_window_matches_jax(start, hop, n_frames):
    rng = np.random.default_rng(start + hop)
    # a zero-tailed buffer, as the engine's bucket is: JAX's
    # take(mode="fill") wraps negative indices to the buffer's end, where
    # the port reads zeros, so the two agree when that end is silent
    buf = (rng.standard_normal(16000) * 8000).astype(np.int16)
    buf[-600:] = 0
    inv = np.float32(1.0 / 32767.0)
    params = _narrow_params()
    ref = np.asarray(jcrepe.crepe_salience_window(
        jax.tree.map(jnp.asarray, params), jnp.asarray(buf)[None], inv,
        jnp.int32(start), jnp.int32(hop), n_frames, jcrepe.CrepeConfig(**NARROW)))
    got = crepe.crepe_salience_window(
        crepe.pack_crepe_weights(params_to_torch(params)), torch.from_numpy(buf),
        float(inv), start, hop, n_frames, crepe.CrepeConfig(**NARROW))
    assert got.dtype == torch.float32 and got.shape == ref.shape == (n_frames, 360)
    # fp32 on both sides, six convs summed in another order: a few fp32
    # ulps on sigmoid outputs in [0, 1]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


def _structured_log_obs(rng, t, n, plateau):
    """test_f0_methods.py's Viterbi cases: a random-walk peak over low
    noise, masked edges, all-tie frames, garbage rows past n."""
    probs = rng.random((t, 360)).astype(np.float32) * 0.01
    c = np.clip(100 + np.cumsum(rng.integers(-3, 4, t)), 0, 359)
    probs[np.arange(t), c] = 0.9
    probs[:, :40] = 0.0
    probs[:, 300:] = 0.0
    if plateau:
        probs[50:70, :] = 0.0  # fully masked frames: every bin ties
    if n < t:
        probs[n:] = rng.random((t - n, 360)).astype(np.float32)
    obs = probs / np.maximum(probs.sum(1, keepdims=True), 1e-20)
    return np.log(obs + 1e-20).astype(np.float32)


def _teleport_tie(m_bin, plateau):
    """(3, 360) log observations whose step 1 meets an exact fp32 tie
    between the teleport candidate from m_bin (the argmax of dp[0]) and the
    in-band best of bin `plateau`, then peaks at `plateau`."""
    bc = band_table()[plateau, 11]  # d = 0, the largest band value
    target = np.float32(np.float32(LOG_INIT + np.float32(0.0)) + LOG_EPS)
    x = np.float32(target - bc - LOG_INIT)
    for _ in range(64):
        v = np.float32(np.float32(LOG_INIT + x) + bc)
        if v == target:
            break
        x = np.nextafter(x, np.float32(np.inf if v < target else -np.inf),
                         dtype=np.float32)
    assert np.float32(np.float32(LOG_INIT + x) + bc) == target
    lo = np.full((3, 360), -100.0, np.float32)
    lo[0, m_bin] = 0.0
    lo[0, plateau - 15:plateau + 16] = x
    lo[1:, plateau] = 0.0
    return lo


@pytest.mark.parametrize("case", ["240/240", "240/224/plateau", "130/111",
                                  "64/64/plateau", "1/1", "tie/teleport", "tie/in-band"])
def test_viterbi_twin_matches_scan_and_pallas(case):
    """The wrapper on a CPU tensor (the plain twin) gives the very paths of
    JAX's lax.scan Viterbi and of its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(sum(map(ord, case)))
    tied = None  # (plateau bin, the source row 0 must take on the tie)
    if case == "tie/teleport":  # m = 0 < in-band source 200: the teleport wins
        lo, n, tied = _teleport_tie(0, 200), 3, (200, 0)
    elif case == "tie/in-band":  # m = 359 > in-band source 100: the band wins
        lo, n, tied = _teleport_tie(359, 100), 3, (100, 100)
    else:
        t, n = (int(v) for v in case.split("/")[:2])
        lo = _structured_log_obs(rng, t, n, case.endswith("plateau"))
    want = np.asarray(jcrepe.viterbi_path_device(jnp.asarray(lo), jnp.int32(n)))
    pallas = np.asarray(viterbi_path_pallas(jnp.asarray(lo), jnp.int32(n),
                                            interpret=True, blk=64))
    got = viterbi_path(torch.from_numpy(lo), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    if tied is not None:
        assert got.tolist() == [tied[1], tied[0], tied[0]]


def test_crepe_decode_matches_jax():
    """Mask, normalize, log, Viterbi and the +-4-bin cents from the same
    f16-rounded salience, rows past n included (pass-through)."""
    rng = np.random.default_rng(7)
    t, n = 300, 280
    sal = rng.random((t, 360)).astype(np.float32) * 0.05
    c = np.clip(150 + np.cumsum(rng.integers(-2, 3, t)), 5, 354)
    for off, v in ((-1, 0.4), (0, 0.9), (1, 0.5)):
        sal[np.arange(t), c + off] = v
    sal16 = sal.astype(np.float16)
    for f0_min, f0_max in ((50.0, 1100.0), (80.0, 700.0)):
        ref = np.asarray(jcrepe.crepe_f0_decode_device(
            jnp.asarray(sal16), jnp.int32(n), f0_min=f0_min, f0_max=f0_max))
        got = crepe.crepe_f0_decode_device(torch.from_numpy(sal16), n,
                                           f0_min=f0_min, f0_max=f0_max)
        # the same path (a one-bin flip would move f0 by 1.2%); the cents
        # sums of 9 terms in another order: 1e-5 relative
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,p_len", [(50, 80), (80, 50), (64, 64), (1, 10), (10, 1),
                                     (33, 97)])
def test_crepe_resize_matches_jax_and_np_interp(n, p_len):
    rng = np.random.default_rng(n * 100 + p_len)
    f0 = (100.0 + 50.0 * rng.random(n)).astype(np.float32)
    f0[rng.random(n) < 0.25] = 0.0  # sub-threshold: nan in the reference post
    out_size = max(p_len, n) + 7
    got = crepe.crepe_resize_device(torch.from_numpy(f0), n, p_len, out_size).numpy()
    ref = np.asarray(jcrepe.crepe_resize_device(jnp.asarray(f0), jnp.int32(n),
                                                jnp.int32(p_len), out_size))
    source = f0.astype(np.float64)
    source[source < 0.001] = np.nan
    host = np.nan_to_num(np.interp(np.arange(0, n * p_len, n) / p_len,
                                   np.arange(n), source)).astype(np.float32)
    # the same grid index both sides (int64 here, JAX's exact int32 trick);
    # s0 + frac * (s1 - s0) may round once differently (1e-6 relative)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:p_len], host, rtol=1e-5, atol=1e-4)
    assert np.all(got[p_len:] == 0)


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


@pytest.fixture(scope="module")
def tiny_model():
    """bench.py's CPU-smoke model set (its full-width RMVPE is the costly
    part), built once for this file."""
    return synthetic_params(tiny=True, sr=48000, index_vectors=256, seed=0)


def test_convert_mangio_crepe_matches_jax_end_to_end(tiny_model):
    song = _bench_song(3.0)
    crepe_np = _narrow_params()
    vc = VoiceConverter(**dict(zip(MODEL_NAMES, tiny_model)),
                        engine=EngineConfig(**SMOKE_ENGINE), device="cpu",
                        noise_provider=_jax_noise, crepe_params=crepe_np)
    jvc = jax_builder(tiny=True, sr=48000, index_vectors=256,
                      engine=JaxEngineConfig(**SMOKE_ENGINE))
    jvc.crepe_params = jax.tree.map(jnp.asarray, crepe_np)
    opts = dict(f0_method="mangio-crepe", hop_length=160, pitch=2.0, **BENCH_OPTS)

    # the F0 alone: the port's compute_f0 against JAX's device crepe path
    _, qbuf, inv_scale, padded_len = highpass_pad_quant(song, vc.engine.t_pad)
    pitch, pitchf = vc.compute_f0(torch.from_numpy(qbuf).float() * float(inv_scale),
                                  ConversionOptions(**opts), padded_len)
    _, uploaded, _, plan = jvc._upload_preamble(song)
    p_len = plan.padded_audio.shape[0] // 160
    assert padded_len == plan.padded_audio.shape[0]
    jpitch, jpitchf = (np.asarray(a)[0] for a in jvc.compute_f0_device(
        plan.padded_audio, p_len, JaxOptions(**opts), uploaded))
    assert pitch.shape == pitchf.shape == jpitch.shape == (qbuf.shape[0] // 160 + 1,)
    # fp32 conv order can flip a Viterbi near-tie: the bounds JAX holds its
    # own two crepe paths to (test_f0_methods.py)
    rel = np.abs(pitchf.numpy() - jpitchf) / np.maximum(np.abs(jpitchf), 1.0)
    assert np.median(rel[:p_len]) < 1e-4
    assert np.mean(pitch.numpy()[:p_len] == jpitch[:p_len]) >= 0.98
    assert np.all(pitchf.numpy()[p_len:] == 0) and np.all(jpitchf[p_len:] == 0)
    assert np.mean(pitchf.numpy()[:p_len] > 0) > 0.5  # voiced, not all gated

    out, sr = vc.convert(song, ConversionOptions(**opts))
    ref, jsr = jvc.convert(song, JaxOptions(**opts))
    assert sr == jsr == 48000 and out.shape == ref.shape
    assert np.abs(out).max() > 1000
    dist = mel_distortion_db(out, ref, sr)
    assert dist < 0.5, f"mel distortion {dist:.3f} dB"


def test_f0_method_guards(tiny_model):
    """fcpe and mangio-crepe without their weights raise."""
    vc = VoiceConverter(**dict(zip(MODEL_NAMES, tiny_model)),
                        engine=EngineConfig(**SMOKE_ENGINE), device="cpu")
    song = _bench_song(1.0)
    with pytest.raises(RuntimeError, match="fcpe weights not loaded"):
        vc.convert(song, ConversionOptions(f0_method="fcpe"))
    with pytest.raises(RuntimeError, match="crepe weights not loaded"):
        vc.convert(song, ConversionOptions(f0_method="mangio-crepe"))
    vc2 = copy.copy(vc)
    vc2.crepe_params = crepe.pack_crepe_weights(params_to_torch(_narrow_params()))
    buf = torch.zeros(16000 * 4)
    with pytest.raises(ValueError, match="padded signal length"):
        vc2.compute_f0(buf, ConversionOptions(f0_method="mangio-crepe"))
