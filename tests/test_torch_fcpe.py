"""The port's fcpe F0 path against the JAX package's, on the CPU.

Weights are the same numpy tree on both sides (the port's own copy of the
factories gives it bit for bit); inputs are made with numpy from a seed.
FCPE has no Pallas kernel, so the JAX side is plain XLA here as on its
own tests. The convert runs bench.py's CPU-smoke engine with the JAX
engine's own noise draws, so the two renditions differ only by float32
arithmetic order.
"""

import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polgen_rvc_tpu.convert import fcpe_ckpt as jax_ckpt
from polgen_rvc_tpu.models import fcpe as jfcpe
from polgen_rvc_tpu.pipeline.fcpe_method import fcpe_f0 as jax_fcpe_f0
from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_build_converter
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.convert import fcpe_ckpt
from polgen_rvc_tpu_torch.convert.params import params_to_torch
from polgen_rvc_tpu_torch.models import fcpe
from polgen_rvc_tpu_torch.ops.f0_utils import coarse_f0
from polgen_rvc_tpu_torch.ops.filters import highpass_pad_quant
from polgen_rvc_tpu_torch.pipeline import engine as engine_mod
from polgen_rvc_tpu_torch.pipeline import fcpe_method
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter
from polgen_rvc_tpu_torch.pipeline.factory import synthetic_params

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


@pytest.fixture(scope="module")
def tiny_fcpe():
    """The tiny FCPE (2 layers x 64 channels), numpy tree and config."""
    cfg, sd = fcpe_ckpt.make_fcpe_state(tiny=True, seed=6)
    return cfg, fcpe_ckpt.convert_fcpe_state(sd, cfg)


def _jcfg(cfg):
    return jfcpe.FcpeConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("tiny", [True, False])
def test_fcpe_weights_bitwise_equal_to_jax(tiny):
    cfg, sd = fcpe_ckpt.make_fcpe_state(tiny=tiny, seed=6)
    jcfg, jsd = jax_ckpt.make_fcpe_state(tiny=tiny, seed=6)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert sd.keys() == jsd.keys()
    for k in sd:
        assert np.array_equal(sd[k], jsd[k]), k
    _assert_tree_equal(fcpe_ckpt.convert_fcpe_state(sd, cfg),
                       jax_ckpt.convert_fcpe_state(jsd, jcfg))
    assert np.array_equal(cfg.cent_table(), jcfg.cent_table())
    cfg_dict = {"model": {"n_layers": 3, "n_chans": 96, "out_dims": 300},
                "mel": {"hop_size": 320, "fmax": 7000}}
    assert (dataclasses.asdict(fcpe_ckpt.build_fcpe_config(cfg_dict))
            == dataclasses.asdict(jax_ckpt.build_fcpe_config(cfg_dict)))


def test_load_fcpe_checkpoint(tmp_path, tiny_fcpe):
    """A torch.save'd {config, model} file, as the reference stores fcpe.pt,
    loads to the factories' config and tree."""
    cfg, sd = fcpe_ckpt.make_fcpe_state(tiny=True, seed=6)
    path = tmp_path / "fcpe.pt"
    torch.save({"config": {"model": {"n_layers": cfg.n_layers,
                                     "n_chans": cfg.n_chans},
                           "mel": {"hop_size": cfg.hop_size}},
                "model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    got_cfg, got = fcpe_ckpt.load_fcpe_checkpoint(str(path))
    assert got_cfg == cfg
    _assert_tree_equal(got, tiny_fcpe[1])


MEL_LENGTHS = (16000, 16160, 16001, 700, 300)

# both sides' log-mels of every case, in a Python process of their own
_FRESH_MELS = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import dataclasses
import jax.numpy as jnp
import numpy as np
import torch
from polgen_rvc_tpu.models import fcpe as jfcpe
from polgen_rvc_tpu_torch.convert import fcpe_ckpt
from polgen_rvc_tpu_torch.models import fcpe
cfg, _ = fcpe_ckpt.make_fcpe_state(tiny=True, seed=6)
jcfg = jfcpe.FcpeConfig(**dataclasses.asdict(cfg))
out = {}
for t in map(int, sys.argv[2:]):
    audio = (np.random.default_rng(t).standard_normal((2, t)) * 0.3).astype(np.float32)
    out[f"got{t}"] = fcpe.fcpe_mel(torch.from_numpy(audio), cfg).numpy()
    out[f"ref{t}"] = np.asarray(jfcpe.fcpe_mel(jnp.asarray(audio), jcfg))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def fresh_mels(tmp_path_factory):
    """The cases' mels from both packages, computed in a new process. In
    the tier-1 run a worker carries whatever the files it ran before left
    in the process, and there the two sides once differed by up to 2.2e-4
    at 16,000 samples on 1.5% of the elements, where a process of its own
    reads 2.1e-6 (at 1, 2, 4 and 8 torch threads, with and without JAX's
    persistent compilation cache, and after test_torch_kernels.py or
    test_torch_crepe.py in one process). The comparison is of the two
    functions, so it runs where nothing else has run."""
    path = tmp_path_factory.mktemp("fcpe_mel") / "mels.npz"
    root = Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    subprocess.run([sys.executable, "-c", _FRESH_MELS, str(path), *map(str, MEL_LENGTHS)],
                   cwd=root, env=env, check=True, timeout=600)
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("t", MEL_LENGTHS)
def test_fcpe_mel_matches_jax(t, tiny_fcpe, fresh_mels):
    """Reflect padding, the zero padding of a signal shorter than its right
    pad (700, 300), T = k * hop and off it; the repeated last frame. The
    port's FFT against JAX's DFT matmul: 1e-4 on the log-mel (the RMVPE
    mel's precedent)."""
    cfg = tiny_fcpe[0]
    got, ref = fresh_mels[f"got{t}"], fresh_mels[f"ref{t}"]
    assert got.shape == ref.shape == (2, t // cfg.hop_size + 1, cfg.num_mels)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_valid", [None, 150])
def test_fcpe_salience_matches_jax(n_valid, tiny_fcpe):
    """On a bucket-padded mel (junk past frame 150), with and without
    n_valid: fp32 order only, 1e-4 absolute."""
    cfg, params = tiny_fcpe
    rng = np.random.default_rng(1)
    mel = (rng.standard_normal((1, 256, cfg.input_channel)) * 0.5).astype(np.float32)
    mel[:, 150:] = rng.standard_normal((1, 106, cfg.input_channel)) * 2.0
    got = fcpe.fcpe_salience(params_to_torch(params), cfg, torch.from_numpy(mel),
                             n_valid=n_valid).numpy()
    ref = np.asarray(jfcpe.fcpe_salience(
        jax.tree.map(jnp.asarray, params), _jcfg(cfg), jnp.asarray(mel),
        n_valid=None if n_valid is None else jnp.int32(n_valid)))
    assert got.shape == (1, 256, 360)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_fcpe_salience_mask_invariant(tiny_fcpe):
    """n_valid on a padded mel gives the unpadded run's frames [0, n) (the
    JAX package's own bound, 2e-5)."""
    cfg, params = tiny_fcpe
    tp = params_to_torch(params)
    rng = np.random.default_rng(2)
    mel = torch.from_numpy((rng.standard_normal((1, 96, cfg.input_channel)) * 0.5
                            ).astype(np.float32))
    junk = torch.from_numpy(rng.standard_normal((1, 64, cfg.input_channel)
                                                ).astype(np.float32))
    full = fcpe.fcpe_salience(tp, cfg, mel)
    masked = fcpe.fcpe_salience(tp, cfg, torch.cat([mel, junk], dim=1), n_valid=96)
    np.testing.assert_allclose(masked[:, :96].numpy(), full.numpy(), atol=2e-5, rtol=0)


def test_fcpe_decode_matches_jax(tiny_fcpe):
    """The same salience both sides, peaks at the table's edges included:
    the same argmax and window; the 9-term cents sums in another order
    (1e-5 relative on the voiced frames); the unvoiced frames exactly 0."""
    cfg = tiny_fcpe[0]
    rng = np.random.default_rng(3)
    sal = (rng.random((2, 400, 360)) * 0.02).astype(np.float32)
    peaks = rng.integers(0, 360, (2, 400))
    peaks[0, :3] = [0, 2, 359]
    sal[np.arange(2)[:, None], np.arange(400)[None, :], peaks] = rng.random((2, 400)) * 0.9
    got = fcpe.fcpe_decode(torch.from_numpy(sal), cfg, 0.03).numpy()
    ref = np.asarray(jfcpe.fcpe_decode(jnp.asarray(sal), _jcfg(cfg), 0.03))
    voiced = ref > 0
    assert np.array_equal(got > 0, voiced) and voiced.mean() > 0.5
    np.testing.assert_allclose(got[voiced], ref[voiced], rtol=1e-5, atol=0)


@pytest.mark.parametrize("n,p_len,size", [
    (50, 80, 90), (80, 50, 81), (64, 64, 70), (1, 10, 12), (10, 1, 11),
    (33, 97, 100),
    (50000, 50000, 50176),    # identity past i * n >= 2^31
    (46000, 60000, 60160),    # a resize at wrap-prone magnitudes
])
def test_fcpe_resize_fill_equals_jax(n, p_len, size):
    """Exactly JAX's, unvoiced gaps and edges included: the same source
    index (int64 here, JAX's exact int32 correction) and the same float32
    interpolation."""
    rng = np.random.default_rng(n + p_len)
    f0 = (100.0 + 300.0 * rng.random(size)).astype(np.float32)
    f0[rng.random(size) < 0.3] = 0.0
    f0[:3] = 0.0
    got = fcpe.fcpe_resize_fill(torch.from_numpy(f0), n, p_len).numpy()
    ref = np.asarray(jfcpe.fcpe_resize_fill(jnp.asarray(f0), jnp.int32(n),
                                            jnp.int32(p_len)))
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)
    if n == p_len == 50000:  # no gaps where every frame is voiced
        f0 = np.arange(1, size + 1, dtype=np.float32)
        out = fcpe.fcpe_resize_fill(torch.from_numpy(f0), n, p_len).numpy()
        assert np.array_equal(out[:p_len], f0[:p_len]) and np.all(out[p_len:] == 0)


@pytest.mark.parametrize("f0,p_len", [
    ([0, 0, 100, 0, 0, 200, 0, 0], 8), ([0, 0, 100, 0, 0, 200, 0, 0], 13),
    ([0, 0, 0], 5), ([0, 150.0, 0], 5), ([120.0, 0, 130.0, 140.0], 3),
])
def test_fcpe_post_process_equals_jax(f0, p_len):
    f0 = np.asarray(f0, np.float32)
    got = fcpe.fcpe_post_process(f0.copy(), p_len, 160, 16000)
    ref = jfcpe.fcpe_post_process(f0.copy(), p_len, 160, 16000)
    assert got.dtype == ref.dtype == np.float32 and np.array_equal(got, ref)


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
def converters():
    """bench.py's CPU-smoke model set with the tiny FCPE, on both sides."""
    *model, (fcpe_cfg, fcpe_params) = synthetic_params(
        tiny=True, sr=48000, index_vectors=256, seed=0, with_fcpe=True)
    vc = VoiceConverter(**dict(zip(MODEL_NAMES, model)),
                        engine=EngineConfig(**SMOKE_ENGINE), device="cpu",
                        noise_provider=_jax_noise, fcpe_params=fcpe_params,
                        fcpe_cfg=fcpe_cfg)
    jvc = jax_build_converter(tiny=True, sr=48000, index_vectors=256,
                              engine=JaxEngineConfig(**SMOKE_ENGINE), with_fcpe=True)
    return vc, jvc


def test_convert_fcpe_matches_jax_end_to_end(converters):
    vc, jvc = converters
    song = _bench_song(3.0)
    opts = dict(f0_method="fcpe", pitch=2.0, **BENCH_OPTS)

    # the F0 alone: the port's compute_f0 against JAX's device fcpe path
    _, qbuf, inv_scale, padded_len = highpass_pad_quant(song, vc.engine.t_pad)
    pitch, pitchf = vc.compute_f0(torch.from_numpy(qbuf).float() * float(inv_scale),
                                  ConversionOptions(**opts), padded_len)
    _, uploaded, _, plan = jvc._upload_preamble(song)
    p_len = plan.padded_audio.shape[0] // 160
    assert padded_len == plan.padded_audio.shape[0]
    jpitch, jpitchf = (np.asarray(a)[0] for a in jvc.compute_f0_device(
        plan.padded_audio, p_len, JaxOptions(**opts), uploaded))
    assert pitch.shape == pitchf.shape == jpitch.shape == (qbuf.shape[0] // 160 + 1,)
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


def test_fcpe_host_path_tracks_device_path(converters):
    """The host path (fcpe_f0 on buf[:padded_len], the predictor's post)
    against the device path at the same hop, through the pitch shift and
    coarse bins: the JAX package's bounds for its own two paths, away from
    the bucket tail (the last frames see zero- against reflect-padding)."""
    vc = converters[0]
    cfg, params = vc.fcpe_cfg, vc.fcpe_params
    song = _bench_song(3.0)
    _, qbuf, inv_scale, padded_len = highpass_pad_quant(song, vc.engine.t_pad)
    buf = torch.from_numpy(qbuf).float() * float(inv_scale)
    p_len = padded_len // vc.engine.window
    shift = 2.0 ** (2.0 / 12.0)
    pitchf_d = fcpe_method.fcpe_f0_device(params, cfg, buf, padded_len, p_len)
    pitchf_d = pitchf_d * float(np.float32(shift))
    pitchf_h = torch.from_numpy((fcpe_method.fcpe_f0(params, cfg, buf[:padded_len], p_len)
                                 * shift).astype(np.float32))
    assert pitchf_d.shape == (qbuf.shape[0] // 160 + 1,) and pitchf_h.shape == (p_len,)
    pitch_d, pitch_h = (coarse_f0(a).numpy() for a in (pitchf_d, pitchf_h))
    pitchf_d, pitchf_h = pitchf_d.numpy(), pitchf_h.numpy()
    n_cmp = p_len - 10
    rel = np.abs(pitchf_d[:n_cmp] - pitchf_h[:n_cmp]) / np.maximum(
        np.abs(pitchf_h[:n_cmp]), 1.0)
    assert np.median(rel) < 1e-4
    assert np.mean(rel < 1e-2) > 0.95, f"fcpe device/host diverge: {rel.max()}"
    assert np.mean(pitch_d[:n_cmp] == pitch_h[:n_cmp]) > 0.95


@pytest.mark.parametrize("hop", [160, 320])
def test_fcpe_host_path_matches_jax(converters, hop):
    """The host path as a whole (fcpe_f0: 1,024-frame buckets, n_valid,
    threshold 0.03, the predictor's post onto p_len frames) against the
    JAX package's fcpe_f0 on the same padded float signal, at the window's
    hop and at twice it; then, off the window, the engine's compute_f0 (on
    the int16-quantized bucket) against the JAX compute_f0 through the
    pitch shift and coarse bins. The bounds of tests/test_f0_methods.py
    for the JAX package's own two fcpe paths."""
    vc, jvc = converters
    cfg = dataclasses.replace(vc.fcpe_cfg, hop_size=hop)
    jv = copy.copy(jvc)
    jv.fcpe_cfg, jv._fcpe_fns = _jcfg(cfg), {}
    song = _bench_song(3.0)
    audio = np.asarray(jvc._upload_preamble(song)[3].padded_audio, np.float32)
    p_len = audio.shape[0] // vc.engine.window
    jopts = JaxOptions(f0_method="fcpe", pitch=2.0)

    def assert_close(got, ref):
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)
        assert np.median(rel) < 1e-4
        assert np.mean(rel < 1e-2) > 0.95, f"fcpe host path vs JAX: {rel.max()}"
        assert np.mean(ref > 0) > 0.5  # voiced, not all gated

    got = fcpe_method.fcpe_f0(vc.fcpe_params, cfg, torch.from_numpy(audio), p_len)
    ref = jax_fcpe_f0(jv, audio, p_len, jopts)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape == (p_len,)
    assert_close(got, ref)
    if hop == vc.engine.window:
        return  # the engine takes the device path here
    port = copy.copy(vc)
    port.fcpe_cfg = cfg
    _, qbuf, inv_scale, padded_len = highpass_pad_quant(song, vc.engine.t_pad)
    assert padded_len == audio.shape[0]
    pitch, pitchf = port.compute_f0(torch.from_numpy(qbuf).float() * float(inv_scale),
                                    ConversionOptions(f0_method="fcpe", pitch=2.0),
                                    padded_len)
    jpitch, jpitchf = jv.compute_f0(audio, p_len, jopts)
    assert_close(pitchf.numpy()[:p_len], jpitchf)
    assert np.mean(pitch.numpy()[:p_len] == jpitch) > 0.95


def test_fcpe_engine_takes_the_host_path_off_the_window(converters, monkeypatch):
    """An FCPE whose hop is not the engine's window runs the host path on
    buf[:padded_len] onto padded_len // window frames, zero-padded to the
    bucket's frames; at the window's hop, the device path."""
    vc = copy.copy(converters[0])
    song = _bench_song(2.0)
    _, qbuf, inv_scale, padded_len = highpass_pad_quant(song, vc.engine.t_pad)
    buf = torch.from_numpy(qbuf).float() * float(inv_scale)
    calls = []
    real = engine_mod.fcpe_f0

    def spy(params, cfg, audio, p_len):
        calls.append((cfg.hop_size, audio.shape[0], p_len))
        return real(params, cfg, audio, p_len)

    monkeypatch.setattr(engine_mod, "fcpe_f0", spy)
    opts = ConversionOptions(f0_method="fcpe")
    vc.compute_f0(buf, opts, padded_len)
    assert calls == []
    vc.fcpe_cfg = dataclasses.replace(vc.fcpe_cfg, hop_size=320)
    pitch, pitchf = vc.compute_f0(buf, opts, padded_len)
    p_len = padded_len // vc.engine.window
    assert calls == [(320, padded_len, p_len)]
    assert pitch.shape == pitchf.shape == (qbuf.shape[0] // 160 + 1,)
    assert np.all(pitchf.numpy()[p_len:] == 0) and np.all(pitch.numpy()[p_len:] == 1)
    assert np.mean(pitchf.numpy()[:p_len] > 0) > 0.5


def test_fcpe_guards(converters):
    """fcpe without its weights raises as mangio-crepe does; so does a
    missing padded length."""
    vc = converters[0]
    bare = copy.copy(vc)
    bare.fcpe_params = None
    with pytest.raises(RuntimeError, match="fcpe weights not loaded"):
        bare.convert(_bench_song(1.0), ConversionOptions(f0_method="fcpe"))
    with pytest.raises(ValueError, match="padded signal length"):
        vc.compute_f0(torch.zeros(16000 * 4), ConversionOptions(f0_method="fcpe"))
