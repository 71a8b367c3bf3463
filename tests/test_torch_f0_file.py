"""F0 files in the port against the JAX package, on the CPU.

The override itself (pipeline/f0_file.py and VoiceConverter._apply_f0_file)
is held exactly against the JAX package's F0DispatchMixin._apply_f0_file
plus its host coarse_f0_np, on numpy tracks with a stand-in engine: a file
that starts after t = 0, one longer than the track, one spanning more than
327.67 s (the int16 wrap), unreadable files, x_pad 1 and 3. Then whole
converts: the port's convert with a file against the JAX package's
(coarse pitch exact, < 0.5 dB with the JAX noise replayed), the override
changing the output (tests/test_nof0_and_edge.py:120), and convert_batch
with a file against serial converts.
"""

import copy
import types

import numpy as np
import pytest
import torch

from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.f0_dispatch import F0DispatchMixin, coarse_f0_np as jax_coarse
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_builder
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter
from polgen_rvc_tpu_torch.pipeline.f0_file import apply_f0_file, coarse_f0_np
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
from test_torch_batch import _assert_like_serial, _song, hop320_converter
from test_torch_pipeline import (  # noqa: F401 (the fixture)
    BENCH_OPTS, SMOKE_ENGINE, _bench_song, jax_noise, one_intra_op_thread,
)

P_LEN = 700  # frames of a 7 s padded signal


def _track(seed=0, n=P_LEN):
    """A shifted F0 track as the F0 pass leaves it: voiced runs at a few
    hundred Hz, unvoiced gaps at 0."""
    rng = np.random.default_rng(seed)
    f0 = (180.0 + 120.0 * rng.random(n)).astype(np.float32)
    f0[rng.random(n) < 0.2] = 0.0
    return f0


def _write(path, times, hz):
    path.write_text("\n".join(f"{t:.2f},{h:.4f}" for t, h in zip(times, hz)))
    return str(path)


def _files(tmp_path):
    ramp = lambda n: 150.0 + 0.37 * np.arange(n)  # noqa: E731 (crosses bins)
    return {
        "late start": _write(tmp_path / "late.txt", 1.5 + 0.01 * np.arange(200), ramp(200)),
        "past p_len": _write(tmp_path / "long.txt", 0.01 * np.arange(1500), ramp(1500)),
        "int16 wrap": _write(tmp_path / "wrap.txt", [0.0, 100.0, 400.0], [220.0, 330.0, 440.0]),
        "missing": str(tmp_path / "no_such_file.txt"),
        "malformed": str(tmp_path / "bad.txt"),
    }


CASES = [(name, x_pad) for name in ("late start", "past p_len", "int16 wrap",
                                    "missing", "malformed") for x_pad in (1, 3)]


@pytest.mark.parametrize("name,x_pad", CASES)
def test_override_matches_jax(tmp_path, capsys, name, x_pad):
    """apply_f0_file + coarse_f0_np against JAX's _apply_f0_file +
    coarse_f0_np on the same track: every value and bin exactly."""
    (tmp_path / "bad.txt").write_text("0.00,220\n0.01;230\n")
    path = _files(tmp_path)[name]
    f0 = _track(seed=x_pad)
    stand_in = types.SimpleNamespace(engine=JaxEngineConfig(x_pad=x_pad))
    ref = F0DispatchMixin._apply_f0_file(stand_in, f0.copy(), path)
    jax_out = capsys.readouterr().out
    got = apply_f0_file(f0.copy(), path, EngineConfig(x_pad=x_pad))
    assert capsys.readouterr().out == jax_out
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(coarse_f0_np(got.copy(), 50.0, 1100.0),
                                  jax_coarse(ref.copy(), 50.0, 1100.0))
    changed = not np.array_equal(got, f0)
    if name in ("missing", "malformed"):
        assert not changed and jax_out.startswith("failed to read f0 file: ")
    elif name == "int16 wrap":  # 400 s * 100 + 1 frames wraps negative
        assert not changed
    else:
        assert changed and np.array_equal(got[:x_pad * 100], f0[:x_pad * 100])


@pytest.mark.parametrize("x_pad", [1, 3])
def test_engine_override_caps_at_p_len(tmp_path, x_pad):
    """The engine's route: a pitchf tensor longer than p_len (the port's
    F0 covers the whole bucket) is overridden on its first p_len frames
    only, as JAX's p_len-long track is, and its coarse bins are the host
    bins of every frame. A ramp that crosses bin boundaries: the host bins
    equal JAX's exactly."""
    path = _files(tmp_path)["past p_len"]
    full = _track(seed=7, n=P_LEN + 160)
    stand_in = types.SimpleNamespace(engine=EngineConfig(x_pad=x_pad),
                                     device=torch.device("cpu"))
    opts = ConversionOptions(f0_file=path, f0_min=50.0, f0_max=1100.0)
    pitch, pitchf = VoiceConverter._apply_f0_file(stand_in, torch.from_numpy(full.copy()),
                                                  opts, P_LEN)
    jstand_in = types.SimpleNamespace(engine=JaxEngineConfig(x_pad=x_pad))
    ref = F0DispatchMixin._apply_f0_file(jstand_in, full[:P_LEN].copy(), path)
    assert pitch.dtype == torch.int64 and pitchf.dtype == torch.float32
    np.testing.assert_array_equal(pitchf[:P_LEN].numpy(), ref)
    np.testing.assert_array_equal(pitchf[P_LEN:].numpy(), full[P_LEN:])
    np.testing.assert_array_equal(pitch[:P_LEN].numpy(), jax_coarse(ref.copy()))
    np.testing.assert_array_equal(pitch[P_LEN:].numpy(), jax_coarse(full[P_LEN:].copy()))


@pytest.fixture(scope="module")
def smoke_vc():
    return build_synthetic_converter(tiny=True, sr=48000, index_vectors=256,
                                     engine=EngineConfig(**SMOKE_ENGINE), device="cpu")


def test_convert_with_f0_file_matches_jax(tmp_path, smoke_vc):
    """A 2 s song with a file covering 1.5 s from t = 0.2 s, JAX noise
    replayed: the coarse pitch the synthesizer sees equals JAX's host
    bins on every frame, and the renditions stay below 0.5 dB."""
    path = _write(tmp_path / "f0.txt", 0.2 + 0.01 * np.arange(150),
                  260.0 + 40.0 * np.sin(np.arange(150) / 9.0))
    song = _bench_song(2.0)
    vc = copy.copy(smoke_vc)
    vc.noise_provider = jax_noise
    jvc = jax_builder(tiny=True, sr=48000, index_vectors=256,
                      engine=JaxEngineConfig(**SMOKE_ENGINE))
    seen = {}
    jax_f0 = jvc.compute_f0

    def spy(audio_pad, p_len, *a, **k):
        seen["p_len"] = p_len
        seen["pitch"], seen["pitchf"] = jax_f0(audio_pad, p_len, *a, **k)
        return seen["pitch"], seen["pitchf"]

    jvc.compute_f0 = spy
    ref, jsr = jvc.convert(song, JaxOptions(**BENCH_OPTS, f0_file=path))
    prep = vc._prepare_song(song, ConversionOptions(**BENCH_OPTS, f0_file=path))
    p_len = seen["p_len"]
    np.testing.assert_array_equal(prep.pitch[:p_len].numpy(), seen["pitch"])
    # Hz after the cents decode: 1e-3 relative (as tests/test_torch_models.py)
    np.testing.assert_allclose(prep.pitchf[:p_len].numpy(), seen["pitchf"],
                               rtol=1e-3, atol=1e-3)
    out, sr = vc.convert(song, ConversionOptions(**BENCH_OPTS, f0_file=path))
    assert sr == jsr == 48000 and out.shape == ref.shape
    assert np.abs(out).max() > 1000
    dist = mel_distortion_db(out, ref, sr)
    assert dist < 0.5, f"mel distortion {dist:.3f} dB"


def test_f0_file_override(tmp_path):
    """tests/test_nof0_and_edge.py:120 on the port: the override changes
    the output of a 1.5 s convert."""
    vc = build_synthetic_converter(
        tiny=True, sr=48000, device="cpu",
        engine=EngineConfig(x_pad=1, x_query=2, x_center=6, x_max=8,
                            chunk_batch=1, bucket_step_s=2),
    )
    f0_path = tmp_path / "pitch.txt"
    lines = [f"{i * 0.01:.2f},{200.0 + i}" for i in range(50)]
    f0_path.write_text("\n".join(lines))
    audio = (0.3 * np.sin(2 * np.pi * 220 * np.arange(24000) / 16000)).astype(np.float32)
    out1, _ = vc.convert(audio, ConversionOptions(seed=5))
    out2, _ = vc.convert(audio, ConversionOptions(seed=5, f0_file=str(f0_path)))
    assert np.abs(out1.astype(np.int32) - out2.astype(np.int32)).max() > 0


def test_packed_songs_with_f0_file_equal_serial(tmp_path):
    """convert_batch with a file (test_torch_batch.py's converter): each
    song's override happens before its rows are assembled, so the packed
    songs (a 2 s song on a 6 s bucket packed, 4 s serial, and a 3 s song)
    stay as close to their serial converts as songs without a file: bytes
    where the buckets match, else the cross-bucket bound."""
    vc = hop320_converter()
    path = _write(tmp_path / "f0.txt", 0.01 * np.arange(250), 200.0 + np.arange(250))
    songs = [_song(2.0, seed=91), _song(3.0, seed=92)]
    opts = ConversionOptions(**BENCH_OPTS, f0_file=path)
    outs = vc.convert_batch(songs, opts)
    assert [sr for _, sr in outs] == [48000, 48000]
    _assert_like_serial(vc, songs, outs, opts)
