"""The port's file-level path: audio I/O, resampling, output resample, the
voice pipeline and the CLI, held against the JAX package (tiny models,
bench.py's CPU-smoke tiers, files written on the spot)."""

import os

import numpy as np
import pytest
import torch

from polgen_rvc_tpu.app.rvc_cli import build_parser as jax_build_parser
from polgen_rvc_tpu.ops.resample import resample as jax_resample
from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_synthetic
from polgen_rvc_tpu.utils import mp3_codec as jax_mp3
from polgen_rvc_tpu.utils.audio_io import read_audio as jax_read_audio
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.app import rvc_cli, voice_conversion
from polgen_rvc_tpu_torch.ops.resample import resample
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.factory import (
    build_converter, build_synthetic_converter, write_synthetic_files,
)
from polgen_rvc_tpu_torch.utils import audio_io, mp3_codec
from test_torch_batch import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_pipeline import BENCH_OPTS, SMOKE_ENGINE, jax_noise


def _song(seconds, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    return (0.4 * np.sin(2 * np.pi * 220.0 * t * vibrato)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def port_vc():
    return build_synthetic_converter(tiny=True, sr=48000, index_vectors=256,
                                     engine=EngineConfig(**SMOKE_ENGINE), device="cpu")


def test_cli_parser_matches_jax():
    """The same flags, defaults, types and required flags as the JAX CLI."""
    def surface(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.type, a.required)
                for a in parser._actions}

    assert surface(rvc_cli.build_parser()) == surface(jax_build_parser())
    args = rvc_cli.build_parser().parse_args(["-i", "a.wav", "-m", "m", "-p", "2"])
    assert (args.index_rate, args.method, args.format, args.profile) == (0, "rmvpe+", "mp3",
                                                                       None)


@pytest.mark.parametrize("subtype", ["pcm8", "pcm16", "pcm24", "pcm32", "float32",
                                     "float64"])
def test_wav_round_trip_every_width(tmp_path, rng, subtype):
    """The port writes each WAV width; its reader and the JAX package's read
    the file bit for bit alike. The writer scales by 2^(bits-1) - 1 and the
    readers divide by 2^(bits-1): within half a step of rounding plus one
    step of that scale at full range."""
    x = np.clip(rng.standard_normal((1001, 2)) * 0.4, -1.0, 1.0).astype(np.float32)
    path = str(tmp_path / f"{subtype}.wav")
    audio_io._write_wav(path, x, 44100, subtype=subtype)
    y, sr = audio_io.read_audio(path)
    jy, jsr = jax_read_audio(path)
    assert sr == jsr == 44100 and y.shape == (1001, 2) and y.dtype == np.float32
    assert np.array_equal(y, jy)
    step = {"pcm8": 2 ** -7, "pcm16": 2 ** -15, "pcm24": 2 ** -23, "pcm32": 2 ** -31,
            "float32": 0.0, "float64": 0.0}[subtype]
    assert np.abs(y - x).max() <= 1.5 * step


def test_wav_writes_int16_as_is_and_mono(tmp_path):
    pcm = np.array([0, 1, -1, 32767, -32768], np.int16)
    path = str(tmp_path / "i16.wav")
    audio_io.write_audio(path, pcm, 16000)
    y, sr = audio_io.read_audio(path)
    assert sr == 16000 and y.shape == (5, 1)
    assert np.array_equal(y[:, 0], pcm / 32768.0)
    assert np.array_equal(y, jax_read_audio(path)[0])


def test_mp3_gated_without_any_codec(tmp_path, monkeypatch):
    """With neither libmp3lame/libmpg123 nor ffmpeg, mp3 raises
    CodecUnavailable both ways; so does FLAC without its native codec (no
    library built and no g++) and ffmpeg."""
    from polgen_rvc_tpu_torch import native

    def no_lib():
        raise mp3_codec.Mp3Unavailable("forced for test")

    monkeypatch.setattr(native, "available", lambda name: False)
    monkeypatch.setattr(mp3_codec, "_lame", no_lib)
    monkeypatch.setattr(mp3_codec, "_mpg123", no_lib)
    monkeypatch.setattr(audio_io.shutil, "which", lambda name: None)
    with pytest.raises(audio_io.CodecUnavailable):
        audio_io.write_audio(str(tmp_path / "x.mp3"), np.zeros(100, np.float32), 16000)
    (tmp_path / "y.mp3").write_bytes(b"\xff\xfb" + bytes(100))
    with pytest.raises(audio_io.CodecUnavailable):
        audio_io.read_audio(str(tmp_path / "y.mp3"))
    with pytest.raises(audio_io.CodecUnavailable):
        audio_io.write_audio(str(tmp_path / "x.flac"), np.zeros(100, np.float32), 16000)


@pytest.mark.skipif(not mp3_codec.available(), reason="libmp3lame/libmpg123 not present")
def test_mp3_matches_jax_codec(tmp_path):
    """Where the codec libraries exist, the port's encoder writes the JAX
    package's bytes and its decoder reads them back alike."""
    x = 0.5 * np.sin(2 * np.pi * 440.0 * np.arange(48000) / 48000).astype(np.float32)
    a, b = str(tmp_path / "a.mp3"), str(tmp_path / "b.mp3")
    mp3_codec.encode_mp3(a, x, 48000)
    jax_mp3.encode_mp3(b, x, 48000)
    assert open(a, "rb").read() == open(b, "rb").read()
    y, sr = mp3_codec.decode_mp3(a)
    jy, jsr = jax_mp3.decode_mp3(a)
    assert sr == jsr == 48000 and np.array_equal(y, jy)


def test_to_stereo_and_stereo_wav(tmp_path):
    assert audio_io.to_stereo(np.zeros(10)).shape == (10, 2)
    assert audio_io.to_stereo(np.zeros((10, 1))).shape == (10, 2)
    x = np.arange(40, dtype=np.float32).reshape(10, 4) / 40
    assert np.array_equal(audio_io.to_stereo(x), x[:, :2])
    mono = str(tmp_path / "mono.wav")
    audio_io._write_wav(mono, x[:, 0], 22050, subtype="float32")
    out = audio_io.save_stereo_wav(mono, str(tmp_path / "st.wav"))
    y, sr = audio_io.read_audio(out)
    assert sr == 22050 and y.shape == (10, 2)
    assert np.array_equal(y[:, 0], y[:, 1])


@pytest.mark.parametrize("sr", [44100, 48000, 22050])
def test_resample_matches_jax(rng, sr):
    """To 16 kHz against the JAX package's polyphase resampler: 1e-5
    absolute; the length is ceil(T * up / down)."""
    x = (rng.standard_normal(2 * sr) * 0.3).astype(np.float32)
    got = resample(torch.from_numpy(x), sr, 16000)
    ref = np.asarray(jax_resample(x, sr, 16000))
    assert got.shape == ref.shape == (32000,)
    assert np.abs(got.numpy() - ref).max() < 1e-5
    # a length the JAX function cannot take (not a multiple of down)
    assert resample(torch.from_numpy(x[:-7]), sr, 16000).shape[-1] == \
        -(-(2 * sr - 7) * 16000 // sr)
    batch = resample(torch.from_numpy(np.stack([x, -x])), sr, 16000)
    assert torch.equal(batch[0], got) and torch.equal(batch[1], -got)


def test_load_audio_resamples_and_mixes_down(tmp_path, rng):
    x = np.stack([_song(1.0, sr=44100), 0.5 * _song(1.0, sr=44100, seed=1)], 1)
    path = str(tmp_path / "in.wav")
    audio_io._write_wav(path, x, 44100, subtype="float32")
    mono = audio_io.load_audio(path, 16000)
    ref = resample(torch.from_numpy(x.mean(axis=1)), 44100, 16000).numpy()
    assert mono.dtype == np.float32 and mono.shape == (16000,)
    assert np.array_equal(mono, ref)
    with pytest.raises(RuntimeError, match="not found"):
        audio_io.load_audio(str(tmp_path / "missing.wav"), 16000)


def test_convert_resample_sr_matches_jax():
    """resample_sr=44100 on a 48 kHz model: the rate, the length and the
    0.5 dB gate against the JAX package's convert (no-f0 models on both
    sides: the resample follows the synthesizer, whatever the F0)."""
    vc = build_synthetic_converter(tiny=True, sr=48000, index_vectors=256, use_f0=False,
                                   engine=EngineConfig(**SMOKE_ENGINE), device="cpu",
                                   noise_provider=jax_noise)
    jvc = jax_synthetic(tiny=True, sr=48000, index_vectors=256, use_f0=False,
                        engine=JaxEngineConfig(**SMOKE_ENGINE))
    song = _song(2.0)
    out, sr = vc.convert(song, ConversionOptions(**BENCH_OPTS, resample_sr=44100))
    ref, jsr = jvc.convert(song, JaxOptions(**BENCH_OPTS, resample_sr=44100))
    assert sr == jsr == 44100 and out.shape == ref.shape
    dist = mel_distortion_db(out, ref, sr)
    assert dist < 0.5, f"mel distortion {dist:.3f} dB"
    native, _ = vc.convert(song, ConversionOptions(**BENCH_OPTS))
    assert out.shape[0] == -(-native.shape[0] * 147 // 160)
    # below the pipeline rate, or at the model's own rate: no resample
    assert vc.convert(song, ConversionOptions(resample_sr=8000))[1] == 48000
    assert vc.convert(song, ConversionOptions(resample_sr=48000))[1] == 48000


@pytest.fixture(scope="module")
def app_root(tmp_path_factory):
    """A working directory in the app's layout: models/voice/ with the .pth
    and .index, assets/embedders/hubert_base.pt, assets/predictors/rmvpe.pt,
    and a 44.1 kHz stereo input song."""
    root = tmp_path_factory.mktemp("app")
    write_synthetic_files(str(root), "voice", tiny=True, sr=48000, index_vectors=256)
    song = np.stack([_song(3.0, sr=44100), 0.8 * _song(3.0, sr=44100, seed=1)], 1)
    audio_io._write_wav(str(root / "song.wav"), song, 44100)
    return root


def _expected_samples(vc, seconds):
    """The output length convert plans for a song of this length at 16 kHz."""
    from polgen_rvc_tpu_torch.ops.filters import highpass_pad_quant
    from polgen_rvc_tpu_torch.pipeline.chunking import plan_chunks

    eng = vc.engine
    audio = highpass_pad_quant(np.zeros(int(seconds * 16000)), eng.t_pad)[0]
    return sum(max(min((c.slice_end - c.slice_start) // eng.window,
                       2 * vc.hubert_cfg.num_frames(c.slice_end - c.slice_start))
                   * vc.synth_cfg.upp - 2 * vc.tgt_sr * eng.x_pad, 0)
               for c in plan_chunks(audio, eng).chunks)


def test_voice_pipeline_file_to_file(app_root, monkeypatch, port_vc):
    """A 44.1 kHz stereo WAV through voice_pipeline with a CPU converter:
    the stereo copy, then a 48 kHz WAV of the planned length, not silent."""
    monkeypatch.chdir(app_root)
    path = voice_conversion.voice_pipeline("song.wav", "voice", 0.0, output_format="wav",
                                           converter=port_vc)
    assert path == os.path.join("output", "Voice_Converted.wav")
    stereo, sr = audio_io.read_audio(os.path.join("output", "Voice_Stereo.wav"))
    assert sr == 44100 and stereo.shape == (3 * 44100, 2)
    y, sr = audio_io.read_audio(path)
    assert sr == 48000 and y.shape == (_expected_samples(port_vc, 3.0), 1)
    assert np.isfinite(y).all() and np.abs(y).max() > 0.03


def test_cli_main_converts_file_to_file(app_root, monkeypatch, tmp_path):
    """rvc_cli.main with get_converter building on the CPU from the files in
    models/ and assets/; --profile writes a Chrome trace."""
    monkeypatch.chdir(app_root)
    real = voice_conversion.get_converter
    built = []

    def cpu_converter(*a, **k):
        vc = real(*a, **{**k, "device": "cpu"})
        built.append(vc)
        return vc

    monkeypatch.setattr(voice_conversion, "get_converter", cpu_converter)
    monkeypatch.setattr(voice_conversion, "_CONVERTER_CACHE", {})
    trace = str(tmp_path / "trace")
    path = rvc_cli.main(["-i", "song.wav", "-m", "voice", "-p", "0", "-ir", "0.5",
                         "-f", "wav", "--profile", trace])
    assert os.path.exists(os.path.join(trace, "trace.json"))
    (vc,) = built
    assert vc.device.type == "cpu" and vc.index_bank is not None
    y, sr = audio_io.read_audio(path)
    assert sr == 48000 and y.shape[0] == _expected_samples(vc, 3.0)
    assert np.abs(y).max() > 0.03
    # the same model again comes from the cache
    assert voice_conversion.get_converter("voice", device="cpu") is vc
    with pytest.raises(SystemExit):
        rvc_cli.main(["-i", "song.wav", "-m", "nobody", "-p", "0"])


def test_find_rvc_model(app_root):
    pth, index = voice_conversion.find_rvc_model("voice", str(app_root / "models"))
    assert pth.endswith("voice.pth") and index.endswith("voice.index")
    with pytest.raises(ValueError, match="does not exist"):
        voice_conversion.find_rvc_model("nobody", str(app_root / "models"))


def test_entry_points_need_cuda_unless_cpu_is_asked(app_root, monkeypatch):
    """build_converter, get_converter and voice_pipeline default to CUDA and
    raise without it; device="cpu" builds on the CPU."""
    monkeypatch.chdir(app_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(voice_conversion, "_CONVERTER_CACHE", {})
    pth, _ = voice_conversion.find_rvc_model("voice")
    hub = voice_conversion.HUBERT_MODEL_PATH
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_converter(pth, hub)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        voice_conversion.get_converter("voice")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        voice_conversion.voice_pipeline("song.wav", "voice", 0.0, output_format="wav")
    assert build_converter(pth, hub, device="cpu").device.type == "cpu"
