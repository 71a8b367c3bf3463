"""The port's host codecs and mixdown against the JAX package, on the CPU.

FLAC: the port's native codec (its own copy of flac_codec.cpp, built into
build/native/) writes the JAX package's bytes for the same samples, each
package decodes the other's files bitwise, int16 samples round-trip
exactly, and malformed streams fail cleanly (tests/test_hardening.py's
cases). Effects: the port's chain is bitwise JAX's, whole and streamed
(tests/test_app.py's settings and the defaults), and tests/test_effects_
numerics.py's closed forms hold on it. Then process_audio end to end and
voice_pipeline writing FLAC from a tiny CPU converter.
"""

import os

import numpy as np
import pytest

import test_effects_numerics as numerics
from polgen_rvc_tpu.app import audio_processing as jax_ap
from polgen_rvc_tpu.native import flac as jax_flac
from polgen_rvc_tpu.utils import audio_io as jax_io
from polgen_rvc_tpu_torch import native
from polgen_rvc_tpu_torch.app import audio_processing as ap
from polgen_rvc_tpu_torch.native import flac
from polgen_rvc_tpu_torch.utils import audio_io
from test_torch_pipeline import one_intra_op_thread  # noqa: F401


def _signal(n, channels, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    tone = 0.5 * np.sin(2 * np.pi * 220 * t)
    x = np.stack([tone + 0.05 * rng.standard_normal(n) for _ in range(channels)], 1)
    x[: n // 7, -1] = 1.3  # clipped run: the encoder clamps to full scale
    return x.astype(np.float32)


def test_native_libraries_build_into_the_build_directory():
    paths = native.build_all()
    assert set(paths) == {"polgen_dsp", "polgen_flac"}
    for path in paths.values():
        assert os.path.dirname(path) == str(native.BUILD_DIR) and os.path.exists(path)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(native, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError, match="broken.cpp"):
        native._build("broken", "broken.cpp")


@pytest.mark.parametrize("n,channels,sr", [(10000, 1, 16000), (4096 * 3, 2, 44100),
                                           (50001, 2, 48000), (3, 1, 32000)])
def test_flac_bytes_equal_jax_and_decode_across(tmp_path, n, channels, sr):
    x = _signal(n, channels)
    ours, theirs = str(tmp_path / "port.flac"), str(tmp_path / "jax.flac")
    flac.encode(ours, x, sr)
    jax_flac.encode(theirs, x, sr)
    data = open(ours, "rb").read()
    assert data[:4] == b"fLaC" and data == open(theirs, "rb").read()
    a, ra = flac.decode(theirs)
    b, rb = jax_flac.decode(ours)
    assert ra == rb == sr and a.shape == b.shape == (n, channels)
    np.testing.assert_array_equal(a, b)
    want = np.round(np.clip(x, -1, 1).astype(np.float64) * 32767) / 32768
    np.testing.assert_array_equal(a, want.astype(np.float32))


def test_flac_int16_samples_round_trip(tmp_path):
    """int16 (what voice_pipeline writes) decodes to the same integers;
    the JAX binding reads int16 as floats and clips them to full scale."""
    s = np.random.default_rng(1).integers(-32767, 32768, (9000, 2)).astype(np.int16)
    path = str(tmp_path / "pcm.flac")
    flac.encode(path, s, 48000)
    y, sr = flac.decode(path)
    assert sr == 48000 and np.array_equal((y * 32768).astype(np.int16), s)
    jax_flac.encode(str(tmp_path / "jax.flac"), s, 48000)
    clipped, _ = jax_flac.decode(str(tmp_path / "jax.flac"))
    assert set(np.unique(np.abs(clipped * 32768))) <= {0.0, 32767.0}


def test_flac_truncated_metadata_rejected(tmp_path):
    p = tmp_path / "trunc.flac"
    p.write_bytes(b"fLaC" + bytes([0x80, 0, 0, 34]) + b"\x00" * 10)
    with pytest.raises(ValueError, match="not a decodable FLAC"):
        flac.decode(str(p))


def test_flac_channel_mismatch_rejected(tmp_path):
    """A frame claiming 8 channels in a mono stream: an error, not a write
    past the buffer (tests/test_hardening.py)."""
    p = str(tmp_path / "mono.flac")
    flac.encode(p, (np.random.default_rng(0).standard_normal((4000, 1)) * 0.1
                    ).astype(np.float32), 16000)
    data = bytearray(open(p, "rb").read())
    idx = data.find(b"\xff\xf8", 4)
    assert idx > 0
    data[idx + 3] = (data[idx + 3] & 0x0F) | (7 << 4)
    (tmp_path / "evil.flac").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="FLAC decode failed"):
        flac.decode(str(tmp_path / "evil.flac"))


def test_audio_io_flac_route_matches_jax(tmp_path):
    x = _signal(30000, 2, seed=3)
    audio_io.write_audio(str(tmp_path / "a.flac"), x, 44100)
    jax_io.write_audio(str(tmp_path / "b.flac"), x, 44100)
    assert (tmp_path / "a.flac").read_bytes() == (tmp_path / "b.flac").read_bytes()
    y, sr = audio_io.read_audio(str(tmp_path / "b.flac"))
    z, jsr = jax_io.read_audio(str(tmp_path / "a.flac"))
    assert sr == jsr == 44100 and np.array_equal(y, z)


EFFECTS = {
    "defaults": {},
    "test_app": dict(reverb_wet=0.3, reverb_dry=0.7, chorus_rate_hz=1.0,
                     chorus_depth=0.2, chorus_centre_delay_ms=7.0, chorus_mix=0.3),
    "every effect": dict(reverb_rm_size=0.6, reverb_wet=0.35, reverb_dry=0.6,
                         reverb_damping=0.4, reverb_width=0.8, low_shelf_gain=4.0,
                         high_shelf_gain=-3.0, compressor_ratio=6.0,
                         compressor_threshold=-18.0, noise_gate_threshold=-45.0,
                         noise_gate_ratio=4.0, noise_gate_attack=5.0,
                         noise_gate_release=80.0, chorus_rate_hz=1.5,
                         chorus_depth=0.3, chorus_centre_delay_ms=9.0,
                         chorus_feedback=0.2, chorus_mix=0.4),
}


@pytest.mark.parametrize("sr", [44100, 48000])
@pytest.mark.parametrize("name", list(EFFECTS))
def test_effect_chain_bitwise_jax_whole_and_streamed(name, sr):
    x = (np.random.default_rng(2).standard_normal((2 * sr + 777, 2)) * 0.2).astype(np.float32)
    whole = ap.EffectChain(sr, **EFFECTS[name]).process(x)
    ref = jax_ap.EffectChain(sr, **EFFECTS[name]).process(x)
    np.testing.assert_array_equal(whole, ref)
    chain = ap.EffectChain(sr, **EFFECTS[name])
    streamed = np.concatenate([chain.process(x[i:i + sr]) for i in range(0, len(x), sr)])
    np.testing.assert_array_equal(streamed, whole)
    assert np.isfinite(whole).all() and np.abs(whole).max() > 0


NUMERICS = [("test_neutral_chain_is_passthrough", {}),
            *[("test_compressor_static_curve", {"in_db": v}) for v in (-30.0, -20.0, -12.0, -6.0)],
            ("test_noise_gate_closes_below_threshold", {}),
            ("test_noise_gate_release_timing", {}),
            ("test_freeverb_impulse_response_structure", {}),
            ("test_freeverb_dry_scaling_exact", {}),
            *[("test_shelf_magnitude_matches_rbj_closed_form", {"gain_db": g, "high": h})
              for g, h in ((12.0, False), (-9.0, False), (12.0, True), (-9.0, True))],
            ("test_chorus_is_exact_fractional_delay_at_depth_zero", {})]


@pytest.mark.parametrize("name,kwargs", NUMERICS,
                         ids=[f"{n[5:]}{list(k.values()) or ''}" for n, k in NUMERICS])
def test_closed_forms_hold_on_the_port_chain(monkeypatch, name, kwargs):
    """tests/test_effects_numerics.py's closed-form checks, each run with
    the port's EffectChain in place of the JAX package's."""
    monkeypatch.setattr(numerics, "EffectChain", ap.EffectChain)
    getattr(numerics, name)(**kwargs)


def _mix_inputs(tmp_path, sr_ins):
    voc = _signal(44100 + 5000, 2, seed=4) * 0.5
    ins = (0.3 * np.sin(2 * np.pi * 110 * np.arange(sr_ins * 2) / sr_ins)).astype(np.float32)
    vp, ip = str(tmp_path / "voc.wav"), str(tmp_path / "ins.wav")
    audio_io.write_audio(vp, voc, 44100)
    audio_io.write_audio(ip, np.stack([ins, 0.5 * ins], 1), sr_ins)
    return vp, ip


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_process_audio_matches_jax(tmp_path, fmt):
    """The mixdown end to end, effects on (reverb, compressor and chorus
    away from neutral), gains in dB, against the JAX package's: as long as
    the vocal, and within 2 int16 counts on < 0.1% of samples. The chain is
    bitwise JAX's; the port's WAV writer rounds x * 32767 in float64 where
    the JAX one rounds in float32, so a product near .5 lands one count
    apart in the effected vocal's WAV, and again in a WAV mix."""
    vp, ip = _mix_inputs(tmp_path, 44100)
    kw = dict(output_format=fmt, vocal_gain=2.0, instrumental_gain=-3.0,
              use_effects=True, **EFFECTS["every effect"])
    ours = ap.process_audio(vp, ip, output_dir=str(tmp_path / "port"), **kw)
    theirs = jax_ap.process_audio(vp, ip, output_dir=str(tmp_path / "jax"), **kw)
    assert os.path.basename(ours) == f"AiCover.{fmt}"
    if fmt == "flac":
        assert open(ours, "rb").read(4) == b"fLaC"
    y, sr = audio_io.read_audio(ours)
    ref, jsr = jax_io.read_audio(theirs)
    assert sr == jsr == 44100 and y.shape == ref.shape == (44100 + 5000, 2)
    assert np.abs(y).max() > 0.05
    d = np.abs(y.astype(np.float64) - ref) * 32768
    assert d.max() <= 2 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def test_process_audio_resamples_a_mismatched_instrumental(tmp_path):
    """A 48 kHz instrumental under a 44.1 kHz vocal, 96,000 samples (not a
    multiple of 160, where the JAX resample raises): the port's resample
    gives ceil(T * 147 / 160) samples and the mix keeps the vocal's length."""
    vp, ip = _mix_inputs(tmp_path, 48000)
    out = ap.process_audio(vp, ip, output_format="flac", use_effects=False,
                           output_dir=str(tmp_path))
    y, sr = audio_io.read_audio(out)
    assert sr == 44100 and y.shape == (44100 + 5000, 2)
    voc, _ = audio_io.read_audio(str(tmp_path / "Voice_Stereo.wav"))
    assert not np.array_equal(y, np.clip(voc, -1, 1))  # the instrumental is in


def test_process_audio_needs_both_paths():
    with pytest.raises(ValueError, match="vocal"):
        ap.process_audio("", "x.wav")
    with pytest.raises(ValueError, match="instrumental"):
        ap.process_audio("x.wav", "")


def test_voice_pipeline_writes_flac(tmp_path, monkeypatch):
    """voice_pipeline(output_format="flac") on a tiny CPU converter: a real
    FLAC file (magic fLaC) whose samples decode to the int16 the convert
    gave, bit for bit."""
    from polgen_rvc_tpu_torch.app.voice_conversion import voice_pipeline
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
    from polgen_rvc_tpu_torch.utils.audio_io import load_audio

    vc = build_synthetic_converter(
        tiny=True, sr=48000, device="cpu",
        engine=EngineConfig(x_pad=1, x_query=2, x_center=3, x_max=4, chunk_batch=2,
                            bucket_step_s=2))
    song = str(tmp_path / "in.wav")
    audio_io.write_audio(song, _signal(44100, 2, seed=5) * 0.6, 44100)
    path = voice_pipeline(song, "voice", 0, index_rate=0.0, output_format="flac",
                          output_dir=str(tmp_path / "out"), converter=vc)
    assert path.endswith("Voice_Converted.flac")
    assert open(path, "rb").read(4) == b"fLaC"
    y, sr = flac.decode(path)
    want, _ = vc.convert(load_audio(str(tmp_path / "out" / "Voice_Stereo.wav"), 16000),
                         ConversionOptions(index_rate=0.0, output_format="flac"))
    assert sr == 48000 and y.shape == (want.shape[0], 1)
    np.testing.assert_array_equal((y[:, 0] * 32768).astype(np.int16), want)
