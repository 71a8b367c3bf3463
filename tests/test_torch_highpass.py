"""The song's conversion head (ops/highpass.py) on the CPU: the plain twin
of csrc/highpass.cu against the host reference (ops/filters.py, scipy in
float64), and the CPU converter's song preparation through it.

Within one tile the twin is scipy's recurrence from scipy's start state, so
it equals scipy bit for bit. Across tiles the start states come from the
carry, and no evaluation but scipy's own sequential one reproduces its
roundings: scipy's float64 filtfilt of this filter is itself up to ~1e-7
of the peak from an extended-precision (long double) evaluation of the
same recurrence, because lfilter's state amplifies each step's rounding by
up to ~3e6 on its way to the output. So the twin is held to scipy's own
accuracy: no farther from the long double evaluation than twice scipy is,
and no farther from scipy than three times that. Its float32 cast and
int16 buffer follow; from the same float32 signal, the quantize is bitwise.
"""

import json

import numpy as np
import pytest
import torch
from scipy import signal as sps

from benchmark.signals import Inputs
from polgen_rvc_tpu_torch.ops import filters
from polgen_rvc_tpu_torch.ops import highpass as hp
from polgen_rvc_tpu_torch.pipeline.chunking import find_cut_points, is_cut, plan_chunks
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter

SR = 16000
# signal lengths: padlen + 1, short, the odd extension one sample short of
# a tile, exactly a tile and one past it, then 2 s, 10.24 s and 60 s
ONE_TILE = hp.TILE - 2 * hp.PADLEN
LENGTHS = (hp.PADLEN + 1, 100, ONE_TILE - 1, ONE_TILE, ONE_TILE + 1,
           2 * SR, 163840, 60 * SR)


def _signal(n, seed=0):
    """A sung-like float32 signal: a vibrato tone, a low hum the filter
    removes, and noise."""
    rng = np.random.default_rng(seed + n)
    t = np.arange(n) / SR
    tone = 0.4 * np.sin(2 * np.pi * 220.0 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
    hum = 0.2 * np.sin(2 * np.pi * 20.0 * t)
    return (tone + hum + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _long_double_filtfilt(x):
    """scipy's filtfilt steps with every value in long double."""
    if np.finfo(np.longdouble).nmant <= np.finfo(np.float64).nmant:
        pytest.skip("long double has no more precision than float64 here")
    b, a = filters.butter_highpass()
    zi = sps.lfilter_zi(b, a).astype(np.longdouble)
    b, a = b.astype(np.longdouble), a.astype(np.longdouble)
    x = np.asarray(x, np.longdouble)
    p = hp.PADLEN
    ext = np.concatenate((2 * x[0] - x[p:0:-1], x, 2 * x[-1] - x[-2:-(p + 2):-1]))
    y, _ = sps.lfilter(b, a, ext, zi=zi * ext[0])
    y, _ = sps.lfilter(b, a, y[::-1], zi=zi * y[-1])
    return y[::-1][p:-p].astype(np.float64)


@pytest.mark.parametrize("n", LENGTHS)
def test_twin_filtfilt_against_scipy(n):
    x = _signal(n)
    got = hp.filtfilt_plain(torch.from_numpy(x)).numpy()
    ref = filters.highpass_filtfilt(x)
    assert got.dtype == np.float64 and got.shape == ref.shape
    if n + 2 * hp.PADLEN <= hp.TILE:
        # one tile: scipy's start state, scipy's steps
        assert np.array_equal(got, ref)
        return
    exact = _long_double_filtfilt(x)
    scipy_err = np.abs(ref - exact).max()
    assert np.abs(got - exact).max() <= 2 * scipy_err
    assert np.abs(got - ref).max() <= 3 * scipy_err
    # the float32 cast: each side rounds its float64 once
    peak = np.abs(ref).max()
    f32 = np.abs(got.astype(np.float32).astype(np.float64) - ref.astype(np.float32))
    assert f32.max() <= 3 * scipy_err + 2.0 ** -24 * peak


@pytest.mark.parametrize("n,t_pad", [(hp.PADLEN + 1, 16000), (100, 250), (2 * SR, 16000),
                                     (163840, 16000), (ONE_TILE + 1, 0)])
def test_twin_quantize_is_bitwise_on_the_host_signal(n, t_pad):
    """From the host's own float32 signal, the pad, the int16 quantize and
    the dequantized buffer are the host's (and the engine's dequantize of
    them) bit for bit, also with a pad wider than the signal."""
    x = _signal(n)
    audio, qbuf, inv_scale, padded_len = filters.highpass_pad_quant(x, t_pad)
    q, inv, buf = hp.pad_quant_plain(torch.from_numpy(audio), t_pad)
    assert padded_len == n + 2 * t_pad
    assert q.dtype == torch.int16 and q.shape[0] == qbuf.shape[0] == hp.bucket_length(n, t_pad, 160)
    assert np.array_equal(q.numpy(), qbuf)
    assert inv.dtype == torch.float32 and inv.item() == inv_scale
    host_buf = torch.from_numpy(qbuf).float() * float(inv_scale)
    assert torch.equal(buf, host_buf)


@pytest.mark.parametrize("n", [2 * SR, 163840, 60 * SR])
def test_twin_against_the_host_conversion_head(n):
    """The whole op against ops/filters.highpass_pad_quant: the filtered
    float32 within scipy's own accuracy (above); the int16 buffer off by at
    most one count, on at most 2e-3 of the samples (a float difference of
    ~1e-7 of the peak crosses a rounding boundary on ~1e-3 of them)."""
    x = _signal(n)
    audio, q, inv, buf = hp.highpass_pad_quant(torch.from_numpy(x), 16000)
    h_audio, h_q, h_inv, _ = filters.highpass_pad_quant(x, 16000)
    assert audio.dtype == torch.float32 and audio.shape[0] == h_audio.shape[0]
    dq = np.abs(q.numpy().astype(np.int32) - h_q)
    assert dq.max() <= 1 and (dq > 0).mean() <= 2e-3
    assert abs(inv.item() - float(h_inv)) <= 1e-6 * float(h_inv)
    assert torch.equal(buf, q.float() * inv)


def test_float64_input_filters_as_float32_input_widened():
    x = _signal(5000)
    a32 = hp.highpass_pad_quant(torch.from_numpy(x), 300)
    a64 = hp.highpass_pad_quant(torch.from_numpy(x.astype(np.float64)), 300)
    assert all(torch.equal(u, v) for u, v in zip(a32, a64))


@pytest.mark.parametrize("n", [0, 1, hp.PADLEN])
def test_too_short_signals_raise(n):
    x = _signal(max(n, 1))[:n]
    with pytest.raises(ValueError, match="padlen"):
        filters.highpass_filtfilt(x)
    with pytest.raises(ValueError, match="padlen"):
        hp.highpass_pad_quant(torch.from_numpy(x), 16000)


@pytest.mark.parametrize("bad", [torch.zeros(2, 100), torch.zeros(100, dtype=torch.int16)],
                         ids=["2d", "int16"])
def test_highpass_rejects(bad):
    with pytest.raises(ValueError, match="1-D"):
        hp.highpass_pad_quant(bad, 16000)


@pytest.mark.parametrize("j_lo,j_hi,n", [(-30, 60, 7), (-2000, 2100, 19), (-5, 5, 2)])
def test_reflect_index_is_numpy_reflect(j_lo, j_hi, n):
    """numpy's reflect pad, also where the pad is wider than the signal."""
    sig = np.arange(n)
    pad = max(-j_lo, j_hi - n)
    want = np.pad(sig, (pad, pad), mode="reflect")[pad + j_lo:pad + j_hi]
    got = hp.reflect_index(torch.arange(j_lo, j_hi), n).numpy()
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def cpu_converter():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield build_synthetic_converter(tiny=True, sr=48000, engine=EngineConfig(),
                                    device="cpu", use_f0=False)
    torch.set_num_threads(n)


def test_prepare_song_plans_as_the_host_on_the_songs_signals(cpu_converter):
    """The CPU converter's _prepare_song gives the host path's chunk plan,
    float32 signal and F0 buffer bit for bit, on the benchmark's song
    generator at 150 s, where the blocked scan's float32 signal would move
    a cut (so the engine plans from the host's signal on the card too)."""
    traffic = json.loads(open("benchmark/traffic/songs.json").read())
    inputs = Inputs({**traffic, "lengths_s": [150]}, 4000000123)
    x = inputs.signal(0, 0)
    eng = cpu_converter.engine
    song = cpu_converter._prepare_song(x, ConversionOptions())
    h_audio, h_q, h_inv, _ = filters.highpass_pad_quant(x, eng.t_pad, eng.window)
    want = plan_chunks(h_audio, eng)
    assert song.plan == want and len(want.chunks) > 1
    assert song.audio.dtype == np.float32 and np.array_equal(song.audio, h_audio)
    assert song.pitch is None
    assert torch.equal(song.buf, torch.from_numpy(h_q).float() * float(h_inv))
    scan_audio = hp.highpass_pad_quant(torch.from_numpy(x), eng.t_pad, eng.window)[0]
    assert plan_chunks(scan_audio.numpy(), eng) != want


@pytest.mark.parametrize("extra", [-1, 0, 1, 2])
def test_a_signal_is_cut_only_past_t_max(extra):
    """is_cut is find_cut_points' own condition: a signal whose reflect
    context (window // 2 a side) brings it past t_max is cut, and only
    then do its values decide the plan."""
    eng = EngineConfig()
    n = eng.t_max - 2 * (eng.window // 2) + extra
    x = _signal(n)
    assert is_cut(n, eng) == (extra > 0)
    assert (len(find_cut_points(x, eng)) > 0) == (extra > 0)
    if extra <= 0:
        assert plan_chunks(x, eng) == plan_chunks(np.zeros(n, np.float32), eng)
