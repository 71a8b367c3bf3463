"""The port's convert_batch: several songs packed into shared chunk batches.

The tiny 48 kHz model with 256 index vectors (bench.py's CPU-smoke model)
with HuBERT's feature extractor at the real model's 320-sample hop (the
tiny extractor's hop is 20 samples, whose 4,800-8,000 frames a bucket made
self-attention most of these tests' CPU time; packing and the bucket
geometry do not depend on it), at the engine tiers of the JAX package's
batch tests (tests/test_pipeline.py: x_center 6, x_max 8, 2 chunks a
batch, 2 s buckets), so a 4 s song is one chunk and a 13 s song several.
Packed output is held against the port's serial convert (bytes, or the
JAX tests' cross-bucket bound) and against the JAX package's
convert_batch on the same model with its own noise replayed (< 0.5 dB).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polgen_rvc_tpu.models.hubert import HubertConfig as JaxHubertConfig
from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_synthetic
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.ops.filters import highpass_pad_quant
from polgen_rvc_tpu_torch.pipeline.batch_cover import bucket_class, pack_work
from polgen_rvc_tpu_torch.pipeline.chunking import plan_chunks
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter
from polgen_rvc_tpu_torch.pipeline.factory import synthetic_params
from polgen_rvc_tpu_torch.utils.progress import ProgressReporter
from test_torch_pipeline import BENCH_OPTS, jax_noise, one_intra_op_thread  # noqa: F401

BATCH_ENGINE = dict(x_pad=1, x_query=2, x_center=6, x_max=8, chunk_batch=2,
                    bucket_step_s=2)
# fairseq HuBERT's feature-extractor convs (kernel, stride) at the tiny
# width: a 320-sample hop, as the real model's
HOP_320 = ((64, 10, 5), (64, 3, 2), (64, 3, 2), (64, 3, 2), (64, 3, 2),
           (64, 2, 2), (64, 2, 2))


def hop320_model(**kw):
    """synthetic_params(tiny=True, index_vectors=256, **kw) with the HuBERT
    feature extractor's convs after the first redrawn at HOP_320's shapes
    (seed 8): {VoiceConverter keyword: value}, numpy, for either package."""
    synth_cfg, synth, hub_cfg, hub, rmvpe, bank, *extra = synthetic_params(
        tiny=True, index_vectors=256, **kw)
    rng = np.random.default_rng(8)
    convs = [hub["feature_extractor"]["convs"][0]] + [
        {"w": (rng.standard_normal((dim, 64, k)) / np.sqrt(64 * k)).astype(np.float32)}
        for dim, k, _ in HOP_320[1:]]
    hub = {**hub, "feature_extractor": {"convs": convs}}
    model = dict(synth_cfg=synth_cfg, synth_params=synth,
                 hubert_cfg=dataclasses.replace(hub_cfg, conv_layers=HOP_320),
                 hubert_params=hub, rmvpe_params=rmvpe, index_bank=bank)
    if extra:
        model["fcpe_cfg"], model["fcpe_params"] = extra[0]
    return model


def hop320_converter(**kw):
    """The port's converter over hop320_model(**kw) at BATCH_ENGINE, CPU."""
    return VoiceConverter(**hop320_model(**kw), engine=EngineConfig(**BATCH_ENGINE),
                          device="cpu")


def _song(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    x = (0.4 * np.sin(2 * np.pi * 220 * t * vibrato)
         + 0.01 * rng.standard_normal(t.size))
    return x.astype(np.float32)


def _plan(vc, song):
    """The chunk plan convert makes for a song (no F0 pass)."""
    eng = vc.engine
    audio = highpass_pad_quant(np.asarray(song, np.float64), eng.t_pad, eng.window)[0]
    return plan_chunks(audio, eng)


def _assert_like_serial(vc, songs, outs, opts):
    """Each packed song against its serial convert: byte for byte where
    every one of its chunks rides the bucket it rides in convert, else the
    JAX tests' bound for chunks on different buckets (within 1 int16 count
    on < 1% of samples). Returns which songs were held to their bytes."""
    plans = [_plan(vc, song) for song in songs]
    packed = {}
    for bucket, group in pack_work(plans, vc.engine):
        packed.update({key: bucket for key in group})
    exact = []
    for si, ((out, sr), song, plan) in enumerate(zip(outs, songs, plans)):
        ref, ref_sr = vc.convert(song, opts)
        assert sr == ref_sr and out.shape == ref.shape
        serial = {ci: bucket for idxs, bucket in zip(*vc._batch_geometry(plan))
                  for ci in idxs}
        exact.append(all(packed[si, ci] == serial[ci] for ci in serial))
        if exact[-1]:
            np.testing.assert_array_equal(out, ref)
        else:
            d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
            assert d.max() <= 1, d.max()
            assert (d > 0).mean() < 0.01, (d > 0).mean()
    return exact


@pytest.fixture(scope="module")
def port_vc():
    return hop320_converter()


def _convert_batch_spied(vc, songs, opts):
    """convert_batch, recording each dispatched batch: its bucket and which
    rows are real (a non-empty frame mask)."""
    seen = []
    orig = vc._chunk_batch

    def spy(rows, bucket, *a, **k):
        seen.append((bucket, rows["mask"].sum(axis=1) > 0))
        return orig(rows, bucket, *a, **k)

    vc._chunk_batch = spy
    try:
        return vc.convert_batch(songs, opts), seen
    finally:
        del vc._chunk_batch


def test_two_songs_share_one_dispatch_and_equal_serial(port_vc):
    """Mirrors tests/test_pipeline.py:246-280 (4 s songs there): one chunk
    per song (1 and 1.5 s here, the shortest bucket), both in one batch,
    and each song byte-equal to its serial convert (its chunk rides the
    same bucket in both)."""
    songs = [_song(1.0, seed=31), _song(1.5, seed=32)]
    opts = ConversionOptions(volume_envelope=0.25)
    outs, seen = _convert_batch_spied(port_vc, songs, opts)
    rows = [int(real.sum()) for _, real in seen]
    assert rows == [2], f"songs were not packed into one dispatch: {rows}"
    for (out, sr), song in zip(outs, songs):
        ref, ref_sr = port_vc.convert(song, opts)
        assert sr == ref_sr == 48000
        np.testing.assert_array_equal(out, ref)


def test_chunks_ride_their_own_buckets(port_vc):
    """Mirrors tests/test_pipeline.py:384-420 (an 18 s and a 5 s song
    there): a 13 s song of three chunks (classes 8, 8 and 6 s) and a 1 s
    song (4 s); at least one batch runs below the largest bucket of a song
    riding in it, the four chunks, sorted by bucket class, fill two
    batches (8 s, then 6 s, where the 1 s song's chunk rides a larger
    bucket than serial), and each song stays within the JAX tests'
    cross-bucket bound of its serial convert."""
    songs = [_song(13.0, seed=41), _song(1.0, seed=42)]
    opts = ConversionOptions(**BENCH_OPTS, seed=7)
    outs, seen = _convert_batch_spied(port_vc, songs, opts)
    song_max = [max(port_vc._batch_geometry(_plan(port_vc, song))[1]) for song in songs]
    assert min(b for b, _ in seen) < max(song_max), (
        f"no batch below a song's largest bucket {song_max}: {[b for b, _ in seen]}")
    assert [int(real.sum()) for _, real in seen] == [2, 2]
    assert _assert_like_serial(port_vc, songs, outs, opts) == [True, False]


@pytest.fixture(scope="module")
def jax_noise_vc(port_vc):
    """The port's converter drawing the JAX engine's noise."""
    vc = copy.copy(port_vc)
    vc.noise_provider = jax_noise
    return vc


@pytest.fixture(scope="module")
def packed_3_7(jax_noise_vc):
    """A 3 s and a 7 s song packed with bench's options and the JAX
    engine's noise, with the batches dispatched: the two tests below hold
    the same packed call against serial converts and against JAX's."""
    songs = [_song(3.0, seed=51), _song(7.0, seed=52)]
    opts = ConversionOptions(**BENCH_OPTS)
    outs, seen = _convert_batch_spied(jax_noise_vc, songs, opts)
    return songs, opts, outs, seen


def test_a_chunk_rides_a_larger_bucket_than_its_class(jax_noise_vc, packed_3_7):
    """A 3 s and a 7 s song, one chunk each of classes 6 and 10 s: both ride
    one batch at 10 s, so the 3 s song's chunk runs on a larger bucket than
    in its serial convert, and stays within the cross-bucket bound."""
    vc = jax_noise_vc
    songs, opts, outs, seen = packed_3_7
    step = vc.engine.bucket_step_s * vc.engine.sample_rate
    assert [bucket_class(c, vc.engine) // step
            for song in songs for c in _plan(vc, song).chunks] == [3, 5]
    assert [(b // step, int(real.sum())) for b, real in seen] == [(5, 2)]
    assert _assert_like_serial(vc, songs, outs, opts) == [False, True]


def test_bucket_class_is_the_smallest_bucket_that_holds_a_chunk(port_vc):
    eng = port_vc.engine
    plan = _plan(port_vc, _song(18.0, seed=41))
    step = eng.bucket_step_s * eng.sample_rate
    for c in plan.chunks:
        b = bucket_class(c, eng)
        assert b % step == 0 and b - step < c.slice_end - c.slice_start <= b


def test_packed_songs_match_jax_convert_batch(packed_3_7):
    """Each packed song against the JAX package's convert_batch on the same
    weights, the JAX engine's noise replayed through the provider: the
    repo's 0.5 dB mel-distortion gate (tests/test_quality.py)."""
    songs, _, outs, _ = packed_3_7
    jvc = jax_synthetic(tiny=True, sr=48000, index_vectors=256,
                        engine=JaxEngineConfig(**BATCH_ENGINE))
    model = hop320_model()  # the same HuBERT on the JAX side, before any convert
    jvc.hubert_cfg = JaxHubertConfig(**dataclasses.asdict(model["hubert_cfg"]))
    jvc.hubert_params = jax.tree.map(jnp.asarray, model["hubert_params"])
    refs = jvc.convert_batch(songs, JaxOptions(**BENCH_OPTS))
    for (out, sr), (ref, jsr) in zip(outs, refs):
        assert sr == jsr == 48000
        assert out.dtype == np.int16 and out.shape == ref.shape
        assert np.abs(out).max() > 1000
        dist = mel_distortion_db(out, ref, sr)
        assert dist < 0.5, f"mel distortion {dist:.3f} dB"


def test_nof0_songs_pack_and_equal_serial():
    vc = hop320_converter(use_f0=False)
    songs = [_song(2.0, seed=61), _song(3.0, seed=62)]
    opts = ConversionOptions(volume_envelope=0.25)
    outs = vc.convert_batch(songs, opts)
    assert [sr for _, sr in outs] == [48000, 48000]
    _assert_like_serial(vc, songs, outs, opts)


def test_fcpe_songs_pack_and_equal_serial():
    """fcpe songs pack too (the port's F0 pass is one device call for every
    method): one chunk each in one batch, like their serial converts."""
    vc = hop320_converter(with_fcpe=True)
    songs = [_song(2.0, seed=71), _song(3.0, seed=72)]
    opts = ConversionOptions(f0_method="fcpe", volume_envelope=0.25)
    outs = vc.convert_batch(songs, opts)
    _assert_like_serial(vc, songs, outs, opts)


def test_empty_list_and_f0_file(port_vc, tmp_path, capsys):
    """No songs, no output. An F0 file is taken by both routes: each reads
    it while preparing the song and goes on to its chunk batches
    (tests/test_torch_f0_file.py converts with files); an unreadable one
    leaves the F0 as computed (the JAX package's quirk)."""
    assert port_vc.convert_batch([]) == []
    opts = ConversionOptions(f0_file=str(tmp_path / "f0.txt"))
    songs = []

    def stop(entries, *a, **k):
        songs.append(entries[0][2])
        raise StopIteration

    vc = copy.copy(port_vc)
    vc._convert_rows = stop
    for route in (lambda: vc.convert_batch([_song(1.0)], opts),
                  lambda: vc.convert(_song(1.0), opts)):
        with pytest.raises(StopIteration):
            route()
    assert capsys.readouterr().out.count("failed to read f0 file: ") == 2
    without = port_vc._prepare_song(_song(1.0), ConversionOptions())
    for with_file in songs:
        assert torch.equal(with_file.pitch, without.pitch)
        assert torch.equal(with_file.pitchf, without.pitchf)


def test_progress_reaches_one(port_vc):
    events = []
    progress = ProgressReporter(sink=lambda f, m: events.append((f, m)))
    outs = port_vc.convert_batch([_song(1.0, seed=81), _song(1.5, seed=82)],
                                 ConversionOptions(), progress)
    fracs = [f for f, _ in events]
    assert len(outs) == 2 and fracs[-1] == 1.0
    assert fracs == sorted(fracs) and len(fracs) >= 4
    events.clear()
    port_vc.convert(_song(1.0, seed=81), ConversionOptions(), progress)
    assert [f for f, _ in events][-1] == 1.0


def test_conv_transpose2d_restores_the_cudnn_flag():
    """RMVPE's conv-transpose runs under cuDNN's deterministic flag (its
    default algorithm on the card changes the F0 track from run to run,
    and packed songs could then not equal serial ones) and restores it."""
    from polgen_rvc_tpu_torch.ops.conv import conv_transpose2d

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(1, 8, 5, 4, generator=g), torch.randn(8, 4, 3, 3, generator=g)
    for flag in (False, True):
        torch.backends.cudnn.deterministic = flag
        try:
            y = conv_transpose2d(x, w, None, stride=2, padding=1, output_padding=1)
            assert torch.backends.cudnn.deterministic is flag
        finally:
            torch.backends.cudnn.deterministic = False
        assert torch.equal(y, torch.nn.functional.conv_transpose2d(
            x, w, None, stride=2, padding=1, output_padding=1))


def test_conv_transpose2d_holds_the_cudnn_flag_across_threads(monkeypatch):
    """Two threads' conv-transposes overlapping: each call runs with the
    flag set from start to end, and the flag is back to False after both
    (a call restoring it under another would leave one of them without
    it, or leave it set)."""
    import threading
    import time

    from polgen_rvc_tpu_torch.ops import conv

    seen = []

    def slow_conv(x, *a, **k):
        start = torch.backends.cudnn.deterministic
        time.sleep(0.05)
        seen.append((start, torch.backends.cudnn.deterministic))
        return x

    monkeypatch.setattr(conv.F, "conv_transpose2d", slow_conv)
    torch.backends.cudnn.deterministic = False
    x, w = torch.zeros(1, 2, 3, 3), torch.zeros(2, 2, 3, 3)
    threads = [threading.Thread(target=conv.conv_transpose2d, args=(x, w))
               for _ in range(2)]
    for t in threads:
        t.start()
        time.sleep(0.01)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert seen == [(True, True), (True, True)]
    assert torch.backends.cudnn.deterministic is False
