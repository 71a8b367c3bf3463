"""The port's device mesh on the CPU: the counterpart of tests/test_parallel.py.

Meshes of "cpu" places, one device named several times: the port's
stand-in for the 8 virtual CPU devices the JAX tests run on
(tests/conftest.py). The model is the tiny one with HuBERT's feature
extractor at the real 320-sample hop (tests/test_torch_batch.py), at
32 kHz (the tiny decoder, padded to 32 channels a stage, is most of a
convert's CPU time); the same numpy weights go to the JAX package's
converter, and the port's converts replay the JAX engine's noise.

The port's mesh is data only (parallel/mesh.py); the JAX package's
meshes here are its (n, 1) ones, whose HuBERT is replicated too.

Bounds. Sharded against unsharded, in the port: at most 1 int16 count on
< 1% of samples, the JAX tests' own bound (test_parallel.py:112-121): the
rows are computed apart and the noise is keyed by (seed, chunk id), so
only float32 summation order differs (a batch of fewer rows). Port on
the mesh against JAX on its mesh: JAX_GAP, set from the readings, since
the two frameworks' convolutions sum in other orders all along the path.
The port's unsharded convert reads against JAX at most 10 counts on
30-41% of the samples, 0.0008-0.0010 dB. A wrong mesh that added o's and
fc2's biases twice read 2,953 counts on 99.8% of the samples, 0.40 dB:
inside the repo's 0.5 dB gate, so that gate alone would not catch it.
HuBERT on a data mesh, against the unsharded forward and JAX's on its
(n, 1) virtual mesh: 1e-5 of the largest |feature| (float32 order only).
"""

import contextlib
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polgen_rvc_tpu.convert.hubert_ckpt import convert_hubert_state
from polgen_rvc_tpu.convert.synthetic import make_hubert_state
from polgen_rvc_tpu.models.hubert import HubertConfig as JaxHubertConfig
from polgen_rvc_tpu.models.hubert import hubert_extract as jax_hubert_extract
from polgen_rvc_tpu.parallel import mesh as jax_mesh
from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.factory import build_synthetic_converter as jax_synthetic
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.convert.params import params_to_torch
from polgen_rvc_tpu_torch.models import hubert as hubert_mod
from polgen_rvc_tpu_torch.models.hubert import HubertConfig, hubert_extract
from polgen_rvc_tpu_torch.ops import cuda_build
from polgen_rvc_tpu_torch.parallel import Mesh, make_mesh, replicate, shard_batch
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
from test_torch_batch import hop320_model
from test_torch_pipeline import BENCH_OPTS, jax_noise, one_intra_op_thread  # noqa: F401

SR = 32000
# shorter tiers than tests/test_parallel.py's (x_query 2, x_center 4, x_max
# 5): its 9 s sine is three chunks on an 8 s bucket, one row of four idle;
# here a 7 s sine is four chunks on a 6 s bucket, a real row on every data
# shard of the 4x1 mesh, for three quarters of the CPU time
SHORT_ENGINE = dict(x_pad=1, x_query=1, x_center=2, x_max=3, bucket_step_s=2)
MESH_ENGINE = dict(SHORT_ENGINE, chunk_batch=4)
MESH_OPTS = dict(index_rate=0.4, protect=0.2)


def cpu_mesh(n_data):
    return make_mesh(n_data, devices=["cpu"] * n_data)


def _sine(seconds, hz=220.0, amp=0.3, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    return (amp * np.sin(2 * np.pi * hz * t)
            + noise * rng.standard_normal(t.size)).astype(np.float32)


# port on a mesh vs JAX on its mesh: 4x the readings' counts, 10x their
# distortion, and a share well below the wrong result's 99.8%
JAX_GAP = {"max_abs_diff": 40, "share_differing": 0.75, "mel_distortion_db": 0.01}


def _within_jax_gap(got, want):
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= JAX_GAP["max_abs_diff"], d.max()
    assert (d > 0).mean() < JAX_GAP["share_differing"], (d > 0).mean()
    dist = mel_distortion_db(got, want, SR)
    assert dist < JAX_GAP["mel_distortion_db"], dist


def _within_one_count(got, want):
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < 0.01, (d > 0).mean()


@pytest.fixture(scope="module")
def model():
    return hop320_model(sr=SR)


def _port(model, engine=MESH_ENGINE, mesh=None, **kw):
    return VoiceConverter(**model, engine=EngineConfig(**engine), device=None if mesh
                          else "cpu", mesh=mesh, noise_provider=jax_noise, **kw)


@pytest.fixture(scope="module")
def jax_vc(model):
    """The JAX package's converter on a 4x1 virtual mesh over the same
    weights (its HuBERT swapped for the hop-320 one, placed as its engine
    places it, before any convert), shared by the convert and
    convert_batch tests, whose batches run at one bucket: one compile of
    its chunk graph."""
    jm = jax_mesh.make_mesh(4, 1)
    jvc = jax_synthetic(tiny=True, sr=SR, index_vectors=256,
                        engine=JaxEngineConfig(**MESH_ENGINE), mesh=jm)
    jvc.hubert_cfg = JaxHubertConfig(**dataclasses.asdict(model["hubert_cfg"]))
    jvc.hubert_params = jax_mesh.replicate(model["hubert_params"], jm)
    return jvc


# ---------------------------------------------------------------------------
# the mesh and its placements
# ---------------------------------------------------------------------------


def test_mesh_shapes(monkeypatch):
    mesh = cpu_mesh(4)
    assert mesh.devices == [torch.device("cpu")] * 4
    assert mesh.primary == torch.device("cpu")
    assert mesh.distinct() == [torch.device("cpu")]
    assert len(make_mesh(devices=["cpu"] * 8).devices) == 8
    assert len(make_mesh(2, devices=["cpu"] * 8).devices) == 2
    with pytest.raises(ValueError, match="need that many devices"):
        make_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    # the default takes every visible card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    mesh = make_mesh()
    assert mesh.devices == [torch.device("cuda:0"), torch.device("cuda:1")]
    # an unindexed "cuda" is held as the current card, so it compares equal
    # to the device its tensors report
    assert make_mesh(1, devices=["cuda"]).primary == torch.device("cuda:1")


def test_shard_batch_layout(rng):
    mesh = cpu_mesh(4)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    blocks = shard_batch(x, mesh)
    assert [tuple(b.shape) for b in blocks] == [(2, 16)] * 4
    assert all(b.device == mesh.devices[d] for d, b in enumerate(blocks))
    assert torch.equal(torch.cat(blocks), x)
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(x[:6], mesh)


def test_replicate_shares_a_repeated_device():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), None], "n": 7}
    reps = replicate(tree, cpu_mesh(4))
    assert list(reps) == [torch.device("cpu")]
    rep = reps[torch.device("cpu")]
    assert rep["a"] is tree["a"] and rep["b"][0] is tree["b"][0]
    assert rep["b"][1] is None and rep["n"] == 7


@pytest.fixture(scope="module")
def tiny_hubert():
    """JAX's tiny HuBERT (tests/test_parallel.py's), numpy parameters."""
    cfg, sd = make_hubert_state(tiny=True)
    return cfg, convert_hubert_state(sd, cfg)


def _padded_rows(cfg, rows=4, samples=4000, seed=1):
    """(wav, padding mask, valid samples) as numpy: rows of noise, zero past
    each row's valid length."""
    rng = np.random.default_rng(seed)
    wav = rng.standard_normal((rows, samples)).astype(np.float32)
    valid = np.array([samples, 3100, 2500, samples, 2200, 3900][:rows])
    wav[np.arange(samples)[None, :] >= valid[:, None]] = 0.0
    frames = cfg.num_frames(samples)
    pad = np.arange(frames)[None, :] >= np.array([cfg.num_frames(v) for v in valid])[:, None]
    return wav, pad, valid


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)])
def test_data_mesh_hubert_forward(tiny_hubert, shape):
    """HuBERT on each data shard's rows (shard_batch) with the shard's
    replicated weights, against the unsharded port forward and JAX's
    jitted forward on its (n, 1) virtual mesh, with padded rows."""
    cfg, params = tiny_hubert
    n_data = shape[0]
    wav, pad, valid = _padded_rows(cfg)
    tcfg = HubertConfig(**dataclasses.asdict(cfg))
    tparams = params_to_torch(params)
    args = [torch.from_numpy(a) for a in (wav, pad, valid)]
    kw = dict(output_layer=cfg.n_layers)
    ref = hubert_extract(tparams, tcfg, args[0], padding_mask=args[1],
                         valid_samples=args[2], **kw)
    mesh = cpu_mesh(n_data)
    reps = replicate(tparams, mesh)
    parts = [hubert_extract(reps[dev], tcfg, w, padding_mask=p, valid_samples=v,
                            rows=wav.shape[0], **kw)
             for dev, w, p, v in zip(mesh.devices, *(shard_batch(a, mesh) for a in args))]
    got = torch.cat(parts).numpy()
    tol = 1e-5 * float(ref.abs().max())
    assert np.abs(got - ref.numpy()).max() <= tol
    jm = jax_mesh.make_mesh(n_data, 1)
    jout = jax.jit(lambda p, w, m, v: jax_hubert_extract(
        p, cfg, w, padding_mask=m, valid_samples=v, **kw))(
        jax_mesh.replicate(params, jm),
        *(jax_mesh.shard_batch(jnp.asarray(a), jm) for a in (wav, pad, valid)))
    assert np.abs(got - np.asarray(jout)).max() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hubert_extract_bytes_are_the_plain_layer(tiny_hubert, dtype):
    """hubert_extract's bytes are those of the plain post-LN layer written
    out (each projection one _linear), with final_proj, in float32 and in
    bfloat16."""
    cfg, params = tiny_hubert
    tcfg = HubertConfig(**dataclasses.asdict(cfg))
    tparams = params_to_torch(params)
    wav, pad, valid = (torch.from_numpy(a) for a in _padded_rows(cfg, 2, 3000, 2))
    got = hubert_extract(tparams, tcfg, wav, final_proj=True, padding_mask=pad,
                         valid_samples=valid, compute_dtype=dtype)
    x = hubert_mod._encoder_input(tparams, tcfg, wav, pad, dtype, valid)
    for lp in tparams["encoder"]["layers"]:
        y = hubert_mod._linear(hubert_mod._attend(x, lp["attn"], cfg.n_heads, pad),
                               lp["attn"]["o"])
        x = hubert_mod._layer_norm(x + y, lp["norm1"])
        y = hubert_mod._linear(torch.nn.functional.gelu(
            hubert_mod._linear(x, lp["fc1"])), lp["fc2"])
        x = hubert_mod._layer_norm(x + y, lp["norm2"])
    want = hubert_mod._linear(x, tparams["final_proj"])
    assert got.dtype == dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the engine on a mesh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def song7():
    """tests/test_parallel.py:test_engine_with_mesh_dp_tp's sine, 7 s."""
    return _sine(7.0)


@pytest.fixture(scope="module")
def unsharded_vc(model):
    return _port(model)


@pytest.fixture(scope="module")
def mesh_vc(model):
    return _port(model, mesh=cpu_mesh(4))


def test_convert_on_a_4x2_mesh(song7, unsharded_vc, mesh_vc, jax_vc):
    """Chunk rows over 4 data shards (a real row on each; the JAX test's
    4x2 mesh less its model axis): against the port's unsharded convert
    (one count) and the JAX package's convert on its 4x1 mesh (JAX_GAP)."""
    opts = MESH_OPTS
    out, sr = mesh_vc.convert(song7, ConversionOptions(**opts))
    ref, ref_sr = unsharded_vc.convert(song7, ConversionOptions(**opts))
    assert sr == ref_sr == SR and np.abs(out).max() > 1000
    _within_one_count(out, ref)
    jout, jsr = jax_vc.convert(song7, JaxOptions(**opts))
    assert jsr == SR
    _within_jax_gap(out, jout)


def test_convert_batch_on_a_4x2_mesh(unsharded_vc, mesh_vc, jax_vc):
    """tests/test_parallel.py:test_engine_mesh_convert_batch_multisong's two
    songs, at 4 and 3 s (two chunks each, packed into one batch, a real
    row on each of the 4 data shards): against the port's unsharded
    convert_batch and the JAX package's on its 4x1 mesh."""
    songs = [_sine(4.0, noise=0.01, seed=3), _sine(3.0, hz=330.0, amp=0.25,
                                                   noise=0.01, seed=4)]
    opts = dict(MESH_OPTS, seed=5)
    got = mesh_vc.convert_batch(songs, ConversionOptions(**opts))
    want = unsharded_vc.convert_batch(songs, ConversionOptions(**opts))
    refs = jax_vc.convert_batch(songs, JaxOptions(**opts))
    assert len(got) == len(want) == len(refs) == 2
    for (a, sra), (b, srb), (j, srj) in zip(got, want, refs):
        assert sra == srb == srj == SR
        _within_one_count(a, b)
        _within_jax_gap(a, j)


@pytest.fixture(scope="module")
def unsharded_short():
    """{chunk_batch: the unsharded convert of the short song}, filled as
    the shape tests ask."""
    return {}


@pytest.mark.parametrize("shape,chunk_batch",
                         [((1, 1), 2), ((2, 1), 2), ((3, 1), 3), ((4, 1), 4)])
def test_other_mesh_shapes(model, unsharded_short, shape, chunk_batch):
    """The data axes of test_dryrun_multichip_other_mesh_shapes (2 and 3
    shards, chunk_batch = n_data as the dryrun sets it), 4 shards and a
    one-shard mesh, on a 4 s song of two chunks (one batch): within one
    count of the unsharded convert; the one-shard mesh byte for byte."""
    engine = dict(SHORT_ENGINE, chunk_batch=chunk_batch)
    song = _sine(4.0, noise=0.01, seed=6)
    opts = ConversionOptions(**BENCH_OPTS)
    got, sr = _port(model, engine, mesh=cpu_mesh(shape[0])).convert(song, opts)
    if chunk_batch not in unsharded_short:
        unsharded_short[chunk_batch] = _port(model, engine).convert(song, opts)
    want, want_sr = unsharded_short[chunk_batch]
    assert sr == want_sr == SR
    if shape == (1, 1):
        np.testing.assert_array_equal(got, want)
    else:
        _within_one_count(got, want)


def test_nof0_on_a_2x2_mesh(model):
    """The no-f0 generator over 2 data shards (the dryrun's third run, less
    its model axis)."""
    nof0 = hop320_model(sr=SR, use_f0=False)
    engine = dict(SHORT_ENGINE, chunk_batch=2)
    song = _sine(3.0, hz=330.0, noise=0.01, seed=7)
    opts = ConversionOptions(index_rate=0.5, protect=0.5)
    got, _ = _port(nof0, engine, mesh=cpu_mesh(2)).convert(song, opts)
    want, _ = _port(nof0, engine).convert(song, opts)
    _within_one_count(got, want)


def test_mesh_prewarm_contract(model, monkeypatch):
    """The counterpart of test_prewarm_zero_recompile_on_mesh: prewarm on a
    2-shard mesh runs each distinct bucket's batch through every data shard,
    builds and loads no kernel (cuda_build's counts), and the convert after
    it gives the bytes of a mesh converter never prewarmed."""
    engine = dict(SHORT_ENGINE, chunk_batch=2)
    song = _sine(2.0, noise=0.01, seed=8)
    opts = ConversionOptions(**BENCH_OPTS)
    fresh, _ = _port(model, engine, mesh=cpu_mesh(2)).convert(song, opts)
    vc = _port(model, engine, mesh=cpu_mesh(2))
    shard_calls = []
    real = VoiceConverter._shard_rows
    monkeypatch.setattr(vc, "_shard_rows", lambda shard, *a: shard_calls.append(shard)
                        or real(vc, shard, *a))
    before = cuda_build.counts()
    n = vc.prewarm(song, opts)
    buckets = set(vc._batch_geometry(vc._prepare_song(song, opts).plan)[1])
    assert n == 1 + len(buckets) + 1  # F0 pass, each bucket, the gain
    assert len(shard_calls) == 2 * len(buckets)
    assert {id(s) for s in shard_calls} == {id(s) for s in vc._data_shards()}
    assert cuda_build.counts() == before
    got, _ = vc.convert(song, opts)
    np.testing.assert_array_equal(got, fresh)


def test_mesh_guards(model):
    """chunk_batch must split over the data shards, and a device given with
    a mesh must be its primary; both raise before any weight is placed."""
    with pytest.raises(ValueError, match="does not split"):
        _port(model, dict(MESH_ENGINE, chunk_batch=3), mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="primary"):
        build_synthetic_converter(tiny=True, device="meta", mesh=cpu_mesh(1))
    vc = _port(model, dict(MESH_ENGINE, chunk_batch=2), mesh=cpu_mesh(2))
    assert vc.device == torch.device("cpu") and len(vc._data_shards()) == 2


# ---------------------------------------------------------------------------
# kernels launch on their tensors' device
# ---------------------------------------------------------------------------


def test_launch_uses_the_given_devices_guard_and_stream(monkeypatch):
    """cuda_build.launch enters the given device's guard and passes that
    device's current stream, whatever device is current; a nonzero return
    raises."""
    events = []

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 0x1000 + dev.index

    @contextlib.contextmanager
    def guard(dev):
        events.append(("enter", dev))
        yield
        events.append(("exit", dev))

    monkeypatch.setattr(cuda_build.torch.cuda, "device", guard)
    monkeypatch.setattr(cuda_build.torch.cuda, "current_stream",
                        lambda dev=None: events.append(("stream", dev)) or Stream(dev))

    def kernel(*args):
        events.append(("call", args[:-1], args[-1].value))
        return 0

    dev = torch.device("cuda", 1)
    cuda_build.launch(kernel, dev, ctypes.c_int(3), 7)
    assert [e[0] for e in events] == ["enter", "stream", "call", "exit"]
    assert events[0][1] == dev and events[1][1] == dev
    assert events[2][2] == 0x1001 and events[2][1][1] == 7

    def failing(*args):
        return 700

    failing.__name__ = "failing"
    with pytest.raises(RuntimeError, match="failing: CUDA error 700"):
        cuda_build.launch(failing, dev)
