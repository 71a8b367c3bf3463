"""The port's device mesh on the CPU: the counterpart of tests/test_parallel.py.

Meshes of "cpu" places, one device named several times: the port's
stand-in for the 8 virtual CPU devices the JAX tests run on
(tests/conftest.py). The model is the tiny one with HuBERT's feature
extractor at the real 320-sample hop (tests/test_torch_batch.py), at
32 kHz (the tiny decoder, padded to 32 channels a stage, is most of a
convert's CPU time); the same numpy weights go to the JAX package's
converter, and the port's converts replay the JAX engine's noise.

Bounds. Sharded against unsharded, in the port: at most 1 int16 count on
< 1% of samples, the JAX tests' own bound (test_parallel.py:112-121): the
rows are computed apart and the noise is keyed by (seed, chunk id), so
only float32 summation order differs (a batch of fewer rows, HuBERT's
partial sums). Port on the mesh against JAX on its mesh: JAX_GAP, set
from the readings, since the two frameworks' convolutions sum in other
orders all along the path. The port's unsharded convert reads the same
against JAX as its mesh convert does: at most 10 counts on 30-41% of the
samples, 0.0008-0.0010 dB. A mesh that adds o's and fc2's biases in each
of its two model shards reads 2,953 counts on 99.8% of the samples, 0.40
dB: inside the repo's 0.5 dB gate, so that gate alone would not catch it.
HuBERT's tensor-parallel
forward, against the unsharded forward and JAX's on its 4x2 virtual mesh:
1e-5 of the largest |feature| (float32 order only; o's and fc2's biases
are nonzero, so a bias added in every shard would miss by n_model - 1
times it).
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
from polgen_rvc_tpu_torch.models.hubert import (
    HubertConfig, hubert_extract, hubert_extract_tp,
)
from polgen_rvc_tpu_torch.ops import cuda_build
from polgen_rvc_tpu_torch.parallel import (
    make_mesh, replicate, shard_batch, shard_hubert_params,
)
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.engine import VoiceConverter
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
from test_torch_batch import hop320_model
from test_torch_pipeline import BENCH_OPTS, jax_noise, one_intra_op_thread  # noqa: F401

SR = 32000
# shorter tiers than tests/test_parallel.py's (x_query 2, x_center 4, x_max
# 5): its 9 s sine is three chunks on an 8 s bucket, one row of four idle;
# here a 7 s sine is four chunks on a 6 s bucket, a real row on every data
# shard of the 4x2 mesh, for three quarters of the CPU time
SHORT_ENGINE = dict(x_pad=1, x_query=1, x_center=2, x_max=3, bucket_step_s=2)
MESH_ENGINE = dict(SHORT_ENGINE, chunk_batch=4)
MESH_OPTS = dict(index_rate=0.4, protect=0.2)


def cpu_mesh(n_data, n_model):
    return make_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))


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
    """The JAX package's converter on a 4x2 virtual mesh over the same
    weights (its HuBERT swapped for the hop-320 one, sharded, before any
    convert), shared by the convert and convert_batch tests, whose batches
    run at one bucket: one compile of its chunk graph."""
    jm = jax_mesh.make_mesh(4, 2)
    jvc = jax_synthetic(tiny=True, sr=SR, index_vectors=256,
                        engine=JaxEngineConfig(**MESH_ENGINE), mesh=jm)
    jvc.hubert_cfg = JaxHubertConfig(**dataclasses.asdict(model["hubert_cfg"]))
    jvc.hubert_params = jax_mesh.shard_hubert_params(model["hubert_params"], jm)
    return jvc


# ---------------------------------------------------------------------------
# the mesh and its placements
# ---------------------------------------------------------------------------


def test_mesh_shapes(monkeypatch):
    mesh = cpu_mesh(4, 2)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.devices.shape == (4, 2) and mesh.primary == torch.device("cpu")
    assert mesh.distinct() == [torch.device("cpu")]
    assert make_mesh(devices=["cpu"] * 8).shape == {"data": 8, "model": 1}
    assert make_mesh(n_model=2, devices=["cpu"] * 8).shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError, match="need that many devices"):
        make_mesh(4, 2, devices=["cpu"] * 7)
    # the default takes every visible card, and raises without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    mesh = make_mesh()
    assert list(mesh.devices[:, 0]) == [torch.device("cuda:0"), torch.device("cuda:1")]
    # an unindexed "cuda" is held as the current card, so it compares equal
    # to the device its tensors report
    assert make_mesh(1, 1, devices=["cuda"]).primary == torch.device("cuda:1")


def test_shard_batch_layout(rng):
    mesh = cpu_mesh(4, 2)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))
    blocks = shard_batch(x, mesh)
    assert [tuple(b.shape) for b in blocks] == [(2, 16)] * 4
    assert all(b.device == mesh.devices[d, 0] for d, b in enumerate(blocks))
    assert torch.equal(torch.cat(blocks), x)
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(x[:6], mesh)


def test_replicate_shares_a_repeated_device():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), None], "n": 7}
    reps = replicate(tree, cpu_mesh(4, 2))
    assert list(reps) == [torch.device("cpu")]
    rep = reps[torch.device("cpu")]
    assert rep["a"] is tree["a"] and rep["b"][0] is tree["b"][0]
    assert rep["b"][1] is None and rep["n"] == 7


@pytest.fixture(scope="module")
def tiny_hubert():
    """JAX's tiny HuBERT (tests/test_parallel.py's), numpy parameters."""
    cfg, sd = make_hubert_state(tiny=True)
    return cfg, convert_hubert_state(sd, cfg)


def _pairs(port, ref, path=()):
    """(path, port leaf, JAX leaf) over two parameter trees of one layout."""
    if isinstance(port, dict):
        assert set(port) == set(ref), path
        for k in port:
            yield from _pairs(port[k], ref[k], path + (k,))
    elif isinstance(port, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            yield from _pairs(a, b, path + (i,))
    else:
        yield path, port, ref


def test_tp_params_are_split_like_jax(tiny_hubert):
    """Shard shapes of tests/test_parallel.py:test_tp_params_actually_sharded,
    the conv extractor's leaves shared and not split, and every leaf of
    every place equal to the JAX placement's shard on that place's device."""
    cfg, params = tiny_hubert
    mesh = cpu_mesh(4, 2)
    shards = shard_hubert_params(params_to_torch(params), mesh, cfg.n_heads)
    assert len(shards) == 4 and all(len(row) == 2 for row in shards)
    d, f = cfg.embed_dim, cfg.ffn_dim
    lp = shards[0][1]["encoder"]["layers"][0]
    assert tuple(lp["attn"]["q"]["w"].shape) == (d, d // 2)
    assert tuple(lp["attn"]["o"]["w"].shape) == (d // 2, d)
    assert tuple(lp["fc1"]["w"].shape) == (d, f // 2)
    assert tuple(lp["fc2"]["w"].shape) == (f // 2, d)
    conv = [row[m]["feature_extractor"]["convs"][0]["w"] for row in shards for m in (0, 1)]
    assert all(w is conv[0] for w in conv) and conv[0].shape[0] == cfg.conv_layers[0][0]
    jm = jax_mesh.make_mesh(4, 2)
    jshards = jax_mesh.shard_hubert_params(params, jm)
    n = 0
    for path, leaf, jleaf in _pairs(shards[0][0], jshards):
        for dd in range(4):
            for m in range(2):
                port_leaf = shards[dd][m]
                for k in path:
                    port_leaf = port_leaf[k]
                by_device = {s.device: s.data for s in jleaf.addressable_shards}
                want = np.asarray(by_device[jm.devices[dd, m]])
                np.testing.assert_array_equal(port_leaf.numpy(), want, err_msg=str(path))
                n += 1
    assert n == 8 * len(jax.tree.leaves(params))
    with pytest.raises(ValueError, match="split evenly"):
        shard_hubert_params(params_to_torch(params), cpu_mesh(1, 3), cfg.n_heads)


@pytest.mark.parametrize("shape", [(1, 2), (4, 2)])
def test_tp_hubert_forward(tiny_hubert, shape):
    """The tensor-parallel forward, each data row of the mesh on its rows,
    against the unsharded port forward and JAX's jitted forward on the
    same placement of its virtual mesh, with padded rows."""
    cfg, params = tiny_hubert
    for lp in params["encoder"]["layers"]:
        assert np.abs(lp["attn"]["o"]["b"]).max() > 1e-3
        assert np.abs(lp["fc2"]["b"]).max() > 1e-3
    n_data, n_model = shape
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((4, 4000)).astype(np.float32)
    valid = np.array([4000, 3100, 2500, 4000])
    wav[np.arange(4000)[None, :] >= valid[:, None]] = 0.0
    frames = cfg.num_frames(4000)
    pad = np.arange(frames)[None, :] >= np.array([cfg.num_frames(v) for v in valid])[:, None]
    tcfg = HubertConfig(**dataclasses.asdict(cfg))
    tparams = params_to_torch(params)
    args = [torch.from_numpy(a) for a in (wav, pad, valid)]
    kw = dict(output_layer=cfg.n_layers)
    ref = hubert_extract(tparams, tcfg, args[0], padding_mask=args[1],
                         valid_samples=args[2], **kw)
    mesh = cpu_mesh(n_data, n_model)
    shards = shard_hubert_params(tparams, mesh, cfg.n_heads)
    parts = [hubert_extract_tp(shards[d], list(mesh.devices[d]), tcfg, w,
                               padding_mask=p, valid_samples=v, **kw)
             for d, (w, p, v) in enumerate(zip(*(a.chunk(n_data) for a in args)))]
    got = torch.cat(parts).numpy()
    tol = 1e-5 * float(ref.abs().max())
    assert np.abs(got - ref.numpy()).max() <= tol
    jm = jax_mesh.make_mesh(n_data, n_model)
    jout = jax.jit(lambda p, w, m, v: jax_hubert_extract(
        p, cfg, w, padding_mask=m, valid_samples=v, **kw))(
        jax_mesh.shard_hubert_params(params, jm),
        *(jax_mesh.shard_batch(jnp.asarray(a), jm) for a in (wav, pad, valid)))
    assert np.abs(got - np.asarray(jout)).max() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_forward_with_one_shard_is_hubert_extract(tiny_hubert, dtype):
    """hubert_extract is the tensor-parallel loop on one shard, and its bytes
    are those of the plain post-LN layer (each projection one _linear), in
    float32 and in bfloat16, where the loop's float32 reduction rounds the
    one partial plus its bias once, as a bf16 add does."""
    cfg, params = tiny_hubert
    tcfg = HubertConfig(**dataclasses.asdict(cfg))
    tparams = params_to_torch(params)
    rng = np.random.default_rng(2)
    wav = torch.from_numpy(rng.standard_normal((2, 3000)).astype(np.float32))
    valid = torch.tensor([3000, 2200])
    pad = (torch.arange(cfg.num_frames(3000))[None, :]
           >= torch.tensor([cfg.num_frames(int(v)) for v in valid])[:, None])
    kw = dict(padding_mask=pad, valid_samples=valid, compute_dtype=dtype)
    got = hubert_extract_tp([tparams], [torch.device("cpu")], tcfg, wav,
                            final_proj=True, **kw)
    assert torch.equal(got, hubert_extract(tparams, tcfg, wav, final_proj=True, **kw))
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
    return _port(model, mesh=cpu_mesh(4, 2))


def test_convert_on_a_4x2_mesh(song7, unsharded_vc, mesh_vc, jax_vc):
    """DP chunk rows over 4 data shards (a real row on each) and TP HuBERT
    over 2 model shards: against the port's unsharded convert (one count)
    and the JAX package's convert on its 4x2 mesh (JAX_GAP)."""
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
    row on each data shard): against the port's unsharded convert_batch and
    the JAX package's on its mesh."""
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


@pytest.mark.parametrize("shape,chunk_batch", [((1, 1), 2), ((2, 1), 2), ((3, 2), 3)])
def test_other_mesh_shapes(model, unsharded_short, shape, chunk_batch):
    """The shapes of test_dryrun_multichip_other_mesh_shapes (2x1 pure DP,
    3x2 DP x TP, chunk_batch = n_data as the dryrun sets it) and a
    one-place mesh, on a 4 s song of two chunks (one batch): within one
    count of the unsharded convert; the one-place mesh byte for byte."""
    n_data, n_model = shape
    engine = dict(SHORT_ENGINE, chunk_batch=chunk_batch)
    song = _sine(4.0, noise=0.01, seed=6)
    opts = ConversionOptions(**BENCH_OPTS)
    got, sr = _port(model, engine, mesh=cpu_mesh(n_data, n_model)).convert(song, opts)
    if chunk_batch not in unsharded_short:
        unsharded_short[chunk_batch] = _port(model, engine).convert(song, opts)
    want, want_sr = unsharded_short[chunk_batch]
    assert sr == want_sr == SR
    if shape == (1, 1):
        np.testing.assert_array_equal(got, want)
    else:
        _within_one_count(got, want)


def test_nof0_on_a_2x2_mesh(model):
    """The no-f0 generator over a DP x TP mesh (the dryrun's third run)."""
    nof0 = hop320_model(sr=SR, use_f0=False)
    engine = dict(SHORT_ENGINE, chunk_batch=2)
    song = _sine(3.0, hz=330.0, noise=0.01, seed=7)
    opts = ConversionOptions(index_rate=0.5, protect=0.5)
    got, _ = _port(nof0, engine, mesh=cpu_mesh(2, 2)).convert(song, opts)
    want, _ = _port(nof0, engine).convert(song, opts)
    _within_one_count(got, want)


def test_mesh_prewarm_contract(model, monkeypatch):
    """The counterpart of test_prewarm_zero_recompile_on_mesh: prewarm on a
    2x2 mesh runs each distinct bucket's batch through every data shard,
    builds and loads no kernel (cuda_build's counts), and the convert after
    it gives the bytes of a mesh converter never prewarmed."""
    engine = dict(SHORT_ENGINE, chunk_batch=2)
    song = _sine(2.0, noise=0.01, seed=8)
    opts = ConversionOptions(**BENCH_OPTS)
    fresh, _ = _port(model, engine, mesh=cpu_mesh(2, 2)).convert(song, opts)
    vc = _port(model, engine, mesh=cpu_mesh(2, 2))
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
        _port(model, dict(MESH_ENGINE, chunk_batch=3), mesh=cpu_mesh(2, 1))
    with pytest.raises(ValueError, match="primary"):
        build_synthetic_converter(tiny=True, device="meta", mesh=cpu_mesh(1, 1))
    vc = _port(model, dict(MESH_ENGINE, chunk_batch=2), mesh=cpu_mesh(2, 1))
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
