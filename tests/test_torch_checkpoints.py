"""The port's checkpoint, index and converter loading against the JAX
package's loaders, on files written on the spot with torch.save and the
port's own faiss writer (tiny models; no download)."""

import dataclasses
import io
import os
import pickle
import struct

import numpy as np
import pytest
import torch

from polgen_rvc_tpu.convert import faiss_index as jax_faiss
from polgen_rvc_tpu.convert.hubert_ckpt import load_hubert_checkpoint as jax_load_hubert
from polgen_rvc_tpu.convert.rmvpe_ckpt import load_rmvpe_checkpoint as jax_load_rmvpe
from polgen_rvc_tpu.convert.rvc_ckpt import load_rvc_checkpoint as jax_load_rvc
from polgen_rvc_tpu.pipeline.config import (
    ConversionOptions as JaxOptions, EngineConfig as JaxEngineConfig,
)
from polgen_rvc_tpu.pipeline.factory import build_converter as jax_build_converter
from polgen_rvc_tpu.utils.metrics import mel_distortion_db
from polgen_rvc_tpu_torch.convert import faiss_index as port_faiss
from polgen_rvc_tpu_torch.convert.hubert_ckpt import (
    _Stub, _TolerantUnpickler, _tolerant_torch_load, load_hubert_checkpoint,
)
from polgen_rvc_tpu_torch.convert.rmvpe_ckpt import load_rmvpe_checkpoint
from polgen_rvc_tpu_torch.convert.rvc_ckpt import load_rvc_checkpoint
from polgen_rvc_tpu_torch.convert.synthetic import make_hubert_state
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.factory import (
    build_converter, build_synthetic_converter, write_synthetic_files,
)
from polgen_rvc_tpu_torch.retrieval.topk import load_index_bank
from test_torch_batch import one_intra_op_thread  # noqa: F401 (autouse)
from test_torch_pipeline import BENCH_OPTS, SMOKE_ENGINE, jax_noise


def assert_trees_equal(a, b, path=""):
    """Nested dicts/lists of numpy arrays, bit for bit."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype)
        assert np.array_equal(x, y), path


def _song(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    vibrato = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
    return (0.4 * np.sin(2 * np.pi * 220.0 * t * vibrato)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


@pytest.mark.parametrize("kw", [dict(sr=48000), dict(sr=48000, use_f0=False),
                                dict(sr=32000, version="v1")],
                         ids=["v2_48k_f0", "v2_48k_nof0", "v1_32k_f0"])
def test_rvc_checkpoint_matches_jax_loader(tmp_path, kw):
    paths = write_synthetic_files(str(tmp_path), "v", tiny=True, **kw)
    cfg, params, sr = load_rvc_checkpoint(paths["rvc"])
    jcfg, jparams, jsr = jax_load_rvc(paths["rvc"])
    assert sr == jsr == kw["sr"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.use_f0 == kw.get("use_f0", True)
    assert_trees_equal(params, jparams)


def test_rvc_checkpoint_defaults_and_speaker_count(tmp_path):
    """f0 defaults to 1 and version to "v1" when the file omits them; the
    speaker count comes from emb_g.weight, as the JAX loader takes it."""
    paths = write_synthetic_files(str(tmp_path), "v", tiny=True, sr=32000, version="v1")
    cpt = torch.load(paths["rvc"], weights_only=True)
    cpt["weight"]["emb_g.weight"] = torch.cat([cpt["weight"]["emb_g.weight"]] * 3)
    del cpt["f0"], cpt["version"]
    path = str(tmp_path / "bare.pth")
    torch.save(cpt, path)
    cfg, params, _ = load_rvc_checkpoint(path)
    jcfg, jparams, _ = jax_load_rvc(path)
    assert cfg.use_f0 and cfg.input_dim == 256 and cfg.spk_embed_dim == 3
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(params, jparams)


def test_rvc_checkpoint_invalid_format(tmp_path):
    path = str(tmp_path / "bad.pth")
    torch.save({"model": {"w": torch.ones(2)}}, path)
    with pytest.raises(ValueError, match="Invalid checkpoint format"):
        load_rvc_checkpoint(path)
    with pytest.raises(ValueError, match="Invalid checkpoint format"):
        jax_load_rvc(path)


class UnknownFairseqConfig:
    """Stands in for a fairseq/omegaconf config class: not on the loader's
    allow-list, so it loads as a stub that keeps its state."""

    def __init__(self, heads):
        self.model = {"encoder_attention_heads": heads}
        self.task = {"sample_rate": 16000}


def test_hubert_checkpoint_with_unknown_config_class(tmp_path):
    """A fairseq-layout file whose cfg is a class the loader does not know:
    the head count (4, which no embed width implies) is recovered from the
    stub, and cfg and params equal the JAX loader's bit for bit."""
    cfg, sd = make_hubert_state(tiny=True, seed=3)
    path = str(tmp_path / "hubert_base.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "cfg": UnknownFairseqConfig(cfg.n_heads)}, path)
    ckpt = _tolerant_torch_load(path)
    assert isinstance(ckpt["cfg"], _Stub)
    hcfg, params = load_hubert_checkpoint(path)
    jcfg, jparams = jax_load_hubert(path)
    assert hcfg == cfg and hcfg.n_heads == 4
    assert dataclasses.asdict(hcfg) == dataclasses.asdict(jcfg)
    assert_trees_equal(params, jparams)


class _Exploit:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (os.system, (f"touch {self.marker}",))


def test_tolerant_unpickler_calls_nothing(tmp_path):
    """Mirrors tests/test_hardening.py:61-103: a pickle that names os.system
    yields a stub; the command never runs, from bytes or from a .pt file."""
    marker = tmp_path / "pwned"
    payload = pickle.dumps(_Exploit(marker))
    assert b"system" in payload
    assert isinstance(_TolerantUnpickler(io.BytesIO(payload)).load(), _Stub)
    path = str(tmp_path / "evil.pt")
    torch.save({"model": {"w": torch.ones(3)}, "cfg": _Exploit(marker)}, path)
    ckpt = _tolerant_torch_load(path)
    assert isinstance(ckpt["cfg"], _Stub)
    assert torch.equal(ckpt["model"]["w"], torch.ones(3))
    assert not marker.exists()


@pytest.mark.parametrize("layout", ["raw pickle", "legacy torch.save"])
def test_tolerant_loader_guards_every_pickle(tmp_path, layout):
    """A file that is not a zip archive takes torch.load's legacy route,
    which reads its header pickles with the pickle module's own load: a
    raw pickle naming os.system, or one inside a legacy-format file, runs
    nothing either."""
    marker = tmp_path / "pwned"
    path = str(tmp_path / "evil.pt")
    if layout == "raw pickle":
        with open(path, "wb") as f:
            f.write(pickle.dumps(_Exploit(marker)))
        with pytest.raises(Exception):
            _tolerant_torch_load(path)
    else:
        torch.save({"model": {"w": torch.ones(3)}, "cfg": _Exploit(marker)}, path,
                   _use_new_zipfile_serialization=False)
        ckpt = _tolerant_torch_load(path)
        assert isinstance(ckpt["cfg"], _Stub)
        assert torch.equal(ckpt["model"]["w"], torch.ones(3))
    assert not marker.exists()


def test_rmvpe_checkpoint_matches_jax_loader(tmp_path):
    paths = write_synthetic_files(str(tmp_path), "v", tiny=True)
    assert_trees_equal(load_rmvpe_checkpoint(paths["rmvpe"]),
                       jax_load_rmvpe(paths["rmvpe"]))


def _ivf_data(rng, n=257, d=24, nlist=7):
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    cents = rng.standard_normal((nlist, d)).astype(np.float32)
    assign = ((vecs[:, None] - cents[None]) ** 2).sum(-1).argmin(1)
    return vecs, cents, assign


def _write_sparse_ivf(path, vecs, cents, assign):
    """An IVF-Flat file whose inverted lists use faiss's "sprs" size
    encoding: (list id, size) pairs for the non-empty lists only."""
    full = str(path) + ".full"
    port_faiss.write_ivf_flat(full, vecs, cents, assign)
    data = open(full, "rb").read()
    nlist, d = cents.shape
    sizes = np.bincount(assign, minlength=nlist).astype(np.uint64)
    head = data.index(struct.pack("<I", port_faiss.FOURCC_FULL))
    tail = head + 4 + 8 + nlist * 8
    nz = np.nonzero(sizes)[0]
    pairs = np.stack([nz.astype(np.uint64), sizes[nz]], 1).reshape(-1)
    sprs = (struct.pack("<I", port_faiss.FOURCC_SPRS)
            + struct.pack("<Q", pairs.size) + pairs.tobytes())
    open(path, "wb").write(data[:head] + sprs + data[tail:])


@pytest.mark.parametrize("writer,reader", [
    ("port", "port"), ("port", "jax"), ("jax", "port"),
])
def test_faiss_index_round_trip(rng, tmp_path, writer, reader):
    """Files written by either package read back by the other: the same
    vectors in id order, the same centroids."""
    vecs, cents, assign = _ivf_data(rng)
    path = str(tmp_path / "x.index")
    {"port": port_faiss, "jax": jax_faiss}[writer].write_ivf_flat(path, vecs, cents, assign)
    idx = {"port": port_faiss, "jax": jax_faiss}[reader].read_faiss_index(path)
    assert (idx.d, idx.ntotal, idx.nlist) == (24, 257, 7)
    np.testing.assert_array_equal(idx.vectors, vecs)
    np.testing.assert_array_equal(idx.centroids, cents)
    if reader == "port":
        np.testing.assert_array_equal(load_index_bank(path), vecs)


def test_faiss_index_writers_agree_byte_for_byte(rng, tmp_path):
    vecs, cents, assign = _ivf_data(rng)
    a, b = str(tmp_path / "a.index"), str(tmp_path / "b.index")
    port_faiss.write_ivf_flat(a, vecs, cents, assign)
    jax_faiss.write_ivf_flat(b, vecs, cents, assign)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_faiss_sparse_lists(rng, tmp_path):
    vecs, cents, _ = _ivf_data(rng, n=10, d=8, nlist=64)
    assign = np.array([0, 5, 5, 63, 0, 5, 17, 17, 0, 63])
    path = str(tmp_path / "sprs.index")
    _write_sparse_ivf(path, vecs, cents, assign)
    idx = port_faiss.read_faiss_index(path)
    assert idx.ntotal == 10 and idx.nlist == 64
    np.testing.assert_array_equal(idx.vectors, vecs)
    np.testing.assert_array_equal(idx.vectors, jax_faiss.read_faiss_index(path).vectors)


def test_faiss_flat_index(rng, tmp_path):
    """A bare IndexFlatL2 file (no IVF): the vectors as stored."""
    vecs = rng.standard_normal((33, 16)).astype(np.float32)
    out = bytearray(struct.pack("<I", port_faiss.FOURCC_IXF2))
    out = port_faiss._write_index_header(out, 16, 33, port_faiss.METRIC_L2)
    out += struct.pack("<Q", vecs.nbytes) + vecs.tobytes()
    path = tmp_path / "flat.index"
    path.write_bytes(bytes(out))
    idx = port_faiss.read_faiss_index(str(path))
    np.testing.assert_array_equal(idx.vectors, vecs)
    assert idx.metric == port_faiss.METRIC_L2 and idx.nlist == 0


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """The tiny 48 kHz model set as files, with an f0 and a no-f0 voice."""
    root = str(tmp_path_factory.mktemp("assets"))
    files = {"f0": write_synthetic_files(root, "voice", tiny=True, sr=48000,
                                         index_vectors=256)}
    files["nof0"] = write_synthetic_files(root, "speech", tiny=True, sr=48000,
                                          index_vectors=256, use_f0=False)
    return files


@pytest.mark.parametrize("kind", ["f0", "nof0"])
def test_build_converter_equals_synthetic(model_files, kind):
    """build_converter over the written files converts byte for byte as
    build_synthetic_converter does on the same seeds (default noise)."""
    eng = EngineConfig(**SMOKE_ENGINE)
    p = model_files[kind]
    vc = build_converter(p["rvc"], p["hubert"], p["rmvpe"], p["index"],
                         engine=eng, device="cpu")
    ref = build_synthetic_converter(tiny=True, sr=48000, index_vectors=256,
                                    engine=eng, device="cpu", use_f0=kind == "f0")
    assert (vc.rmvpe_params is None) == (kind == "nof0")
    song = _song(3.0)
    opts = ConversionOptions(**BENCH_OPTS)
    out, sr = vc.convert(song, opts)
    np.testing.assert_array_equal(out, ref.convert(song, opts)[0])
    assert sr == 48000 and np.abs(out).max() > 1000


def test_build_converter_matches_jax(model_files):
    """The port's and the JAX package's build_converter over the same files
    (the no-f0 voice, so no F0 pass on either side), the JAX noise replayed
    through the provider: within the repo's 0.5 dB gate."""
    p = model_files["nof0"]
    vc = build_converter(p["rvc"], p["hubert"], p["rmvpe"], p["index"],
                         engine=EngineConfig(**SMOKE_ENGINE), device="cpu")
    vc.noise_provider = jax_noise
    jvc = jax_build_converter(p["rvc"], p["hubert"], p["rmvpe"], p["index"],
                              engine=JaxEngineConfig(**SMOKE_ENGINE))
    song = _song(3.0)
    out, sr = vc.convert(song, ConversionOptions(**BENCH_OPTS))
    jout, jsr = jvc.convert(song, JaxOptions(**BENCH_OPTS))
    assert jsr == sr == 48000 and out.shape == jout.shape
    assert np.abs(out).max() > 1000
    dist = mel_distortion_db(out, jout, sr)
    assert dist < 0.5, f"mel distortion {dist:.3f} dB"


def test_build_converter_optional_files(model_files, tmp_path):
    """Without rmvpe and index paths, no RMVPE weights and no bank; CREPE
    and FCPE load through their own loaders."""
    from polgen_rvc_tpu_torch.convert.crepe_ckpt import make_crepe_state
    from polgen_rvc_tpu_torch.convert.fcpe_ckpt import make_fcpe_state

    crepe = str(tmp_path / "crepe_full.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in
                make_crepe_state(seed=5).items()}, crepe)
    fcpe_cfg, fcpe_sd = make_fcpe_state(tiny=True, seed=6)
    fcpe = str(tmp_path / "fcpe.pt")
    torch.save({"config": {"model": {"n_layers": fcpe_cfg.n_layers,
                                     "n_chans": fcpe_cfg.n_chans},
                           "mel": {"hop_size": fcpe_cfg.hop_size}},
                "model": {k: torch.from_numpy(v) for k, v in fcpe_sd.items()}}, fcpe)
    vc = build_converter(model_files["f0"]["rvc"], model_files["f0"]["hubert"],
                         crepe_path=crepe, fcpe_path=fcpe, device="cpu")
    assert vc.rmvpe_params is None and vc.index_bank is None
    assert vc.crepe_params is not None and vc.fcpe_params is not None
    assert vc.fcpe_cfg.n_layers == fcpe_cfg.n_layers
