"""The port's prewarm and the kernel build's lock, on the CPU.

prewarm at bench.py's CPU-smoke tiers on the tiny converter: a prewarmed
converter gives the bytes of one never prewarmed (rate on and off), visits
each distinct bucket of the song's chunk batches once, runs the fcpe and
mangio-crepe F0 passes, and returns the count its docstring defines. The
kernel build: two threads that load one kernel at once build it once
(nvcc and the library loader are faked: the CPU has neither)."""

import subprocess
import threading

import numpy as np
import pytest

from polgen_rvc_tpu_torch.ops import cuda_build
from polgen_rvc_tpu_torch.pipeline import engine as engine_mod
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
from test_torch_pipeline import (  # noqa: F401 (one_intra_op_thread: autouse)
    BENCH_OPTS, SMOKE_ENGINE, _bench_song, one_intra_op_thread,
)


def _converter(**kw):
    return build_synthetic_converter(tiny=True, sr=48000, index_vectors=256,
                                     engine=EngineConfig(**SMOKE_ENGINE), device="cpu",
                                     **kw)


@pytest.fixture(scope="module")
def fresh_and_prewarmed():
    return _converter(), _converter()


# one chunk on the smoke tiers' 4 s bucket: the tiny HuBERT (a 20-sample
# hop) makes every batch of a longer bucket cost seconds on the CPU
SONG_S = 2.0


@pytest.mark.parametrize("volume_envelope", [0.25, 1.0], ids=["rate_on", "rate_off"])
def test_prewarmed_convert_equals_a_fresh_one(fresh_and_prewarmed, volume_envelope):
    fresh, warm = fresh_and_prewarmed
    song = _bench_song(SONG_S)
    opts = ConversionOptions(**{**BENCH_OPTS, "volume_envelope": volume_envelope})
    n = warm.prewarm(song, opts)
    plan = warm._prepare_song(song, opts).plan
    buckets = set(warm._batch_geometry(plan)[1])
    # no kernel on the CPU + the F0 pass + each distinct bucket (+ the gain)
    assert n == 1 + len(buckets) + (volume_envelope != 1.0)
    got, sr = warm.convert(song, opts)
    want, want_sr = fresh.convert(song, opts)
    assert sr == want_sr == 48000
    assert got.dtype == np.int16 and np.array_equal(got, want)


@pytest.mark.parametrize("seconds,batches,distinct", [(8.0, 2, 1), (14.0, 3, 3)])
def test_prewarm_visits_each_distinct_bucket_once(fresh_and_prewarmed, monkeypatch,
                                                  seconds, batches, distinct):
    """A spy on _convert_rows: one call per distinct bucket, with the
    chunks of the first batch that has it, in the batches' order (8 s: two
    batches on the 6 s bucket; 14 s: batches on the 6, 8 and 4 s buckets)."""
    _, vc = fresh_and_prewarmed
    song = _bench_song(seconds)
    opts = ConversionOptions(**{**BENCH_OPTS, "volume_envelope": 1.0})
    calls = []
    monkeypatch.setattr(vc, "_convert_rows", lambda entries, bucket, o: calls.append(
        (bucket, [ci for _, ci, _ in entries])) or [])
    n = vc.prewarm(song, opts)
    idxs, buckets = vc._batch_geometry(vc._prepare_song(song, opts).plan)
    first = {}
    for ids, b in zip(idxs, buckets):
        first.setdefault(b, ids)
    assert (len(buckets), len(first)) == (batches, distinct)
    assert calls == list(first.items())
    assert n == 1 + distinct


def test_prewarm_runs_the_fcpe_and_crepe_f0_passes(monkeypatch):
    """mangio-crepe and fcpe: prewarm runs that method's own F0 pass (the
    port's analogue of the JAX package's zero-recompile test for them)."""
    vc = build_synthetic_converter(
        tiny=True, sr=48000, device="cpu", with_crepe=True, with_fcpe=True,
        engine=EngineConfig(x_pad=1, x_query=2, x_center=6, x_max=8, chunk_batch=1,
                            bucket_step_s=2))
    ran = []
    for name in ("crepe_f0", "fcpe_f0_device", "fcpe_f0"):
        real = getattr(engine_mod, name)
        monkeypatch.setattr(engine_mod, name,
                            lambda *a, _n=name, _f=real, **k: ran.append(_n) or _f(*a, **k))
    song = _bench_song(2.0)
    for method, want in (("mangio-crepe", "crepe_f0"), ("fcpe", "fcpe_f0_device")):
        ran.clear()
        opts = ConversionOptions(f0_method=method, hop_length=160)
        assert vc.prewarm_kernels(opts)[-3:] == ("resblock_group", "conv_transpose",
                                                 "band_attention")
        n = vc.prewarm(song, opts)
        assert ran == [want], (method, ran)
        assert n == 1 + 1 + 1  # F0 pass, one bucket, gain
    assert vc.prewarm_kernels(ConversionOptions(f0_method="mangio-crepe"))[0] == "viterbi"
    assert vc.prewarm_kernels(ConversionOptions())[0] == "unet_chain"
    assert len(vc.prewarm_kernels(ConversionOptions(f0_method="fcpe"))) == 3


class _FakeNvcc:
    """subprocess.Popen for nvcc: writes the -o file when waited on, and
    records how many builds run at once."""

    lock = threading.Lock()
    started = []
    running = 0
    most = 0

    def __init__(self, cmd, **kwargs):
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = None
        cls = type(self)
        with cls.lock:
            cls.started.append(self.out)
            cls.running += 1
            cls.most = max(cls.most, cls.running)

    def communicate(self):
        threading.Event().wait(0.05)  # a build takes a while
        with open(self.out, "wb") as f:
            f.write(b"\x7fELF")
        cls = type(self)
        with cls.lock:
            cls.running -= 1
        self.returncode = 0
        return "ptxas info: 0 registers", None


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    class Nvcc(_FakeNvcc):
        started = []
        running = 0
        most = 0

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", Nvcc)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: ("lib", path))
    return Nvcc


def test_concurrent_loads_build_once(fake_build):
    before = cuda_build.counts()
    barrier = threading.Barrier(2)
    got = []

    def first_launch():
        barrier.wait(timeout=10)
        got.append(cuda_build.load("resblock_group"))

    threads = [threading.Thread(target=first_launch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(fake_build.started) == 1
    assert len(got) == 2 and got[0] is got[1]
    assert cuda_build.library_path("resblock_group").exists()
    after = cuda_build.counts()
    assert after["builds"] - before["builds"] == 1
    assert after["loads"] - before["loads"] == 1


def test_build_all_caps_the_nvcc_processes(fake_build):
    before = cuda_build.counts()
    reports = cuda_build.build_all(cuda_build.KERNELS, max_workers=2)
    assert sorted(reports) == sorted(cuda_build.KERNELS)
    assert fake_build.most == 2 and len(fake_build.started) == len(cuda_build.KERNELS)
    assert cuda_build.build_all(cuda_build.KERNELS) == {}  # built: nothing to do
    assert cuda_build.counts()["builds"] - before["builds"] == len(cuda_build.KERNELS)
