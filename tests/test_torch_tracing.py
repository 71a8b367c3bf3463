"""The port's spans and counters (utils/tracing.py), on the CPU.

Profiled tiny converts: the spans nest as the engine's layers do, each
request span carries one request id, no span is a user-scope range (which
would put a mirror on the card's timeline), the frame counters equal the
chunk batches' geometry, and prewarm moves no counter. The spans of the
CREPE and FCPE F0 passes and of the UI server's jobs, too."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.profiler import ProfilerActivity, profile

from polgen_rvc_tpu_torch.pipeline.batch_cover import pack_work
from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
from polgen_rvc_tpu_torch.utils import tracing
from test_torch_pipeline import (  # noqa: F401 (one_intra_op_thread: autouse)
    BENCH_OPTS, SMOKE_ENGINE, _bench_song, one_intra_op_thread,
)

PKG = Path(__file__).resolve().parent.parent / "polgen_rvc_tpu_torch"
REQUESTS = {"polgen.convert", "polgen.convert_batch"}
F0_RMVPE = {"polgen.rmvpe.mel", "polgen.rmvpe.unet", "polgen.rmvpe.bigru",
            "polgen.rmvpe.decode"}
# span -> the spans it holds directly, as the engine's layers nest
CHILDREN = {
    "polgen.prepare": {"polgen.highpass", "polgen.plan", "polgen.upload", "polgen.f0",
                       "polgen.f0_file"},
    "polgen.f0": F0_RMVPE,
    "polgen.chunk_batch": {"polgen.rows", "polgen.noise", "polgen.hubert",
                           "polgen.retrieval", "polgen.protect", "polgen.enc_p",
                           "polgen.flow", "polgen.decoder", "polgen.trim"},
    "polgen.finish": {"polgen.envelope", "polgen.readback", "polgen.host_finalize"},
}
for _request in REQUESTS:
    CHILDREN[_request] = {"polgen.prepare", "polgen.chunk_batch", "polgen.finish"}


@pytest.fixture(scope="module")
def vc():
    return build_synthetic_converter(tiny=True, sr=48000, index_vectors=256,
                                     engine=EngineConfig(**SMOKE_ENGINE), device="cpu")


def program_spans(prof) -> list:
    """[(name, start, end, request inputs, user scope)] of the polgen.* records."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                    list(e.concrete_inputs()), e.is_user_annotation())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("polgen.")), key=lambda s: (s[1], -s[2]))


def nesting(spans) -> set:
    """{(holder or None, span name)}: each span under its innermost holder."""
    pairs, stack = set(), []
    for name, start, end, *_ in spans:
        while stack and stack[-1][1] < end:
            stack.pop()
        pairs.add((stack[-1][0] if stack else None, name))
        stack.append((name, end))
    return pairs


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    return out, program_spans(prof)


@pytest.fixture(scope="module")
def traced(vc, tmp_path_factory):
    """A convert with an F0 file and a convert_batch of two songs, profiled."""
    f0_file = tmp_path_factory.mktemp("f0") / "track.txt"
    f0_file.write_text("\n".join(f"{0.01 * k:.2f},{200 + k:.1f}" for k in range(100)))
    opts = ConversionOptions(**BENCH_OPTS)
    songs = [_bench_song(2.0), _bench_song(3.0)]
    _, convert = profiled(lambda: vc.convert(
        songs[0], ConversionOptions(**BENCH_OPTS, f0_file=str(f0_file))))
    before = tracing.counters()
    _, batch = profiled(lambda: vc.convert_batch(songs, opts))
    after = tracing.counters()
    return {"convert": convert, "convert_batch": batch, "songs": songs,
            "frames": {k: after.get(k, 0) - before.get(k, 0)
                       for k in ("frames_computed", "frames_valid")}}


@pytest.mark.parametrize("entry", ["convert", "convert_batch"])
def test_spans_nest_as_the_layers(traced, entry):
    spans = traced[entry]
    pairs = nesting(spans)
    want = {(None, f"polgen.{entry}")}
    for holder, held in CHILDREN.items():
        if holder in REQUESTS and holder != f"polgen.{entry}":
            continue
        want |= {(holder, name) for name in held}
    if entry == "convert_batch":
        want.discard(("polgen.prepare", "polgen.f0_file"))
    assert pairs == want
    n_songs = 1 if entry == "convert" else len(traced["songs"])
    for name in ("polgen.prepare", "polgen.finish"):
        assert sum(s[0] == name for s in spans) == n_songs


def test_one_request_id_a_call(traced):
    ids = []
    for entry in ("convert", "convert_batch"):
        for name, _, _, inputs, _ in traced[entry]:
            if name in REQUESTS:
                assert len(inputs) == 1 and isinstance(inputs[0], int)
                ids.append(inputs[0])
            else:
                assert inputs == [], name
    assert len(ids) == 2 and ids[0] != ids[1]


def test_spans_are_function_records_of_no_user_scope(traced):
    assert isinstance(tracing.span("polgen.convert"), _RecordFunctionFast)
    assert isinstance(tracing.span("polgen.convert", 7), _RecordFunctionFast)
    for entry in ("convert", "convert_batch"):
        for name, *_, user in traced[entry]:
            assert user is False, name
            assert not name.startswith("cu")
    for path in PKG.rglob("*.py"):
        assert "record_function" not in path.read_text(), path


def test_frame_counters_equal_the_batch_geometry(vc, traced):
    eng, hub = vc.engine, vc.hubert_cfg
    opts = ConversionOptions(**BENCH_OPTS)
    plans = [vc._prepare_song(song, opts).plan for song in traced["songs"]]
    computed = valid = 0
    for bucket, group in pack_work(plans, eng):
        p_len = min(bucket // eng.window, 2 * hub.num_frames(bucket))
        computed += eng.chunk_batch * p_len
        for si, ci in group:
            c = plans[si].chunks[ci]
            n = c.slice_end - c.slice_start
            valid += min(n // eng.window, 2 * hub.num_frames(n), p_len)
    assert traced["frames"] == {"frames_computed": computed, "frames_valid": valid}
    assert 0 < valid < computed


def test_prewarm_leaves_the_counters_unchanged(vc):
    song = _bench_song(2.0)
    before = tracing.counters()
    _, spans = profiled(lambda: vc.prewarm(song, ConversionOptions(**BENCH_OPTS)))
    assert tracing.counters() == before
    assert spans[0][0] == "polgen.prewarm"
    assert nesting(spans) >= {("polgen.prewarm", "polgen.prepare"),
                              ("polgen.prewarm", "polgen.chunk_batch"),
                              ("polgen.prewarm", "polgen.finish")}


@pytest.mark.parametrize("method,held", [
    ("mangio-crepe", {"polgen.crepe.net", "polgen.crepe.viterbi"}),
    ("fcpe", {"polgen.fcpe"}),
])
def test_other_f0_passes_name_their_parts(method, held):
    """CREPE (full width) over a few frames at a wide hop, and FCPE (its
    mel, net and decode inside its pass): the F0 pass alone, outside the
    polgen.f0 span that _prepare_song opens."""
    vc = build_synthetic_converter(tiny=True, sr=48000, device="cpu",
                                   with_crepe=method == "mangio-crepe",
                                   with_fcpe=method == "fcpe")
    buf = torch.from_numpy(_bench_song(1.0).astype(np.float32))
    opts = ConversionOptions(f0_method=method, hop_length=1600)
    _, spans = profiled(lambda: vc.compute_f0(buf, opts, buf.shape[0]))
    inner = {("polgen.fcpe", f"polgen.fcpe.{part}") for part in ("mel", "net", "decode")}
    assert nesting(spans) == {(None, n) for n in held} | (inner if method == "fcpe" else set())


def test_ui_jobs_span_their_wait_and_run(monkeypatch):
    """The job thread's spans, as opened: torch.profiler records the thread
    it was started on only, so a test's profile cannot see them."""
    from polgen_rvc_tpu_torch.app.ui import server as srv

    opened = []

    def spy(name, request=None):
        opened.append((name, request))
        return tracing.span(name, request)

    monkeypatch.setattr(srv, "span", spy)
    jobs = srv.JobStore()
    job = jobs.start(lambda progress: time.sleep(0.01) or "ok")
    for _ in range(500):
        if jobs.get(job)["status"] == "done":
            break
        time.sleep(0.01)
    assert jobs.get(job)["status"] == "done"
    assert opened == [("polgen.job_wait", None), ("polgen.job", int(job, 16))]


def test_counters_add_and_copy():
    before = tracing.counters()
    tracing.count("launches.viterbi", 3)
    tracing.count("launches.viterbi")
    now = tracing.counters()
    assert now["launches.viterbi"] == before.get("launches.viterbi", 0) + 4
    now["launches.viterbi"] = -1
    assert tracing.counters()["launches.viterbi"] != -1
