"""The card's idle gaps put down to the program's spans, on a hand-made
event list: the five groups split the window's idle time exactly, short
gaps included, and a gap after the many ops of a long span still takes
that span."""

import sys
import types

import pytest

from benchmark import spans, spec
from benchmark import trace as tr
from benchmark.tests.test_bench_trace import Ev

# host spans (us): two requests, the first with every phase
SPANS = [
    ("polgen.convert", 100, 1400),
    ("polgen.prepare", 110, 490),
    ("polgen.highpass", 110, 40),
    ("polgen.f0", 200, 350),
    ("polgen.chunk_batch", 700, 500),
    ("polgen.decoder", 800, 300),
    ("polgen.finish", 1300, 150),
    ("polgen.readback", 1300, 140),
    ("polgen.convert", 1600, 300),
]
# 100 host ops inside polgen.f0, more than gap_breakdown's look-back of 64
OPS = [("aten::gru_cell", 200 + 3 * k, 1) for k in range(100)]
BUSY = [(0, 90), (130, 190), (192, 300), (500, 510), (545, 650), (655, 700),
        (705, 1250), (1252, 1350), (1440, 1520), (1580, 1620), (1625, 1950)]
# each gap (us) -> its group
EXPECTED = {
    "song_prep": 40 + 2,        # 90-130 in highpass; 190-192 in prepare
    "f0": 200 + 35,             # 300-500 among the ops; 510-545 after them
    "chunk_batch": 5,           # 700-705
    "finish": 5 + 2 + 90 + 5,   # 650-655, 1250-1252: in a request between its
                                # phases; 1350-1440 in readback; 1620-1625
    "between_calls": 60 + 50,   # 1520-1580 between requests; 1950-2000
}


def events(with_spans=True):
    out = [Ev(tr.WINDOW_RANGE, "CPU", 0, 2000)]
    out += [Ev(name, "CPU", s, d) for name, s, d in (SPANS if with_spans else []) + OPS]
    out += [Ev(f"kernel{k}", "CUDA", a, b - a, corr=k + 1) for k, (a, b) in enumerate(BUSY)]
    return out


@pytest.fixture
def trace():
    return tr.reduce_events(events())


def test_groups_split_the_idle_time_exactly(trace):
    got = spans.idle_ns_by_group(trace)
    assert got == {g: EXPECTED[g] * 1000.0 for g in spans.GROUPS}
    idle = (trace.span[1] - trace.span[0]) - trace.busy_ns()
    assert sum(got.values()) == idle
    assert any(b - a < tr.SHORT_GAP_NS for a, b in trace.idle_gaps())


def test_a_long_span_holds_the_gap_after_its_ops(trace):
    """510-545 us lies in polgen.f0 after its 100 ops: the nesting finds the
    span that gap_breakdown's 64-event look-back does not."""
    assert dict(tr.gap_breakdown(trace)).get("polgen.f0", 0.0) < 235e-6
    assert spans.idle_ns_by_group(trace)["f0"] == 235_000


def test_no_program_span_reads_nothing():
    bare = tr.reduce_events(events(with_spans=False))
    assert spans.idle_ns_by_group(bare) is None
    ctx = types.SimpleNamespace(trace=bare, traced=types.SimpleNamespace(audio_s=60.0))
    for group in spans.GROUPS:
        name = f"idle_{group}_ms_per_audio_min"
        assert spec.load_metric(name).read(ctx) is None


def test_readers_give_ms_per_audio_minute(trace):
    ctx = types.SimpleNamespace(trace=trace, traced=types.SimpleNamespace(audio_s=30.0))
    for group in spans.GROUPS:
        got = spec.load_metric(f"idle_{group}_ms_per_audio_min").read(ctx)
        assert got == pytest.approx(EXPECTED[group] * 1e-3 * 2)


def test_padding_share_reads_the_port_counters(monkeypatch):
    from polgen_rvc_tpu_torch.utils import tracing

    reader = spec.load_metric("padding_share")
    monkeypatch.setattr(tracing, "counters",
                        lambda: {"frames_computed": 4000, "frames_valid": 1000})
    assert reader.read(None) == pytest.approx(75.0)
    monkeypatch.setattr(tracing, "counters", lambda: {})
    assert reader.read(None) is None
    # a port without the tracing module: nothing to read, nothing raised
    monkeypatch.setitem(sys.modules, "polgen_rvc_tpu_torch.utils.tracing", None)
    assert reader.read(None) is None
