"""The traced window: torch.profiler over whole calls, with ranges the
benchmark opens around the engine's two phases, reduced to what the
per-layer readers need.

``PHASES`` are the ``VoiceConverter`` methods that both entries go
through: ``_prepare_song`` (high-pass, chunk plan, upload, the F0 pass)
and ``_convert_rows`` (one chunk batch). In a traced run each call of
them runs inside a ``record_function`` range of its own name. A kernel
belongs to the range that holds its launch call on the host (the runtime
call with the kernel's correlation id). The reduction reads the profiler's
event list directly, without writing a trace file.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import numpy as np

PHASES = ("_prepare_song", "_convert_rows")
WINDOW_RANGE = "benchmark.traced_window"


@dataclasses.dataclass
class Trace:
    """Device activity of the traced window (nanoseconds, the profiler's
    clock): kernels as (name, start, duration, phase or None), every
    device interval (kernels, copies, sets), the window's span, and the
    host's ops and ranges as (name, start, duration) for naming idle gaps."""

    kernels: list
    device: np.ndarray
    span: tuple
    host: list
    phases: list
    unattributed: int = 0   # kernels whose launch call the trace does not hold

    def busy_ns(self) -> float:
        return float(sum(b - a for a, b in self.busy_intervals()))

    def busy_intervals(self) -> list:
        """The union of device intervals inside the window's span."""
        lo, hi = self.span
        out = []
        for a, b in sorted(map(tuple, self.device)):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def idle_gaps(self) -> list:
        """(start, end) of every stretch of the span with no device activity."""
        lo, hi = self.span
        gaps, cur = [], lo
        for a, b in self.busy_intervals():
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if hi > cur:
            gaps.append((cur, hi))
        return gaps

    def kernel_ns(self, match=None, phase=None) -> float:
        """Summed duration of kernels whose name contains any of `match`
        (all kernels for None) and, given a phase, launched inside it."""
        total = 0.0
        for name, _, dur, ph in self.kernels:
            if phase is not None and ph != phase:
                continue
            if match is not None and not any(m in name for m in match):
                continue
            total += dur
        return total


@contextlib.contextmanager
def phase_ranges(cls):
    """cls's PHASES methods each run inside a record_function range of
    their own name while the context is open."""
    from torch.profiler import record_function

    saved = {name: cls.__dict__[name] for name in PHASES}

    def wrap(name, fn):
        def ranged(self, *args, **kwargs):
            with record_function(name):
                return fn(self, *args, **kwargs)
        return ranged

    for name, fn in saved.items():
        setattr(cls, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(cls, name, fn)


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel,
    cuLaunchKernelEx, cudaMemcpyAsync, ...)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def reduce_events(events) -> Trace:
    """Profiler events (torch's _KinetoEvent list) -> Trace. A kernel's
    launch time is its runtime call's (the same correlation id); its phase
    is the range that holds that time. The ranges' mirrors on the device's
    timeline are left out; a device event named Memcpy or Memset is a copy
    or a set, any other a kernel."""
    host, span, ranges, launch_at, device = [], None, [], {}, []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CPU"):
            start, dur = e.start_ns(), e.duration_ns()
            if _is_launch(name):
                launch_at[e.correlation_id()] = start
            if name == WINDOW_RANGE:
                span = (start, start + dur)
                continue
            if name in PHASES:
                ranges.append((start, start + dur, name))
            host.append((name, start, dur))
        elif name not in PHASES and name != WINDOW_RANGE:
            device.append(e)
    if span is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range")
    ranges.sort()
    starts = [r[0] for r in ranges]
    kernels, intervals, unattributed = [], [], 0
    for e in device:
        start, dur, name = e.start_ns(), e.duration_ns(), e.name()
        intervals.append((start, start + dur))
        if name.startswith(("Memcpy", "Memset")):
            continue
        phase = None
        launched = launch_at.get(e.correlation_id())
        if launched is not None:
            i = bisect.bisect_right(starts, launched) - 1
            if i >= 0 and launched <= ranges[i][1]:
                phase = ranges[i][2]
        unattributed += launched is None
        kernels.append((name, start, dur, phase))
    return Trace(kernels, np.asarray(intervals, np.float64).reshape(-1, 2), span, host,
                 ranges, unattributed)


SHORT_GAP_NS = 20_000


def gap_breakdown(trace: Trace, top: int = 10) -> list:
    """[[what the host was doing, idle seconds], ...]: each idle gap of
    SHORT_GAP_NS or more named by the innermost host op near its midpoint
    that holds it, else by the phase range that holds it; shorter gaps
    (between back-to-back launches) summed under one name."""
    host = sorted(trace.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    phase_starts = [r[0] for r in trace.phases]
    by = {}
    for a, b in trace.idle_gaps():
        if b - a < SHORT_GAP_NS:
            label = "gaps under 20 us"
        else:
            mid = 0.5 * (a + b)
            label = None
            i = bisect.bisect_right(starts, mid)
            # the innermost holder starts latest among those that hold mid
            for name, s, d in reversed(host[max(0, i - 64):i]):
                if s <= mid <= s + d:
                    label = name
                    break
            if label is None:
                j = bisect.bisect_right(phase_starts, mid) - 1
                inside = j >= 0 and mid <= trace.phases[j][1]
                label = trace.phases[j][2] if inside else "python (no op)"
        by[label] = by.get(label, 0.0) + (b - a) * 1e-9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def kernel_breakdown(trace: Trace, top: int = 10) -> list:
    """[[kernel name, device seconds], ...], most time first."""
    by = {}
    for name, _, dur, _ in trace.kernels:
        by[name] = by.get(name, 0.0) + dur * 1e-9
    return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
