"""Spans, counters and the profile exporter: the port's one tracing and
counting system, the counterpart of the JAX package's utils/tracing.py.

Spans. ``with span(name, request=None):`` opens a profiler record of
function scope (torch's ``_RecordFunctionFast``) around a block, and
``@spanned(name)`` around every call of a function. Under torch.profiler
it lands among the host's ops, on the clock of the card's events, so
every idle stretch of the card can be put down to the span the host was
in; it puts nothing on the card's timeline (a user-scope range of
torch.profiler would: such ranges get a mirror there). With no profiler
listening a span costs about a microsecond. Every name is
``polgen.<layer>``; a request's span carries the request's id as the
record's input, which a profile taken with ``record_shapes=True`` shows.
torch.profiler records the thread it was started on.

Counters. A registry of plain integers of the process, read with
``counters()``:

    frames_computed   each chunk batch of a request: chunk_batch x p_len
                      synthesizer frames (pipeline/engine.py)
    frames_valid      the sum of those rows' valid frames
    launches.<kernel> launches of each hand-written kernel (ops/)
    fcpe_frames_computed
                      each FCPE pass: the mel frames its net runs over, the
                      bucket's (pipeline/fcpe_method.py)
    fcpe_frames_valid the frames of signal among them (n_valid)
    kernel_builds     kernel libraries compiled with nvcc (ops/cuda_build.py)
    kernel_loads      kernel libraries loaded with ctypes

The exporter. ``maybe_profile(dir)`` runs a block under torch.profiler
(host ops, and the card's where CUDA is present, with shapes and inputs)
and writes dir/trace.json, a Chrome trace, and dir/counters.json, what
the counters gained inside the block.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
from typing import Optional

from torch._C._profiler import _RecordFunctionFast

_LOCK = threading.Lock()
_COUNTERS: dict = {}
_REQUESTS = itertools.count(1)


def span(name: str, request: Optional[int] = None) -> _RecordFunctionFast:
    """A context manager recording `name` (``polgen.<layer>``) over its
    block; a request's span passes the request's id."""
    if request is None:
        return _RecordFunctionFast(name)
    return _RecordFunctionFast(name, (int(request),))


def spanned(name: str, request: bool = False):
    """A decorator: every call of the function runs inside span(name), with
    a request id new in the process where request is true."""
    def wrap(fn):
        @functools.wraps(fn)
        def in_span(*args, **kwargs):
            with span(name, next(_REQUESTS) if request else None):
                return fn(*args, **kwargs)
        return in_span
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters() -> dict:
    """{name: value} of every counter the process has moved."""
    with _LOCK:
        return dict(_COUNTERS)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """torch.profiler around the block when trace_dir is given; then
    trace_dir/trace.json and trace_dir/counters.json."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    before = counters()
    with profile(activities=activities, record_shapes=True) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    gained = {k: v - before.get(k, 0) for k, v in counters().items()}
    with open(os.path.join(trace_dir, "counters.json"), "w") as f:
        json.dump({k: v for k, v in sorted(gained.items()) if v}, f, indent=1)
