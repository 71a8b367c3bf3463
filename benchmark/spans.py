"""The card's idle time put down to the program's spans.

The port opens ``polgen.<layer>`` spans around its layers
(polgen_rvc_tpu_torch/utils/tracing.py): profiler records on the host,
on the clock of the card's events, so in a traced window they are among
``Trace.host``. Each idle gap of the card, short or long, takes the
innermost span that holds its midpoint (the rule of
``trace.gap_breakdown``, with the spans nested by their intervals rather
than looked for among the last host events), and that span's chain of
enclosing spans puts the gap into one of five groups, which split the
window's idle time with no overlap:

    f0             under polgen.f0 or polgen.f0_file
    song_prep      under polgen.prepare, not under the F0 spans
    chunk_batch    under polgen.chunk_batch
    finish         under polgen.finish, or inside a request span
                   (polgen.convert, polgen.convert_batch) and none of
                   the above
    between_calls  outside every request span: the caller's time (in the
                   benchmark, the client making the next input)
"""

from __future__ import annotations

PREFIX = "polgen."
GROUPS = ("f0", "song_prep", "chunk_batch", "finish", "between_calls")
# a gap's group is the first whose spans its chain holds
_HOLDERS = (
    ("f0", {"polgen.f0", "polgen.f0_file"}),
    ("song_prep", {"polgen.prepare"}),
    ("chunk_batch", {"polgen.chunk_batch"}),
    ("finish", {"polgen.finish", "polgen.convert", "polgen.convert_batch"}),
)


def _group(chain) -> str:
    for group, names in _HOLDERS:
        if chain & names:
            return group
    return "between_calls"


def idle_ns_by_group(trace) -> dict | None:
    """{group: idle nanoseconds} over the trace's idle gaps, or None where
    the trace holds no program span (a port without them)."""
    spans = sorted(((s, s + d, name) for name, s, d in trace.host
                    if name.startswith(PREFIX)), key=lambda sp: (sp[0], -sp[1]))
    if not spans:
        return None
    out = dict.fromkeys(GROUPS, 0.0)
    stack = []   # (end, names of the span and its holders), innermost last
    i = 0
    for a, b in sorted(trace.idle_gaps(), key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while i < len(spans) and spans[i][0] <= mid:
            start, end, name = spans[i]
            while stack and stack[-1][0] <= start:
                stack.pop()
            stack.append((end, (stack[-1][1] if stack else frozenset()) | {name}))
            i += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        out[_group(stack[-1][1] if stack else frozenset())] += b - a
    return out


def idle_ms_per_audio_min(ctx, group: str) -> float | None:
    """One group's idle milliseconds per minute of the traced window's
    input audio."""
    by = idle_ns_by_group(ctx.trace)
    if by is None or ctx.traced.audio_s <= 0:
        return None
    return by[group] * 1e-6 / (ctx.traced.audio_s / 60.0)
