"""What a window's calls asked of the program, counted from their inputs
alone: each song's padded length and buffer, and each chunk's slice, by
the frozen planner of ``reference/signal.py``. The per-layer metrics
count operations and bytes from these valid sizes and the configuration's
published widths, never from the launches, so padding is not work."""

from __future__ import annotations

import dataclasses

from .reference.signal import Engine, highpass_pad_quant, hubert_frames, plan_chunks


@dataclasses.dataclass
class Window:
    """Calls of a window: per call its songs' geometry and its chunk
    batches; the window's wall seconds and input audio seconds."""

    calls: list
    wall_s: float

    @property
    def songs(self) -> list:
        return [s for c in self.calls for s in c["songs"]]

    @property
    def audio_s(self) -> float:
        return sum(s["audio_s"] for s in self.songs)

    @property
    def batches(self) -> int:
        return sum(c["batches"] for c in self.calls)


def song_geometry(audio16k, engine: Engine) -> dict:
    audio, qbuf, _, padded_len = highpass_pad_quant(audio16k, engine.t_pad, engine.window)
    return {"audio_s": len(audio16k) / engine.sample_rate, "padded_len": padded_len,
            "buffer_len": len(qbuf),
            "slices": [c.slice_end - c.slice_start for c in plan_chunks(audio, engine)]}


def call_geometry(songs: list, engine: Engine, packed: bool) -> dict:
    """One call's songs -> {"songs", "batches"}: convert runs each song's
    chunks chunk_batch at a time, convert_batch packs all of them."""
    n = [len(s["slices"]) for s in songs]
    b = engine.chunk_batch
    batches = -(-sum(n) // b) if packed else sum(-(-k // b) for k in n)
    return {"songs": songs, "batches": batches}


def chunk_frames(slice_len: int, config: dict, engine: Engine) -> int:
    """A chunk's valid synthesizer frames (100 per second)."""
    hub = hubert_frames(slice_len, config["hubert"]["conv_layers"])
    return min(slice_len // engine.window, 2 * hub)


def chunks(window: Window):
    """Every chunk slice length of the window."""
    for s in window.songs:
        yield from s["slices"]
