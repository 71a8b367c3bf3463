"""The inputs of a run, made from its seed: sung vocal stems and spoken
clips at 16 kHz, float32, as a user's audio reaches ``convert``.

A song (the model is ``chip_smoke.py:bench_song``, a vibrato sine, grown
into a vocal stem): notes of a scale with pitch glides between them and
5-6 Hz vibrato, a few harmonics, phrases with short breaths of
near-silence between them, and a noise floor. Ahead of every 30 s mark
there is a rest of digital silence (an instrumental break in the stem);
the high-pass leaves exact zeros in its middle, so the chunk planner cuts
there whatever the seed, and every seed's songs split into the same
chunks and buckets: the same work in another order. The rests sit 29.4 s
apart, so a chunk's slice (31.4 s) stays clear of the 32 s bucket edge.

A clip: speech-like voiced stretches (a falling 90-240 Hz contour with
harmonics), unvoiced stretches (white noise) and short pauses.

Each call perturbs its item's base signal by the item's noise floor at a
gain that differs from call to call (zero in the rests), so no two calls
of a window send the same samples.
"""

from __future__ import annotations

import numpy as np

SR = 16000
REST_SPACING_S = 29.4   # rest k starts at k * REST_SPACING_S - REST_LEAD_S
REST_LEAD_S = 1.2
REST_S = 2.6
NOISE_FLOOR = 0.003


def _song(seconds: float, rng: np.random.Generator):
    """(signal, noise floor) of one sung stem."""
    n = int(round(seconds * SR))
    f0 = np.zeros(n)
    amp = np.zeros(n)
    scale = 2.0 ** (np.array([0, 2, 4, 5, 7, 9, 11, 12, 14]) / 12.0)
    base = rng.uniform(150.0, 330.0)
    pos = 0
    note = rng.integers(len(scale))
    while pos < n:
        # a phrase of notes, then a breath
        phrase = int(rng.uniform(2.0, 6.0) * SR)
        end = min(pos + phrase, n)
        t0 = pos
        prev = base * scale[note]
        while t0 < end:
            dur = int(rng.uniform(0.25, 0.8) * SR)
            note = int(np.clip(note + rng.integers(-2, 3), 0, len(scale) - 1))
            target = base * scale[note]
            seg = np.arange(min(dur, end - t0))
            glide = np.minimum(seg / (0.06 * SR), 1.0)
            vib = 1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(5.0, 6.0) * seg / SR) \
                * np.minimum(seg / (0.15 * SR), 1.0)
            f0[t0:t0 + seg.size] = (prev + (target - prev) * glide) * vib
            prev = target
            t0 += seg.size
        env = np.ones(end - pos)
        ramp = min(int(0.05 * SR), env.size // 2)
        if ramp:
            env[:ramp] = np.linspace(0.0, 1.0, ramp)
            env[-ramp:] = np.linspace(1.0, 0.0, ramp)
        amp[pos:end] = env * rng.uniform(0.25, 0.5)
        pos = end + int(rng.uniform(0.15, 0.4) * SR)   # the breath: amp 0
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voice = sum(np.sin(h * phase) / h ** 1.5 for h in range(1, 5)) * amp
    floor = rng.standard_normal(n)
    rest = np.zeros(n, bool)
    k = 1
    while k * REST_SPACING_S - REST_LEAD_S < seconds:
        lo = int((k * REST_SPACING_S - REST_LEAD_S) * SR)
        rest[lo:lo + int(REST_S * SR)] = True
        k += 1
    voice[rest] = 0.0
    floor[rest] = 0.0
    return voice, floor


def _clip(seconds: float, rng: np.random.Generator):
    """(signal, noise floor) of one spoken clip."""
    n = int(round(seconds * SR))
    out = np.zeros(n)
    pos = int(0.1 * SR)
    contour = rng.uniform(160.0, 240.0)
    while pos < n:
        kind = rng.choice(["voiced", "voiced", "unvoiced", "pause"])
        dur = min(int(rng.uniform(0.08, 0.3) * SR), n - pos)
        seg = np.arange(dur)
        env = np.sin(np.pi * (seg + 0.5) / dur)
        if kind == "voiced":
            f0 = np.maximum(contour * (1.0 - 0.3 * seg / max(dur, 1)), 90.0)
            phase = 2 * np.pi * np.cumsum(f0) / SR
            out[pos:pos + dur] = 0.4 * env * sum(np.sin(h * phase) / h for h in range(1, 6))
            contour = max(contour * rng.uniform(0.85, 1.05), 95.0)
        elif kind == "unvoiced":
            out[pos:pos + dur] = 0.15 * env * rng.standard_normal(dur)
        pos += dur
    return out, rng.standard_normal(n)


SIGNALS = {"song": _song, "speech": _clip}


class Inputs:
    """A traffic mix's items, made from the seed: one base signal per
    entry of its length cycle, and the calls that perturb them."""

    def __init__(self, traffic: dict, seed: int):
        rng = np.random.default_rng([int(seed), 1])
        make = SIGNALS[traffic["signal"]]
        self.lengths = [float(s) for s in traffic["lengths_s"]]
        self.items = [make(s, rng) for s in self.lengths]
        self.per_call = int(traffic.get("items_per_call", 1))
        self.order_rng = np.random.default_rng([int(seed), 2])

    def cycle(self) -> list:
        """One cycle: each item once, in an order shuffled by the seed,
        grouped into calls of items_per_call items."""
        order = self.order_rng.permutation(len(self.items))
        return [list(order[g:g + self.per_call]) for g in range(0, len(order), self.per_call)]

    def signal(self, item: int, rep: int) -> np.ndarray:
        """Item `item` as its rep-th call sends it: the base signal plus its
        noise floor at a gain below NOISE_FLOOR that differs from rep to rep."""
        voice, floor = self.items[item]
        gain = NOISE_FLOOR * (0.5 + 0.5 * ((rep * 0.6180339887) % 1.0))
        return (voice + gain * floor).astype(np.float32)
