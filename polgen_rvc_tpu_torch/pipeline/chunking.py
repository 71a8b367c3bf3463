"""Long-form chunk planning with quiet-point cuts.

Mirrors the reference's time-domain chunker (pipeline.py:330-344): when the
padded signal exceeds t_max, cut at the quietest sample (minimum sliding
window-sum magnitude) within +-t_query of every t_center multiple, rounded
down to a frame boundary. Each chunk is processed with +-t_pad reflect
context whose output is trimmed (pipeline.py:397).

The engine pads each batch of chunks to its own bucket
(``VoiceConverter._batch_geometry``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .config import EngineConfig


@dataclasses.dataclass
class Chunk:
    start: int        # content start in un-padded 16k samples
    end: int          # content end (exclusive)
    slice_start: int  # slice into the t_pad-padded signal
    slice_end: int


@dataclasses.dataclass
class ChunkPlan:
    chunks: List[Chunk]


def is_cut(n: int, cfg: EngineConfig) -> bool:
    """Whether a signal of n samples is cut (its reflect-padded length
    exceeds t_max): only then do its values decide the plan."""
    return n + 2 * (cfg.window // 2) > cfg.t_max


def find_cut_points(audio: np.ndarray, cfg: EngineConfig) -> list[int]:
    """Quiet-point cut sample indices (frame-aligned), reference semantics."""
    window = cfg.window
    if not is_cut(audio.shape[0], cfg):
        return []
    audio_pad = np.pad(audio, (window // 2, window // 2), mode="reflect")
    # sliding sum of `window` consecutive samples
    csum = np.cumsum(np.concatenate([[0.0], audio_pad]))
    audio_sum = csum[window:] - csum[:-window]  # len == len(audio) + 1
    audio_sum = audio_sum[: audio.shape[0]]
    cuts = []
    for t in range(cfg.t_center, audio.shape[0], cfg.t_center):
        seg = np.abs(audio_sum[t - cfg.t_query : t + cfg.t_query])
        cut = t - cfg.t_query + int(np.argmin(seg))
        cuts.append(cut // window * window)
    return cuts


def plan_chunks(audio: np.ndarray, cfg: EngineConfig) -> ChunkPlan:
    """Split audio into overlapping chunks of the t_pad-padded signal."""
    t_pad, window = cfg.t_pad, cfg.window
    cuts = find_cut_points(audio, cfg)

    chunks = []
    s = 0
    for t in cuts:
        # reference slice: audio_pad[s : t + 2*t_pad + window]
        chunks.append(Chunk(start=s, end=t, slice_start=s,
                            slice_end=t + 2 * t_pad + window))
        s = t
    # final chunk: audio_pad[t:] (reference pipeline.py:416-447)
    chunks.append(Chunk(start=s, end=audio.shape[0], slice_start=s,
                        slice_end=audio.shape[0] + 2 * t_pad))
    return ChunkPlan(chunks=chunks)
