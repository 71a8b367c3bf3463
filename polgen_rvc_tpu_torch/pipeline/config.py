"""Typed configuration for the conversion engine.

One dataclass covers every pipeline knob the reference scatters across
argparse defaults (rvc_cli.py:14-22), module constants (pipeline.py:14-22)
and the Config tier table (infer.py:41-46).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ConversionOptions:
    """Per-request knobs; defaults match the reference CLI (rvc_cli.py:14-22)."""

    pitch: float = 0.0            # semitones, -24..24
    f0_method: str = "rmvpe+"     # rmvpe+ | fcpe | mangio-crepe
    index_rate: float = 0.0       # 0..1 retrieval blend
    # filter_radius is accepted for surface parity but NOT applied — same as
    # the reference, whose engine receives it into ignored **kwargs
    # (pipeline.py:139,163); no median filter ever runs on the F0 there.
    filter_radius: int = 3
    volume_envelope: float = 0.25  # rms_mix_rate: 0=follow source, 1=keep output
    protect: float = 0.33         # <0.5 enables voiceless-consonant protection
    hop_length: int = 128         # crepe hop
    f0_min: float = 50.0
    f0_max: float = 1100.0
    output_format: str = "mp3"    # wav | flac | mp3
    resample_sr: int = 0          # 0 = keep model rate
    f0_file: Optional[str] = None  # optional "time,hz" override file
    speaker_id: int = 0
    seed: int = 0                 # PRNG seed for the stochastic latent/noise


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level (compile-relevant) settings.

    The (x_pad, x_query, x_center, x_max) tier mirrors the reference chunking
    semantics (infer.py:41-46). All shapes downstream of these derive from it.
    """

    x_pad: int = 1        # seconds of reflect context per chunk side
    x_query: int = 6      # seconds searched around each cut center
    x_center: int = 30    # seconds between cut centers
    x_max: int = 32       # max un-chunked length, seconds
    sample_rate: int = 16000
    window: int = 160     # samples per frame @16k (100 fps)
    chunk_batch: int = 2  # chunks processed per device step
    bucket_step_s: int = 4   # chunk-length buckets: multiples of this
    compute_dtype: str = "float32"  # "bfloat16" on the GPU for speed
    retrieval_k: int = 8
    noise_scale: float = 0.66666

    @property
    def t_pad(self) -> int:
        return self.sample_rate * self.x_pad

    @property
    def t_query(self) -> int:
        return self.sample_rate * self.x_query

    @property
    def t_center(self) -> int:
        return self.sample_rate * self.x_center

    @property
    def t_max(self) -> int:
        return self.sample_rate * self.x_max

    @property
    def max_chunk_samples(self) -> int:
        """Upper bound on a chunk slice: content (<= t_center + 2*t_query)
        plus both pads and one window."""
        return (
            self.t_center + 2 * self.t_query + 2 * self.t_pad + self.window
        )

    @property
    def max_bucket_len(self) -> int:
        """Largest bucket ANY chunk of ANY song can require under this
        config: the wider of the no-cut whole-signal case (audio fits
        t_max) and the widest interior chunk, rounded up to the bucket
        grid. Static per config — the fixed noise-draw shape that makes
        rendering bucket-invariant derives from it (models draw noise at
        this length and slice, so a chunk renders bit-identically whatever
        bucket its batch compiles at)."""
        longest = max(self.t_max - self.window + 2 * self.t_pad,
                      self.max_chunk_samples)
        step = self.bucket_step_s * self.sample_rate
        return -(-longest // step) * step
