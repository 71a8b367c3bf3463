"""Host signal path of a conversion, frozen from the port's plain semantics:
the engine's geometry, the 48 Hz high-pass with reflect pad and int16
quantization, the quiet-point chunk planner, and the output tail (RMS
envelope, per-chunk int16 pack, final normalize). NumPy and SciPy on the
host; the RMS envelope in float64 on whatever device holds the audio."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy import signal as sps

F0_FRAME_BUCKET = 1024  # the quantized buffer holds a multiple of this many frames


@dataclasses.dataclass(frozen=True)
class Engine:
    """The chunking tier and batch settings of a configuration's engine."""

    x_pad: int = 1
    x_query: int = 6
    x_center: int = 30
    x_max: int = 32
    chunk_batch: int = 2
    bucket_step_s: int = 4
    compute_dtype: str = "bfloat16"
    retrieval_k: int = 8
    noise_scale: float = 0.66666
    sample_rate: int = 16000
    window: int = 160

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
    def max_bucket_len(self) -> int:
        longest = max(self.t_max - self.window + 2 * self.t_pad,
                      self.t_center + 2 * self.t_query + 2 * self.t_pad + self.window)
        step = self.bucket_step_s * self.sample_rate
        return -(-longest // step) * step


def hubert_frames(samples: int, conv_layers) -> int:
    t = samples
    for _, k, s in conv_layers:
        t = (t - k) // s + 1
    return t


def noise_frames(engine: Engine, conv_layers) -> int:
    """The fixed frame count every chunk's noise is drawn at."""
    mb = engine.max_bucket_len
    return min(mb // engine.window, 2 * hubert_frames(mb, conv_layers))


def highpass_pad_quant(audio16k: np.ndarray, t_pad: int, window: int = 160):
    """5th-order 48 Hz Butterworth filtfilt in float64 -> float32 -> reflect
    pad by t_pad -> int16 against the padded signal's own max, in a
    zero-tailed buffer of a multiple of F0_FRAME_BUCKET frames.
    Returns (filtered (n,), int16 buffer, inv_scale, padded length)."""
    b, a = sps.butter(N=5, Wn=48.0, btype="high", fs=16000.0)
    audio = sps.filtfilt(b, a, np.asarray(audio16k, np.float64)).astype(np.float32)
    padded = np.pad(audio, (t_pad, t_pad), mode="reflect").astype(np.float32)
    t = padded.shape[0]
    step = F0_FRAME_BUCKET * window
    size = max(int(np.ceil(t / step)), 1) * step
    amax = float(np.max(np.abs(padded))) if t else 0.0
    scale = 32767.0 / amax if amax > 0 else 1.0
    buf = np.zeros(size, np.int16)
    buf[:t] = np.round(padded * scale)
    return audio, buf, np.float32(1.0 / scale), t


@dataclasses.dataclass
class Chunk:
    start: int
    end: int
    slice_start: int
    slice_end: int


def plan_chunks(audio: np.ndarray, engine: Engine) -> list:
    """Cuts at the quietest window sum within +-t_query of every t_center
    multiple, frame-aligned; each chunk with t_pad of context a side."""
    window, t_pad = engine.window, engine.t_pad
    cuts = []
    audio_pad = np.pad(audio, (window // 2, window // 2), mode="reflect")
    if audio_pad.shape[0] > engine.t_max:
        csum = np.cumsum(np.concatenate([[0.0], audio_pad]))
        audio_sum = (csum[window:] - csum[:-window])[: audio.shape[0]]
        for t in range(engine.t_center, audio.shape[0], engine.t_center):
            seg = np.abs(audio_sum[t - engine.t_query: t + engine.t_query])
            cut = t - engine.t_query + int(np.argmin(seg))
            cuts.append(cut // window * window)
    chunks, s = [], 0
    for t in cuts:
        chunks.append(Chunk(s, t, s, t + 2 * t_pad + window))
        s = t
    chunks.append(Chunk(s, audio.shape[0], s, audio.shape[0] + 2 * t_pad))
    return chunks


def bucket_class(chunk: Chunk, engine: Engine) -> int:
    step = engine.bucket_step_s * engine.sample_rate
    return -(-(chunk.slice_end - chunk.slice_start) // step) * step


def _interp_linear(x, size: int):
    n = x.shape[-1]
    if n == 1:
        return x.expand(size).clone()
    pos = ((torch.arange(size, dtype=torch.float64, device=x.device) + 0.5)
           * (n / size) - 0.5).clamp(0.0, n - 1)
    lo = pos.floor().long().clamp(0, n - 1)
    hi = (lo + 1).clamp(max=n - 1)
    frac = pos - lo.to(torch.float64)
    return x[lo] * (1 - frac) + x[hi] * frac


def _rms(y, frame_length: int, hop_length: int):
    y = y.to(torch.float64)
    half = frame_length // 2
    c = torch.cat([y.new_zeros(1),
                   torch.cumsum(torch.nn.functional.pad(y, (half, half)) ** 2, 0)])
    lo = torch.arange(1 + y.shape[0] // hop_length, device=y.device) * hop_length
    return torch.sqrt(torch.clamp(c[lo + frame_length] - c[lo], min=0.0) / frame_length)


def change_rms(source, src_sr: int, target, tgt_sr: int, rate: float):
    """Scale target towards the source's loudness envelope by (1 - rate)."""
    rms1 = _interp_linear(_rms(source, src_sr // 2 * 2, src_sr // 2), target.shape[0])
    rms2 = torch.clamp(_interp_linear(_rms(target, tgt_sr // 2 * 2, tgt_sr // 2),
                                      target.shape[0]), min=1e-6)
    gain = rms1 ** (1 - rate) * rms2 ** (rate - 1)
    return (target.to(torch.float64) * gain).to(target.dtype)


def pack_and_finalize(segments: list) -> np.ndarray:
    """Chunk outputs -> int16: each chunk quantized against its own peak,
    read back, then scaled to int16, peak-normalized to 0.99 only where it
    would clip."""
    parts = []
    for seg in segments:
        absmax = torch.amax(seg.abs()) if seg.numel() else seg.new_zeros(())
        q = torch.round(seg * (32767.0 / torch.clamp(absmax, min=1e-9))).to(torch.int16)
        parts.append(q.cpu().numpy().astype(np.float32) * (float(absmax) / 32767.0))
    audio = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    audio_max = np.abs(audio).max() / 0.99 if audio.size else 0.0
    max_int16 = 32768.0
    if audio_max > 1:
        max_int16 /= audio_max
    return (audio * max_int16).astype(np.int16)

