"""Mixdown pipeline, the port of the JAX package's app/audio_processing.py:
effects chain + vocal/instrumental overlay.

The seven-effect chain of the upstream processing tab, streamed in
1-second chunks with state carried across chunks (reset=False semantics),
then gain + overlay + export. The DSP engine is the port's copy of the
JAX package's C++ (native/dsp.cpp, built with g++ at first use), so the
chain gives the JAX package's bits; gain and overlay are numpy. Host
only: nothing here touches a device. A mismatched instrumental is
resampled with the port's ops/resample.py, which gives ceil(T * up /
down) samples at any length (the JAX function raises unless T is a
multiple of down).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.audio_io import read_audio, save_stereo_wav, to_stereo, write_audio
from ..utils.progress import NULL_PROGRESS, ProgressReporter

OUTPUT_DIR = "output"  # relative to the working directory, as app/voice_conversion.py

# reference UI defaults: the slider value= settings at
# tabs/processing/processing.py:151-349 (= its all_default_values list)
EFFECT_DEFAULTS = dict(
    reverb_rm_size=0.1,
    reverb_wet=0.1,
    reverb_dry=0.8,
    reverb_damping=0.9,
    reverb_width=1.0,
    low_shelf_gain=0.0,
    high_shelf_gain=0.0,
    compressor_ratio=4.0,
    compressor_threshold=-12.0,
    noise_gate_threshold=-40.0,
    noise_gate_ratio=8.0,
    noise_gate_attack=10.0,
    noise_gate_release=100.0,
    chorus_rate_hz=0.0,
    chorus_depth=0.0,
    chorus_centre_delay_ms=0.0,
    chorus_feedback=0.0,
    chorus_mix=0.0,
)


class EffectChain:
    """Streaming stereo effect chain backed by the native DSP library."""

    def __init__(self, sample_rate: int, **params):
        from ..native import dsp_library

        p = dict(EFFECT_DEFAULTS)
        p.update(params)
        self._lib = dsp_library()
        self._handle = self._lib.polgen_chain_create(
            float(sample_rate),
            p["reverb_rm_size"], p["reverb_wet"], p["reverb_dry"],
            p["reverb_damping"], p["reverb_width"],
            p["low_shelf_gain"], p["high_shelf_gain"],
            p["compressor_ratio"], p["compressor_threshold"],
            p["noise_gate_threshold"], p["noise_gate_ratio"],
            p["noise_gate_attack"], p["noise_gate_release"],
            p["chorus_rate_hz"], p["chorus_depth"],
            p["chorus_centre_delay_ms"], p["chorus_feedback"], p["chorus_mix"],
        )

    def process(self, block: np.ndarray) -> np.ndarray:
        """In-state streaming: (T, 2) float32 -> (T, 2). Call repeatedly."""
        block = np.ascontiguousarray(block, np.float32)
        left = np.ascontiguousarray(block[:, 0])
        right = np.ascontiguousarray(block[:, 1])
        self._lib.polgen_chain_process(
            self._handle,
            left.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            right.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(left),
        )
        return np.stack([left, right], axis=1)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.polgen_chain_destroy(self._handle)
            self._handle = None


def add_effects(vocal_path: str, output_path: str, **effect_params) -> str:
    """Stream the chain over a file in 1-second chunks
    (audio_processing.py:105-109 semantics)."""
    audio, sr = read_audio(vocal_path)
    audio = to_stereo(audio)
    chain = EffectChain(sr, **effect_params)
    out = np.empty_like(audio)
    for start in range(0, len(audio), sr):
        out[start : start + sr] = chain.process(audio[start : start + sr])
    write_audio(output_path, out, sr)
    return output_path


def combine_audio(
    vocal_path: str,
    instrumental_path: str,
    output_path: str,
    vocal_gain: float = 0.0,
    instrumental_gain: float = 0.0,
    output_format: str = "mp3",
) -> str:
    """Gain (dB) + overlay + export (audio_processing.py:29-40)."""
    voc, sr_v = read_audio(vocal_path)
    ins, sr_i = read_audio(instrumental_path)
    voc = to_stereo(voc) * (10.0 ** (vocal_gain / 20.0))
    ins = to_stereo(ins) * (10.0 ** (instrumental_gain / 20.0))
    if sr_i != sr_v:
        from ..ops.resample import resample

        ins = resample(ins.T.astype(np.float32), sr_i, sr_v).numpy().T
    # pydub overlay: shorter track overlaid onto longer base? reference
    # overlays instrumental onto vocal -> result length = vocal length
    n = len(voc)
    mixed = voc.copy()
    mixed[: min(n, len(ins))] += ins[: min(n, len(ins))]
    write_audio(output_path, np.clip(mixed, -1.0, 1.0), sr_v)
    return output_path


def process_audio(
    vocal_audio_path: str,
    instrumental_audio_path: str,
    output_format: str = "mp3",
    vocal_gain: float = 0.0,
    instrumental_gain: float = 0.0,
    use_effects: bool = True,
    output_dir: str | None = None,
    progress: ProgressReporter = NULL_PROGRESS,
    **effect_params,
) -> str:
    """Full mixdown pipeline (audio_processing.py:113-200)."""
    if not vocal_audio_path:
        raise ValueError("vocal audio file not found; check the path")
    if not instrumental_audio_path:
        raise ValueError("instrumental audio file not found; check the path")
    out_dir = output_dir or OUTPUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    voice_stereo_path = os.path.join(out_dir, "Voice_Stereo.wav")
    aicover_path = os.path.join(out_dir, f"AiCover.{output_format}")
    if os.path.exists(aicover_path):
        os.remove(aicover_path)

    progress(0.2, "converting to stereo")
    save_stereo_wav(vocal_audio_path, voice_stereo_path)

    if use_effects:
        progress(0.4, "applying effects")
        vocal_output_path = os.path.join(out_dir, "Vocal_Effected.wav")
        add_effects(voice_stereo_path, vocal_output_path, **effect_params)
    else:
        vocal_output_path = voice_stereo_path

    progress(0.8, "combining vocal + instrumental")
    combine_audio(
        vocal_output_path, instrumental_audio_path, aicover_path,
        vocal_gain, instrumental_gain, output_format,
    )
    return aicover_path
