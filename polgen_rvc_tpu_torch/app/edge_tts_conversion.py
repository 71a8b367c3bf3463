"""Edge-TTS voice-over pipeline, the port of the JAX package's
app/edge_tts_conversion.py: text -> speech -> voice conversion.

Synthesize with a Microsoft Edge neural voice (an mp3), convert it to a
stereo WAV, then the port's voice_pipeline; returns (converted path, TTS
stereo path). The conversion runs on CUDA unless the caller passes
device="cpu", or on the converter passed in."""

from __future__ import annotations

import os
from typing import Optional

from ..utils.audio_io import save_stereo_wav
from .. import resolve_device
from ..pipeline.engine import VoiceConverter
from ..utils.progress import NULL_PROGRESS, ProgressReporter
from .voice_conversion import OUTPUT_DIR, RVC_MODELS_DIR, voice_pipeline


def text_to_speech(text: str, voice: str, output_path: str) -> str:
    from .edge_tts_client import synthesize

    return synthesize(text, voice, output_path)


def edge_tts_pipeline(
    text: str,
    voice_model: str,
    voice: str,
    pitch: float,
    index_rate: float = 0.5,
    filter_radius: int = 3,
    volume_envelope: float = 0.25,
    f0_method: str = "rmvpe+",
    hop_length: int = 128,
    protect: float = 0.33,
    output_format: str = "mp3",
    f0_min: float = 50,
    f0_max: float = 1100,
    *,
    output_dir: Optional[str] = None,
    models_dir: str = RVC_MODELS_DIR,
    progress: ProgressReporter = NULL_PROGRESS,
    converter: Optional[VoiceConverter] = None,
    device=None,
) -> tuple[str, str]:
    """The upstream edge_tts_pipeline: output/TTS_Voice.mp3, its stereo
    WAV, then output/TTS_Voice_Converted.<fmt> (the WAV fallback's
    extension where no codec encodes <fmt>)."""
    if not text:
        raise ValueError("enter the text to synthesize")
    if not voice:
        raise ValueError("select a language and voice for speech synthesis")
    if not voice_model:
        raise ValueError("select a voice model for conversion")
    if converter is None:
        device = resolve_device(device)  # no speech request without a card

    out_dir = output_dir or OUTPUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    tts_path = os.path.join(out_dir, "TTS_Voice.mp3")
    tts_stereo_path = os.path.join(out_dir, "TTS_Voice_Stereo.wav")
    convert_path = os.path.join(out_dir, f"TTS_Voice_Converted.{output_format}")
    if os.path.exists(convert_path):
        os.remove(convert_path)

    progress(0.2, "synthesizing speech (Edge TTS)")
    text_to_speech(text, voice, tts_path)

    progress(0.4, "converting to stereo")
    save_stereo_wav(tts_path, tts_stereo_path)

    progress(0.6, "converting voice")
    converted = voice_pipeline(
        tts_stereo_path,
        voice_model,
        pitch,
        index_rate=index_rate,
        filter_radius=filter_radius,
        volume_envelope=volume_envelope,
        f0_method=f0_method,
        hop_length=hop_length,
        protect=protect,
        output_format=output_format,
        f0_min=f0_min,
        f0_max=f0_max,
        output_dir=out_dir,
        models_dir=models_dir,
        progress=NULL_PROGRESS,
        converter=converter,
        device=device,
    )
    # rename to the TTS artifact name (reference writes TTS_Voice_Converted)
    if os.path.abspath(converted) != os.path.abspath(convert_path):
        target = (
            convert_path
            if converted.endswith(output_format)
            else os.path.splitext(convert_path)[0] + os.path.splitext(converted)[1]
        )
        os.replace(converted, target)
        convert_path = target
    progress(1.0, "done")
    return convert_path, tts_stereo_path
