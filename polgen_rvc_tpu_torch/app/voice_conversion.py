"""File-level voice conversion pipeline and model registry: the port of
the JAX package's app/voice_conversion.py.

Model-dir discovery (models/<name>/*.pth + *.index), stereo conversion,
file-to-file conversion and the output/ layout. Converted weights stay on
the device, cached per model. Paths are relative to the working directory,
as the JAX package's are: models/, assets/embedders/hubert_base.pt,
assets/predictors/{rmvpe.pt,crepe_full.pth,fcpe.pt} and output/.
Conversion runs on CUDA unless the caller passes device="cpu"."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .. import resolve_device
from ..pipeline.config import ConversionOptions, EngineConfig
from ..pipeline.engine import VoiceConverter
from ..pipeline.factory import build_converter
from ..utils.audio_io import CodecUnavailable, load_audio, save_stereo_wav, write_audio
from ..utils.progress import NULL_PROGRESS, ProgressReporter

RVC_MODELS_DIR = "models"
EMBEDDERS_DIR = os.path.join("assets", "embedders")
PREDICTORS_DIR = os.path.join("assets", "predictors")
OUTPUT_DIR = "output"

HUBERT_MODEL_PATH = os.path.join(EMBEDDERS_DIR, "hubert_base.pt")
RMVPE_MODEL_PATH = os.path.join(PREDICTORS_DIR, "rmvpe.pt")
FCPE_MODEL_PATH = os.path.join(PREDICTORS_DIR, "fcpe.pt")
CREPE_MODEL_PATH = os.path.join(PREDICTORS_DIR, "crepe_full.pth")

_CONVERTER_CACHE: dict = {}


def find_rvc_model(voice_model: str, models_dir: str = RVC_MODELS_DIR):
    """models/<name>/ -> (.pth path, optional .index path)."""
    model_dir = os.path.join(models_dir, voice_model)
    if not os.path.isdir(model_dir):
        raise ValueError(
            f"Model {voice_model} does not exist; check the name."
        )
    files = os.listdir(model_dir)
    pth = next((os.path.join(model_dir, f) for f in files if f.endswith(".pth")), None)
    index = next(
        (os.path.join(model_dir, f) for f in files if f.endswith(".index")), None
    )
    if not pth:
        raise ValueError(
            f"Model {voice_model} does not exist; check the name."
        )
    return pth, index


def get_converter(
    voice_model: str,
    *,
    models_dir: str = RVC_MODELS_DIR,
    hubert_path: str = HUBERT_MODEL_PATH,
    rmvpe_path: str = RMVPE_MODEL_PATH,
    engine: Optional[EngineConfig] = None,
    use_index: bool = True,
    device=None,
) -> VoiceConverter:
    """Load (or fetch the cached) converter for a named voice model, on
    `device` (default CUDA; raises without it unless device="cpu")."""
    device = resolve_device(device)
    key = (voice_model, os.path.abspath(models_dir), use_index, str(device))
    if key in _CONVERTER_CACHE:
        return _CONVERTER_CACHE[key]
    pth, index = find_rvc_model(voice_model, models_dir)
    vc = build_converter(
        pth,
        hubert_path,
        rmvpe_path if os.path.exists(rmvpe_path) else None,
        index if use_index else None,
        crepe_path=CREPE_MODEL_PATH if os.path.exists(CREPE_MODEL_PATH) else None,
        fcpe_path=FCPE_MODEL_PATH if os.path.exists(FCPE_MODEL_PATH) else None,
        engine=engine or EngineConfig(),
        device=device,
    )
    _CONVERTER_CACHE[key] = vc
    return vc


def voice_pipeline(
    uploaded_file: str,
    voice_model: str,
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
) -> str:
    """End-to-end file conversion: the input as a stereo WAV in
    output/Voice_Stereo.wav, then output/Voice_Converted.<fmt> (a WAV when
    no codec encodes <fmt>). A converter passed in is used as it is; else
    the named model's, on `device`. Returns the output path."""
    if not uploaded_file:
        raise ValueError(
            "audio file not found; make sure it uploaded or check the path"
        )
    if not voice_model:
        raise ValueError("select a voice model for conversion")
    if not os.path.exists(uploaded_file):
        raise ValueError(f"file {uploaded_file} not found")

    out_dir = output_dir or OUTPUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    stereo_path = os.path.join(out_dir, "Voice_Stereo.wav")
    convert_path = os.path.join(out_dir, f"Voice_Converted.{output_format}")
    if os.path.exists(convert_path):
        os.remove(convert_path)

    progress(0.05, "converting input to stereo")
    save_stereo_wav(uploaded_file, stereo_path)

    progress(0.1, "loading models")
    vc = converter or get_converter(voice_model, models_dir=models_dir,
                                    use_index=index_rate > 0, device=device)

    opts = ConversionOptions(
        pitch=pitch, f0_method=f0_method, index_rate=index_rate,
        filter_radius=filter_radius, volume_envelope=volume_envelope,
        protect=protect, hop_length=hop_length,
        f0_min=f0_min, f0_max=f0_max, output_format=output_format,
    )
    audio16k = load_audio(stereo_path, 16000)
    out, out_sr = vc.convert(audio16k, opts, progress=progress)

    try:
        write_audio(convert_path, out, out_sr)
    except CodecUnavailable as e:
        fallback = os.path.splitext(convert_path)[0] + ".wav"
        print(f"[!] {e}; writing WAV instead: {fallback}")
        write_audio(fallback, out, out_sr)
        convert_path = fallback
    progress(1.0, "done")
    return convert_path
