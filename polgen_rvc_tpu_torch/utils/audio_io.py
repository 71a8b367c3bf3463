"""Host-side audio I/O with no native dependencies: a copy of the JAX
package's utils/audio_io.py.

WAV (PCM 8/16/24/32 and float32/64) is read and written here; MP3 goes
through ctypes bindings to libmp3lame/libmpg123 (utils/mp3_codec.py), FLAC
through the port's native codec (native/flac.py, built with g++ at first
use), each with an ffmpeg-subprocess fallback where its codec is missing.
Without a codec, CodecUnavailable is raised. A native codec that is there
and fails (a build error, a corrupt file) raises.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess

import numpy as np


class CodecUnavailable(RuntimeError):
    pass


def _read_wav(path: str):
    """(samples (T, C) float32 in [-1, 1], sr). Handles 24-bit PCM + float."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            payload = f.read(size)
            if size % 2:
                f.read(1)
            if cid == b"fmt ":
                fmt = payload
            elif cid == b"data":
                data = payload
                if fmt is not None:
                    break
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    (audio_format, channels, sr, _, _, bits) = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]
    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            x = ints.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM depth {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_format}")
    return x.reshape(-1, channels), int(sr)


_PCM_BITS = {"pcm8": 8, "pcm16": 16, "pcm24": 24, "pcm32": 32}
_FLOAT_BITS = {"float32": 32, "float64": 64}


def _encode_pcm(samples: np.ndarray, subtype: str) -> tuple:
    """(T, C) float in [-1, 1] (or int16 for pcm16) -> (format tag, bits,
    little-endian sample bytes)."""
    if subtype in _FLOAT_BITS:
        bits = _FLOAT_BITS[subtype]
        return 3, bits, samples.astype("<f4" if bits == 32 else "<f8").tobytes()
    if subtype not in _PCM_BITS:
        raise ValueError(f"unknown WAV subtype {subtype!r}")
    bits = _PCM_BITS[subtype]
    if subtype == "pcm16" and samples.dtype == np.int16:
        return 1, bits, samples.astype("<i2").tobytes()
    x = np.clip(samples.astype(np.float64), -1.0, 1.0)
    full = float(2 ** (bits - 1) - 1)
    ints = np.round(x * full).astype(np.int64)
    if bits == 8:
        return 1, bits, (ints + 128).astype(np.uint8).tobytes()
    if bits == 24:
        raw = ints.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        return 1, bits, raw.tobytes()
    return 1, bits, ints.astype("<i2" if bits == 16 else "<i4").tobytes()


def _write_wav(path: str, samples: np.ndarray, sr: int, *, subtype: str = "pcm16"):
    """samples: (T,) or (T, C) float in [-1, 1], or int16; subtype one of
    pcm8, pcm16 (the default), pcm24, pcm32, float32, float64."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[:, None]
    tag, bits, data = _encode_pcm(samples, subtype)
    channels = samples.shape[1]
    block = channels * bits // 8
    fmt = struct.pack("<HHIIHH", tag, channels, int(sr), int(sr) * block, block, bits)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)
                                      + len(data) % 2) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)
        if len(data) % 2:
            f.write(b"\0")


def read_audio(path: str):
    """Decode any supported file -> ((T, C) float32, sr)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return _read_wav(path)
    if ext == ".flac":
        from ..native import available, flac

        if available("polgen_flac"):
            return flac.decode(path)
    if ext == ".mp3":
        from . import mp3_codec

        try:
            return mp3_codec.decode_mp3(path)
        except mp3_codec.Mp3Unavailable:
            pass  # fall through to ffmpeg
    if shutil.which("ffmpeg"):
        out = subprocess.run(
            ["ffmpeg", "-v", "error", "-i", path, "-f", "f32le", "-"],
            capture_output=True, check=True,
        )
        probe = subprocess.run(
            ["ffprobe", "-v", "error", "-show_entries",
             "stream=sample_rate,channels", "-of", "csv=p=0", path],
            capture_output=True, check=True, text=True,
        )
        sr, ch = probe.stdout.strip().split("\n")[0].split(",")[:2]
        x = np.frombuffer(out.stdout, np.float32).reshape(-1, int(ch))
        return x, int(sr)
    raise CodecUnavailable(
        f"cannot decode {ext or path}: no codec and ffmpeg not present"
    )


def write_audio(path: str, samples, sr: int):
    """Encode by extension: WAV here, mp3 through libmp3lame, FLAC through
    the native codec, anything else (and mp3 or FLAC without its codec)
    through ffmpeg."""
    ext = os.path.splitext(path)[1].lower()
    samples = np.asarray(samples)
    if ext == ".wav":
        _write_wav(path, samples, sr)
        return path
    if ext == ".flac":
        from ..native import available, flac

        if available("polgen_flac"):
            return flac.encode(path, samples, sr)
    if ext == ".mp3":
        from . import mp3_codec

        try:
            return mp3_codec.encode_mp3(path, samples, sr)
        except mp3_codec.Mp3Unavailable:
            pass  # fall through to ffmpeg
    if shutil.which("ffmpeg"):
        tmp = path + ".tmp.wav"
        _write_wav(tmp, samples, sr)
        subprocess.run(
            ["ffmpeg", "-v", "error", "-y", "-i", tmp, path], check=True
        )
        os.unlink(tmp)
        return path
    raise CodecUnavailable(
        f"cannot encode {ext}: no codec and ffmpeg not present "
        "(use .wav, or install ffmpeg)"
    )


def load_audio(path: str, target_sr: int) -> np.ndarray:
    """Reference load_audio (my_utils.py:5-16): mono float32 at target_sr."""
    try:
        x, sr = read_audio(path)
    except FileNotFoundError:
        raise RuntimeError(f"audio file not found: {path}")
    mono = x.mean(axis=1)
    if sr != target_sr:
        from ..ops.resample import resample

        mono = resample(mono.astype(np.float32), sr, target_sr).numpy()
    return mono.astype(np.float32).flatten()


def to_stereo(x: np.ndarray) -> np.ndarray:
    """(T,) or (T, C) -> (T, 2) (reference convert_to_stereo semantics)."""
    if x.ndim == 1:
        return np.stack([x, x], axis=1)
    if x.shape[1] == 1:
        return np.repeat(x, 2, axis=1)
    return x[:, :2]


def save_stereo_wav(in_path: str, out_path: str):
    """convert_to_stereo (voice_conversion.py:45-51): any file -> stereo WAV
    at the original rate."""
    x, sr = read_audio(in_path)
    _write_wav(out_path, to_stereo(x), sr)
    return out_path
