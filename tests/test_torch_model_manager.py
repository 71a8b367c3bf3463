"""The port's voice-model installation, download helpers and Edge-TTS
entry points against the JAX package, on the CPU.

Model manager: zip extraction with size-gated discovery and flattening,
the traversal, zip-slip and duplicate guards (tests/test_app.py,
tests/test_hardening.py). Downloads: the Mega client's URL parsing, key
folding, attribute and stream decryption with the network mocked
(tests/test_download_mega.py); no other download runs offline. Edge-TTS:
the protocol builders (sec_ms_gec at a fixed clock, equal to JAX's), the
CLI parser equal to JAX's, and edge_tts_pipeline with the speech request
replaced by a local writer, on a tiny CPU converter.
"""

import base64
import datetime
import json
import os
import struct
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

from polgen_rvc_tpu.app import edge_tts_client as jax_client
from polgen_rvc_tpu.app.edge_tts_cli import build_parser as jax_build_parser
from polgen_rvc_tpu.app.tts_voices import ALL_VOICES as JAX_ALL_VOICES
from polgen_rvc_tpu.app.tts_voices import EDGE_VOICES as JAX_EDGE_VOICES
from polgen_rvc_tpu_torch.app import download_source as ds
from polgen_rvc_tpu_torch.app import edge_tts_cli, edge_tts_client, edge_tts_conversion
from polgen_rvc_tpu_torch.app import model_manager as mm
from polgen_rvc_tpu_torch.app.tts_voices import ALL_VOICES, EDGE_VOICES
from test_torch_pipeline import one_intra_op_thread  # noqa: F401

PKG = Path(__file__).resolve().parent.parent / "polgen_rvc_tpu_torch"


# -- model manager -----------------------------------------------------------

def _model_zip(path, entries):
    with zipfile.ZipFile(path, "w") as z:
        for name, data in entries.items():
            z.writestr(name, data)
    return str(path)


def test_extract_zip_finds_and_flattens(tmp_path):
    """Decoys below the size gates are ignored; the real files come up to
    the folder's top and the nested folders go (tests/test_app.py)."""
    zpath = _model_zip(tmp_path / "model.zip", {
        "nested/readme.txt": "hi", "nested/tiny.pth": b"x" * 10,
        "nested/deep/voice.pth": b"p" * 2048, "nested/voice.index": b"i" * 512})
    dest = str(tmp_path / "MyVoice")
    mm.extract_zip(dest, zpath, min_pth_bytes=1024, min_index_bytes=256)
    assert sorted(os.listdir(dest)) == ["voice.index", "voice.pth"]
    assert not os.path.exists(zpath)


def test_extract_zip_without_a_model_raises(tmp_path):
    zpath = _model_zip(tmp_path / "empty.zip", {"a/readme.txt": "no model"})
    with pytest.raises(mm.ModelInstallError, match="no .pth"):
        mm.extract_zip(str(tmp_path / "V"), zpath)


def test_upload_zip_file_installs_under_models(tmp_path):
    zpath = _model_zip(tmp_path / "v.zip", {"v/voice.pth": b"p" * (41 << 20),
                                            "v/added.index": b"i" * (101 << 10)})
    models = tmp_path / "models"
    msg = mm.upload_zip_file(zpath, "Voice", models_dir=str(models))
    assert msg == "[+] Model Voice installed successfully!"
    assert sorted(os.listdir(models / "Voice")) == ["added.index", "voice.pth"]
    assert mm.get_folders(str(models)) == ["Voice"]
    assert mm.get_folders(str(tmp_path / "none")) == []


def test_upload_separate_files_and_the_duplicate_guard(tmp_path):
    pth, index = tmp_path / "a.pth", tmp_path / "a.index"
    pth.write_bytes(b"p" * 100)
    index.write_bytes(b"i" * 10)
    models = str(tmp_path / "models")
    mm.upload_separate_files(str(pth), str(index), "dup", models_dir=models)
    assert sorted(os.listdir(os.path.join(models, "dup"))) == ["a.index", "a.pth"]
    with pytest.raises(mm.ModelInstallError, match="already exists"):
        mm.upload_separate_files(None, None, "dup", models_dir=models)
    with pytest.raises(mm.ModelInstallError, match="already exists"):
        mm.upload_zip_file(str(tmp_path / "x.zip"), "dup", models_dir=models)


@pytest.mark.parametrize("bad", ["../x", "a/b", "..", ".", "", "a\\b", "../../etc"])
def test_model_dir_traversal_rejected(tmp_path, bad):
    with pytest.raises(mm.ModelInstallError):
        mm._safe_model_dir(str(tmp_path), bad)
    with pytest.raises(mm.ModelInstallError):
        mm.upload_separate_files(None, None, bad, models_dir=str(tmp_path))


def test_model_dir_plain_name_ok(tmp_path):
    assert mm._safe_model_dir(str(tmp_path), "MyVoice").endswith("MyVoice")


def test_zip_slip_rejected(tmp_path):
    zpath = _model_zip(tmp_path / "evil.zip", {"../escape.pth": b"p" * 2048})
    with pytest.raises(mm.ModelInstallError, match="escapes"):
        mm.extract_zip(str(tmp_path / "dest"), zpath, min_pth_bytes=1024,
                       min_index_bytes=256)
    assert not (tmp_path.parent / "escape.pth").exists()


def test_main_usage_and_download_errors(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["model_manager"])
    with pytest.raises(SystemExit) as e:
        mm.main()
    assert e.value.code == 1 and "polgen_rvc_tpu_torch.app.model_manager" in capsys.readouterr().out

    def refuse(url, dir_name):
        raise ds.DownloadError(f"download failed for {url}: offline")

    monkeypatch.setattr(mm, "download_from_url", refuse)
    monkeypatch.setattr(sys, "argv", ["model_manager", "https://x/y.zip", "V"])
    with pytest.raises(SystemExit) as e:
        mm.main()
    assert e.value.code == 1 and "Error: download failed" in capsys.readouterr().out


def test_no_module_imports_requests_at_load():
    """model_manager loads download_source, whose downloads need requests:
    importing every module of the port loads no requests (nor jax)."""
    modules = [".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
               for p in sorted(PKG.rglob("*.py"))]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('requests', 'jax', 'polgen_rvc_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# -- the Mega client, network mocked -----------------------------------------

def _b64url(data: bytes) -> str:
    return base64.b64encode(data).decode().replace("+", "-").replace("/", "_").rstrip("=")


def _mega_fixture(payload: bytes, name="voice.zip", seed=7):
    """(url, api response, encrypted stream, key, nonce) as Mega serves
    a public file."""
    rng = np.random.default_rng(seed)
    key = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    nonce = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
    second = nonce + bytes(8)
    node_key = bytes(a ^ b for a, b in zip(key, second)) + second
    url = f"https://mega.nz/file/AbCd1234#{_b64url(node_key)}"
    enc = Cipher(algorithms.AES(key), modes.CTR(nonce + b"\0" * 8)).encryptor()
    stream = enc.update(payload) + enc.finalize()
    attrs = b"MEGA" + json.dumps({"n": name}).encode()
    attrs += b"\0" * (-len(attrs) % 16)
    cbc = Cipher(algorithms.AES(key), modes.CBC(b"\0" * 16)).encryptor()
    at = _b64url(cbc.update(attrs) + cbc.finalize())
    api = [{"g": "https://fake.mega.download/abc", "s": len(payload), "at": at}]
    return url, api, stream, key, nonce


class _FakeResp:
    def __init__(self, body, json_body=None):
        self._body, self._json = body, json_body
        self.headers = {"content-length": str(len(body or b""))}

    def raise_for_status(self):
        pass

    def json(self):
        return self._json

    def iter_content(self, chunk_size=1 << 20):
        for i in range(0, len(self._body), chunk_size):
            yield self._body[i:i + chunk_size]


class _FakeSession:
    def __init__(self, api_json, stream):
        self.api_json, self.stream, self.posts = api_json, stream, []

    def post(self, url, params=None, json=None, timeout=None):
        self.posts.append((url, json))
        return _FakeResp(b"", json_body=self.api_json)

    def get(self, url, stream=True, timeout=None):
        return _FakeResp(self.stream)


def test_parse_mega_url_formats():
    key = bytes(range(32))
    assert ds.parse_mega_url(f"https://mega.nz/file/h4ndLe-1#{_b64url(key)}") == ("h4ndLe-1", key)
    assert ds.parse_mega_url(f"https://mega.co.nz/#!oldH4nd!{_b64url(key)}") == ("oldH4nd", key)


@pytest.mark.parametrize("url", ["https://mega.nz/folder/abc#def",
                                 f"https://mega.nz/file/h#{_b64url(bytes(16))}"])
def test_parse_mega_url_rejects_bad(url):
    with pytest.raises(ds.DownloadError):
        ds.parse_mega_url(url)


def test_file_key_folding():
    k, nonce = ds.mega_file_key(bytes(range(32)))
    assert k == bytes(a ^ b for a, b in zip(range(16), range(16, 32)))
    assert nonce == bytes(range(16, 24))


def test_attribute_decrypt_roundtrip_and_bad_key():
    _, api, _, key, _ = _mega_fixture(b"x" * 64, name="My Voice.zip")
    assert ds.mega_decrypt_attributes(api[0]["at"], key)["n"] == "My Voice.zip"
    with pytest.raises(ds.DownloadError, match="bad key"):
        ds.mega_decrypt_attributes(api[0]["at"], bytes(b ^ 0xFF for b in key))


def test_download_mega_end_to_end_mocked(tmp_path):
    payload = bytes(np.random.default_rng(0).integers(0, 256, 3 * (1 << 20) + 123,
                                                      dtype=np.uint8))
    url, api, stream, *_ = _mega_fixture(payload)
    sess = _FakeSession(api, stream)
    out, seen = str(tmp_path / "model.zip"), []
    ds.download_mega(url, out, progress=lambda f, m: seen.append(f), session=sess)
    assert open(out, "rb").read() == payload
    assert sess.posts[0][1] == [{"a": "g", "g": 1, "p": "AbCd1234"}]
    assert seen and max(seen) <= 0.79


def test_download_mega_api_error(tmp_path):
    url, *_ = _mega_fixture(b"x")
    with pytest.raises(ds.DownloadError, match="-9"):
        ds.download_mega(url, str(tmp_path / "x.zip"), session=_FakeSession([-9], b""))


def test_dispatch_routes_mega_and_wraps_errors(tmp_path, monkeypatch):
    called = {}
    monkeypatch.setattr(ds, "download_mega",
                        lambda url, path, progress=None: called.setdefault("url", url))
    ds.download_file("https://mega.nz/file/h#k", str(tmp_path / "z.zip"))
    assert called["url"].startswith("https://mega.nz/")

    def offline(*a, **k):
        raise OSError("offline")

    monkeypatch.setattr(ds, "download_pixeldrain", offline)
    with pytest.raises(ds.DownloadError, match="offline"):
        ds.download_file("https://pixeldrain.com/u/abc", str(tmp_path / "p.zip"))


# -- Edge-TTS ----------------------------------------------------------------

def test_voice_catalog_equals_jax():
    assert EDGE_VOICES == JAX_EDGE_VOICES and ALL_VOICES == JAX_ALL_VOICES
    assert len(EDGE_VOICES) == 35 and len(ALL_VOICES) == 70


class _FixedClock:
    """The datetime module with now() pinned, for both clients."""

    def __init__(self, when):
        self.timezone = datetime.timezone

        class _DateTime(datetime.datetime):
            @classmethod
            def now(cls, tz=None):
                return when

        self.datetime = _DateTime


@pytest.mark.parametrize("when", [datetime.datetime(2026, 10, 17, 12, 34, 56, tzinfo=datetime.timezone.utc),
                                  datetime.datetime(2030, 1, 1, 0, 0, 0, tzinfo=datetime.timezone.utc)])
def test_protocol_builders_equal_jax_at_a_fixed_clock(monkeypatch, when):
    clock = _FixedClock(when)
    monkeypatch.setattr(edge_tts_client, "datetime", clock)
    monkeypatch.setattr(jax_client, "datetime", clock)
    token = edge_tts_client.sec_ms_gec()
    assert token == jax_client.sec_ms_gec() and len(token) == 64 and token == token.upper()
    epoch = datetime.datetime(1601, 1, 1, tzinfo=datetime.timezone.utc)
    ticks = int((when - epoch).total_seconds())
    ticks -= ticks % 300
    want = f"{ticks * 10_000_000}{edge_tts_client.TRUSTED_CLIENT_TOKEN}"
    import hashlib

    assert token == hashlib.sha256(want.encode("ascii")).hexdigest().upper()
    assert edge_tts_client.build_config_message() == jax_client.build_config_message()
    ssml = edge_tts_client.build_ssml("hello <world> & 'friends'", "en-US-GuyNeural",
                                      rate="+5%", volume="-10%", pitch="+2Hz")
    assert ssml == jax_client.build_ssml("hello <world> & 'friends'", "en-US-GuyNeural",
                                         rate="+5%", volume="-10%", pitch="+2Hz")
    assert "&lt;world&gt;" in ssml and "&amp;" in ssml and "en-US-GuyNeural" in ssml
    msg = edge_tts_client.build_ssml_message("req123", ssml)
    assert msg == jax_client.build_ssml_message("req123", ssml)
    assert msg.startswith("X-RequestId:req123") and "Path:ssml" in msg
    assert "Path:speech.config" in edge_tts_client.build_config_message()


class _Sock:
    def __init__(self, data):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


@pytest.mark.parametrize("n", [5, 200, 70000])
def test_ws_frames_round_trip(n, monkeypatch):
    payload = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    monkeypatch.setattr(edge_tts_client.secrets, "token_bytes", lambda k: b"\x01\x02\x03\x04")
    frame = edge_tts_client.encode_ws_frame(0x2, payload)
    assert frame == jax_client.encode_ws_frame(0x2, payload)  # same mask, same bytes
    assert frame[0] == 0x82 and frame[1] & 0x80
    assert edge_tts_client.decode_ws_frame(_Sock(frame)) == (0x2, payload)
    unmasked = bytes([0x81, 126]) + struct.pack(">H", 300) + b"t" * 300
    assert edge_tts_client.decode_ws_frame(_Sock(unmasked)) == (0x1, b"t" * 300)
    with pytest.raises(ConnectionError):
        edge_tts_client.read_exact(_Sock(b"ab"), 3)


def test_binary_frame_parse():
    headers = b"Path:audio\r\nContent-Type:audio/mpeg"
    payload = struct.pack(">H", len(headers)) + headers + b"MP3DATA"
    assert edge_tts_client.parse_binary_frame(payload) == jax_client.parse_binary_frame(payload)
    h, data = edge_tts_client.parse_binary_frame(payload)
    assert h["Path"] == "audio" and data == b"MP3DATA"


def test_cli_parser_equals_jax():
    def surface(parser):
        return {tuple(a.option_strings): (a.dest, a.default, a.type, a.required)
                for a in parser._actions}

    assert surface(edge_tts_cli.build_parser()) == surface(jax_build_parser())
    args = edge_tts_cli.build_parser().parse_args(["-t", "hi", "--voice", "v", "-m", "m",
                                                   "-p", "1"])
    assert (args.text_input, args.tts_voice, args.index_rate, args.format) == ("hi", "v", 0,
                                                                               "mp3")


def test_cli_main_rejects_a_missing_model(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="Model nope does not exist"):
        edge_tts_cli.main(["-i", "hi", "-v", "en-US-GuyNeural", "-m", "nope", "-p", "0"])


def test_edge_tts_pipeline_with_a_local_speech_writer(tmp_path, monkeypatch):
    """text_to_speech replaced by a writer of a local 24 kHz mp3 (the
    format Edge serves): the pipeline writes the stereo WAV and the
    converted file, and its output is the converter's on that speech."""
    from polgen_rvc_tpu_torch.pipeline.config import ConversionOptions, EngineConfig
    from polgen_rvc_tpu_torch.pipeline.factory import build_synthetic_converter
    from polgen_rvc_tpu_torch.utils.audio_io import load_audio, read_audio, write_audio

    said = []

    def speak(text, voice, output_path):
        said.append((text, voice))
        t = np.arange(24000) / 24000
        write_audio(output_path, (0.4 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), 24000)
        return output_path

    monkeypatch.setattr(edge_tts_conversion, "text_to_speech", speak)
    vc = build_synthetic_converter(
        tiny=True, sr=48000, device="cpu",
        engine=EngineConfig(x_pad=1, x_query=2, x_center=3, x_max=4, chunk_batch=2,
                            bucket_step_s=2))
    out_dir = str(tmp_path / "out")
    converted, stereo = edge_tts_conversion.edge_tts_pipeline(
        "hello", "voice", "en-US-GuyNeural", 0, index_rate=0.0, output_format="wav",
        output_dir=out_dir, converter=vc)
    assert said == [("hello", "en-US-GuyNeural")]
    assert converted == os.path.join(out_dir, "TTS_Voice_Converted.wav")
    assert stereo == os.path.join(out_dir, "TTS_Voice_Stereo.wav")
    y, sr = read_audio(converted)
    want, _ = vc.convert(load_audio(stereo, 16000), ConversionOptions(index_rate=0.0))
    assert sr == 48000 and np.array_equal(np.round(y[:, 0] * 32768).astype(np.int16), want)
    for missing in ("text", "voice", "voice_model"):
        kw = {**dict(text="hi", voice_model="voice", voice="v", pitch=0), missing: ""}
        with pytest.raises(ValueError):
            edge_tts_conversion.edge_tts_pipeline(**kw, converter=vc)


def test_edge_tts_pipeline_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """Without a converter and without CUDA, the pipeline raises through
    resolve_device before any speech request."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(edge_tts_conversion, "text_to_speech",
                        lambda *a: pytest.fail("speech requested without a card"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edge_tts_conversion.edge_tts_pipeline("hi", "voice", "v", 0)
