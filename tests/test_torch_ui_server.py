"""The port's web UI server and its installers, against the JAX package's.

The job store, the multipart parser, the static page and the JSON routes
over a real socket; every POST route forwards the same request to the
same callable with the same arguments as the JAX server does (the job
functions faked on both sides); one real /api/convert on the CPU, whose
WAV equals voice_pipeline's bytes; the embedder installer and the asset
bootstrap offline, through file:// URLs."""

import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import polgen_rvc_tpu.app.edge_tts_conversion as jax_tts
import polgen_rvc_tpu.app.install_embedders as jax_embedders
import polgen_rvc_tpu.app.ui.server as jax_srv
import polgen_rvc_tpu_torch.app.edge_tts_conversion as port_tts
import polgen_rvc_tpu_torch.app.ui.server as srv
from polgen_rvc_tpu_torch.app import download_assets, install_embedders, voice_conversion
from polgen_rvc_tpu_torch.app.audio_processing import EFFECT_DEFAULTS
from polgen_rvc_tpu_torch.utils import audio_io
from test_torch_app import app_root  # noqa: F401 (module fixture)
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse)
from test_ui_server import _REFERENCE_EFFECT_DEFAULTS


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture
def server():
    httpd, base = _serve(srv.Handler)
    yield base
    httpd.shutdown()
    httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


def _post(url, body, content_type="application/json"):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(base, job, timeout=300.0):
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        st = json.loads(_get(f"{base}/api/job/{job}"))
        if st["status"] in ("done", "error"):
            return st
        time.sleep(0.02)
    raise AssertionError(f"job {job} still {st}")


def _multipart(boundary, fields):
    parts = []
    for name, value in fields.items():
        if isinstance(value, tuple):
            fname, data = value
            parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; '
                         f'filename="{fname}"\r\nContent-Type: application/octet-stream'
                         f'\r\n\r\n'.encode() + data + b"\r\n")
        else:
            parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                         f'name="{name}"\r\n\r\n{value}\r\n'.encode())
    return b"".join(parts) + f"--{boundary}--\r\n".encode()


def test_jobstore_lifecycle_and_error_capture():
    jobs = srv.JobStore()

    def work(progress=None):
        progress(0.5, "halfway")
        time.sleep(0.05)
        return "result-path"

    def boom(progress=None):
        raise ValueError("kaput")

    ok, bad = jobs.start(work), jobs.start(boom)
    for _ in range(200):
        if {jobs.get(ok)["status"], jobs.get(bad)["status"]} <= {"done", "error"}:
            break
        time.sleep(0.02)
    assert jobs.get(ok)["status"] == "done" and jobs.get(ok)["result"] == "result-path"
    assert jobs.get(ok)["progress"] == 1.0
    st = jobs.get(bad)
    assert st["status"] == "error" and "kaput" in st["error"]
    assert jobs.get("nope")["status"] == "unknown"


def test_jobs_run_one_at_a_time():
    """Pipeline jobs serialize on one lock (they write fixed output names)."""
    jobs = srv.JobStore()
    spans = []

    def work(i, progress=None):
        t0 = time.monotonic()
        time.sleep(0.05)
        spans.append((t0, time.monotonic()))
        return i

    ids = [jobs.start(work, i) for i in range(3)]
    for _ in range(300):
        if all(jobs.get(j)["status"] == "done" for j in ids):
            break
        time.sleep(0.02)
    assert [jobs.get(j)["result"] for j in ids] == [0, 1, 2]
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_multipart_parser_matches_jax():
    body = _multipart("XBOUNDARY", {"file": ("a.wav", b"BINARY\x00DATA"), "label": "hello"})
    ctype = "multipart/form-data; boundary=XBOUNDARY"
    fields = srv.parse_multipart(body, ctype)
    assert fields == {"file": ("a.wav", b"BINARY\x00DATA"), "label": "hello"}
    assert fields == jax_srv.parse_multipart(body, ctype)
    with pytest.raises(ValueError):
        srv.parse_multipart(b"", "multipart/form-data")


def test_http_routes(server, tmp_path, monkeypatch):
    """The static page and the JSON GET routes over a real socket, equal
    to the JAX server's; unknown routes 404, a bad POST answers 400.
    /api/models lists the working directory's models/ (the JAX package
    fixes its models/ at import)."""
    monkeypatch.chdir(tmp_path)
    os.makedirs("models/voice")
    open("models/voice/voice.pth", "wb").close()
    jax_httpd, jax_base = _serve(jax_srv.Handler)
    try:
        html = _get(f"{server}/")
        assert b"PolGen-RVC-TPU" in html and html == _get(f"{jax_base}/index.html")
        for route in ("/api/voices", "/api/effect_defaults",
                      "/api/embedders", "/api/job/nope"):
            assert json.loads(_get(server + route)) == json.loads(_get(jax_base + route))
        assert json.loads(_get(f"{server}/api/models")) == {"models": ["voice"]}
        assert "Russian" in json.loads(_get(f"{server}/api/voices"))["voices"]
        assert json.loads(_get(f"{server}/api/embedders"))["presets"][0] == "hubert_base.pt"
        for url in (f"{server}/nope", f"{server}/audio/missing.wav"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(url)
            assert e.value.code == 404
        code, body = _post(f"{server}/api/convert", {"model": "voice"})
        assert code == 400 and body == _post(f"{jax_base}/api/convert", {"model": "voice"})[1]
    finally:
        jax_httpd.shutdown()
        jax_httpd.server_close()


def test_effect_defaults_and_the_page_knobs():
    """The port's page is the JAX package's, byte for byte: every one of the
    18 processing knobs has a control at the reference default and is
    posted by the page's submit list."""
    import re

    import polgen_rvc_tpu.app.ui as jax_ui
    import polgen_rvc_tpu_torch.app.ui as ui

    assert EFFECT_DEFAULTS == _REFERENCE_EFFECT_DEFAULTS
    html = open(os.path.join(os.path.dirname(ui.__file__), "index.html")).read()
    assert html == open(os.path.join(os.path.dirname(jax_ui.__file__), "index.html")).read()
    for knob, default in _REFERENCE_EFFECT_DEFAULTS.items():
        m = re.search(rf'id="{knob}"[^>]*value="([^"]+)"', html)
        assert m and float(m.group(1)) == default, knob
        assert f'"{knob}"' in html, knob


# one request per POST route that starts a job or installs: the JSON a page
# would send, with every knob away from its default
_SENT = {
    "/api/convert": {"input_path": "/in/song.wav", "model": "voice", "pitch": 3,
                     "index_rate": 0.7, "filter_radius": 5, "volume_envelope": 0.5,
                     "f0_method": "fcpe", "hop_length": 64, "protect": 0.2,
                     "output_format": "flac", "f0_min": 60, "f0_max": 900},
    "/api/tts": {"text": "hello", "model": "voice", "voice": "en-US-AriaNeural",
                 "pitch": -2, "index_rate": 0.3, "volume_envelope": 0.4,
                 "f0_method": "mangio-crepe", "protect": 0.4, "output_format": "mp3"},
    "/api/process": {"vocal_path": "/v.wav", "instrumental_path": "/i.wav",
                     "output_format": "flac", "vocal_gain": 2, "instrumental_gain": -3,
                     "use_effects": False,
                     **{k: round(v + 0.25, 3) for k, v in _REFERENCE_EFFECT_DEFAULTS.items()}},
    "/api/install/url": {"url": "https://example.invalid/m.zip", "name": "m"},
    "/api/install/zip": {"zip_path": "/z.zip", "name": "z"},
    "/api/install/files": {"pth_path": "/a.pth", "index_path": "/a.index", "name": "f"},
    "/api/install/embedder": {"preset": "contentvec_base.pt",
                              "custom_url": "https://example.invalid/x.pt"},
}
_TARGETS = {  # route -> (module attribute the route calls, on each server)
    "/api/convert": "voice_pipeline", "/api/tts": "edge_tts_pipeline",
    "/api/process": "process_audio", "/api/install/url": "download_from_url",
    "/api/install/zip": "upload_zip_file", "/api/install/files": "upload_separate_files",
    "/api/install/embedder": "download_and_replace_model",
}


@pytest.mark.parametrize("route", list(_SENT))
def test_post_routes_forward_as_the_jax_server_does(route, monkeypatch):
    """The same request JSON to both servers reaches the same callable with
    the same arguments (progress reporters aside); the port's conversion
    routes add the server's device, the one addition to the JAX call."""
    calls = {}

    def fake(side):
        def record(*args, progress=None, **kwargs):
            calls[side] = (args, kwargs)
            return "ok"
        return record

    name = _TARGETS[route]
    for side, mod, tts in (("jax", jax_srv, jax_tts), ("port", srv, port_tts)):
        monkeypatch.setattr(tts if route == "/api/tts" else mod, name, fake(side))
    monkeypatch.setattr(srv.Handler, "device", torch.device("cpu"))
    answers = {}
    for side, mod in (("jax", jax_srv), ("port", srv)):
        httpd, base = _serve(mod.Handler)
        try:
            code, body = _post(base + route, _SENT[route])
            assert code == 200, body
            if "job" in body:
                assert _wait(base, body["job"])["status"] == "done"
                body = {"job": "<id>"}
            answers[side] = body
        finally:
            httpd.shutdown()
            httpd.server_close()
    assert answers["port"] == answers["jax"]
    args, kwargs = calls["port"]
    if route in ("/api/convert", "/api/tts"):
        assert kwargs.pop("device") == torch.device("cpu")
    assert (args, kwargs) == calls["jax"]


def test_upload_saves_each_file(server, tmp_path, monkeypatch):
    """/api/upload saves every file field under output/uploads with a
    random prefix, as the JAX server does, and answers its absolute path."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_srv, "UPLOADS_DIR", str(tmp_path / "jax_uploads"))
    body = _multipart("B0UND", {"audio": ("song.wav", b"RIFF\x00\x01"), "note": "x",
                                "other": ("../../b.bin", b"\xff" * 70000)})
    ctype = "multipart/form-data; boundary=B0UND"
    jax_httpd, jax_base = _serve(jax_srv.Handler)
    try:
        code, port_paths = _post(f"{server}/api/upload", body, ctype)
        _, jax_paths = _post(f"{jax_base}/api/upload", body, ctype)
    finally:
        jax_httpd.shutdown()
        jax_httpd.server_close()
    assert code == 200 and sorted(port_paths["paths"]) == sorted(jax_paths["paths"])
    for field, want in (("audio", b"RIFF\x00\x01"), ("other", b"\xff" * 70000)):
        path = port_paths["paths"][field]
        assert os.path.isabs(path) and os.path.dirname(path) == str(tmp_path / "output"
                                                                    / "uploads")
        assert os.path.basename(path).split("_", 1)[1] == os.path.basename(
            jax_paths["paths"][field]).split("_", 1)[1]
        assert open(path, "rb").read() == want == open(jax_paths["paths"][field], "rb").read()


def test_served_convert_equals_voice_pipeline(app_root, monkeypatch):  # noqa: F811
    """Upload a 1 s stereo 44.1 kHz song, /api/convert it on the CPU with
    the app layout's model (the handler serve(device="cpu") makes), poll to
    done and fetch the WAV: the bytes voice_pipeline writes on the same
    cached converter."""
    monkeypatch.chdir(app_root)
    t = np.arange(44100) / 44100
    x = (0.4 * np.sin(2 * np.pi * 220 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t))))
    audio_io.write_audio("short.wav", np.stack([x, 0.8 * x], 1).astype(np.float32), 44100)
    monkeypatch.setattr(voice_conversion, "_CONVERTER_CACHE", {})
    monkeypatch.setattr(srv.Handler, "device", None)

    def bound(port):
        raise KeyboardInterrupt  # stop before serving: serve() closes its socket

    with pytest.raises(KeyboardInterrupt):
        srv.serve(0, on_bound=bound, device="cpu")
    assert srv.Handler.device == torch.device("cpu")
    httpd, base = _serve(srv.Handler)
    try:
        body = _multipart("S0NG", {"file": ("short.wav", open("short.wav", "rb").read())})
        _, up = _post(f"{base}/api/upload", body, "multipart/form-data; boundary=S0NG")
        req = {"input_path": up["paths"]["file"], "model": "voice", "pitch": 0,
               "index_rate": 0.5, "output_format": "wav"}
        code, job = _post(f"{base}/api/convert", req)
        st = _wait(base, job["job"])
        assert st["status"] == "done", st
        assert st["result"] == os.path.join("output", "Voice_Converted.wav")
        served = _get(f"{base}/audio/Voice_Converted.wav")
    finally:
        httpd.shutdown()
        httpd.server_close()
    (vc,) = voice_conversion._CONVERTER_CACHE.values()
    assert vc.device.type == "cpu"
    path = voice_conversion.voice_pipeline(up["paths"]["file"], "voice", 0.0,
                                           index_rate=0.5, output_format="wav",
                                           device="cpu")
    assert list(voice_conversion._CONVERTER_CACHE.values()) == [vc]
    direct = open(path, "rb").read()
    assert served[:4] == b"RIFF" and len(served) > 44 + 48000
    assert served == direct


def test_serve_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(srv.Handler, "device", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        srv.serve(0)


# ---- the installers, offline through file:// URLs --------------------------

def test_embedder_install_replaces_hubert_atomically(tmp_path, monkeypatch):
    emb = tmp_path / "embedders"
    emb.mkdir()
    (emb / "hubert_base.pt").write_bytes(b"old embedder")
    src = tmp_path / "x.pt"
    src.write_bytes(b"new embedder " * 1000)
    replaced = []
    real_replace = os.replace
    monkeypatch.setattr(install_embedders.os, "replace",
                        lambda a, b: (replaced.append((a, b)), real_replace(a, b))[1])
    monkeypatch.setitem(voice_conversion._CONVERTER_CACHE, ("stale",), object())
    seen = []
    msg = install_embedders.download_and_replace_model(
        "x.pt", src.as_uri(), progress=lambda f, m: seen.append(f),
        embedders_dir=str(emb))
    assert msg == '[+] Embedder "x.pt" installed successfully!'
    assert (emb / "hubert_base.pt").read_bytes() == src.read_bytes()
    assert replaced == [(str(emb / "tmp_model.pt"), str(emb / "hubert_base.pt"))]
    assert sorted(os.listdir(emb)) == ["hubert_base.pt"]
    assert voice_conversion._CONVERTER_CACHE == {} and seen == [0.4, 1.0]
    jax_emb = tmp_path / "jax_embedders"
    assert jax_embedders.download_and_replace_model(
        "x.pt", src.as_uri(), embedders_dir=str(jax_emb)) == msg
    assert (jax_emb / "hubert_base.pt").read_bytes() == src.read_bytes()


@pytest.mark.parametrize("name,url", [("hubert_base.pt", "file:///x/model.bin"),
                                      ("nobody.pt", None)])
def test_embedder_install_errors_match_jax(tmp_path, name, url):
    """A URL that names no .pt file and an unknown preset answer the JAX
    package's error strings and download nothing."""
    got = install_embedders.download_and_replace_model(name, url,
                                                       embedders_dir=str(tmp_path / "p"))
    want = jax_embedders.download_and_replace_model(name, url,
                                                    embedders_dir=str(tmp_path / "j"))
    assert got == want and got.startswith("Error:")
    assert os.listdir(tmp_path / "p") == []


def test_download_assets_fetch_and_skip_present(tmp_path, monkeypatch, capsys):
    hub = tmp_path / "hub"
    for remote in download_assets.ASSETS.values():
        (hub / remote).parent.mkdir(parents=True, exist_ok=True)
        (hub / remote).write_bytes(remote.encode() * 3)
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    dest = os.path.join("assets", "predictors", "rmvpe.pt")
    download_assets.dl_model(hub.as_uri() + "/", "predictors/rmvpe.pt", dest)
    assert open(dest, "rb").read() == b"predictors/rmvpe.pt" * 3
    os.makedirs(os.path.join("assets", "embedders"))
    with open(os.path.join("assets", "embedders", "hubert_base.pt"), "wb") as f:
        f.write(b"mine")
    monkeypatch.setattr(download_assets, "RVC_DOWNLOAD_LINK", hub.as_uri() + "/")
    download_assets.main()
    out = capsys.readouterr().out
    assert "[=] rmvpe.pt already present" in out and "[=] hubert_base.pt already present" in out
    assert "[~] downloading predictors/fcpe.pt..." in out
    assert open(os.path.join("assets", "predictors", "fcpe.pt"), "rb").read() \
        == b"predictors/fcpe.pt" * 3
    assert open(os.path.join("assets", "embedders", "hubert_base.pt"), "rb").read() == b"mine"
    assert sorted(os.listdir(os.path.join("assets", "predictors"))) == ["fcpe.pt", "rmvpe.pt"]
    with pytest.raises(urllib.error.URLError):
        download_assets.dl_model(hub.as_uri() + "/", "missing.pt", "assets/missing.pt")
    assert not os.path.exists("assets/missing.pt") and not os.path.exists(
        "assets/missing.pt.part")
