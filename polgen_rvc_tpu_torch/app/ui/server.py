"""Web UI: a dependency-free HTTP server, the port of the JAX package's
app/ui/server.py.

The conversion tab, the Edge-TTS tab, the processing (mixdown) tab, model
install (URL, zip or files), the embedder installer and the welcome text,
exposed as JSON endpoints and one static page, with background jobs and
polled progress. Every route and its JSON are the JAX server's; the jobs
call the port's pipelines, which convert on the device ``serve`` was given
(CUDA unless the caller passes device="cpu"). Paths are relative to the
working directory (models/, output/, output/uploads/), as the port's
app/voice_conversion.py reads them.

Run: python -m polgen_rvc_tpu_torch.app.main [--port N] [--open]
"""

from __future__ import annotations

import json
import os
import threading
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

from ... import resolve_device
from ...utils.progress import ProgressReporter
from ..audio_processing import EFFECT_DEFAULTS, process_audio
from ..install_embedders import EMBEDDER_PRESETS, download_and_replace_model
from ..model_manager import (
    download_from_url,
    get_folders,
    upload_separate_files,
    upload_zip_file,
)
from ..tts_voices import EDGE_VOICES
from ..voice_conversion import OUTPUT_DIR, voice_pipeline

_STATIC_DIR = os.path.dirname(os.path.abspath(__file__))


class JobStore:
    """Background jobs with polled progress (the web answer to gr.Progress).

    Pipeline jobs are serialized on one lock: they write fixed output
    filenames (output/Voice_Converted.<fmt>), so two concurrent conversions
    would clobber each other's files. The reference's Gradio queue gives
    the same one-at-a-time semantics."""

    def __init__(self):
        self._jobs: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._pipeline_lock = threading.Lock()

    def start(self, fn, *args, serialize: bool = True, **kwargs) -> str:
        job_id = uuid.uuid4().hex[:12]
        with self._lock:
            self._jobs[job_id] = {"status": "queued", "progress": 0.0,
                                  "message": "queued", "result": None,
                                  "error": None}

        def progress_sink(fraction, message):
            with self._lock:
                self._jobs[job_id]["progress"] = float(fraction)
                self._jobs[job_id]["message"] = str(message)

        def run_inner():
            with self._lock:
                self._jobs[job_id].update(status="running", message="starting")
            try:
                result = fn(*args, progress=ProgressReporter(progress_sink),
                            **kwargs)
                with self._lock:
                    self._jobs[job_id].update(status="done", progress=1.0,
                                              result=result)
            except Exception as e:  # a job's failure is reported, the server runs on
                traceback.print_exc()
                with self._lock:
                    self._jobs[job_id].update(status="error", error=str(e))

        def run():
            if serialize:
                with self._pipeline_lock:
                    run_inner()
            else:
                run_inner()

        threading.Thread(target=run, daemon=True).start()
        return job_id

    def get(self, job_id: str) -> dict:
        with self._lock:
            return dict(self._jobs.get(job_id, {"status": "unknown"}))


JOBS = JobStore()
UPLOADS_DIR = os.path.join(OUTPUT_DIR, "uploads")


def parse_multipart(body: bytes, content_type: str) -> dict:
    """Minimal multipart/form-data parser: {name: str | (filename, bytes)}."""
    boundary = None
    for part in content_type.split(";"):
        part = part.strip()
        if part.startswith("boundary="):
            boundary = part[len("boundary="):].strip('"')
    if not boundary:
        raise ValueError("multipart body without boundary")
    delim = b"--" + boundary.encode()
    fields = {}
    for chunk in body.split(delim):
        chunk = chunk.strip(b"\r\n")
        if not chunk or chunk == b"--":
            continue
        header_blob, _, payload = chunk.partition(b"\r\n\r\n")
        headers = {}
        for line in header_blob.decode("utf-8", "replace").split("\r\n"):
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        disp = headers.get("content-disposition", "")
        name = filename = None
        for p in disp.split(";"):
            p = p.strip()
            if p.startswith("name="):
                name = p[5:].strip('"')
            elif p.startswith("filename="):
                filename = p[9:].strip('"')
        if name is None:
            continue
        payload = payload.rstrip(b"\r\n")
        if filename is not None:
            fields[name] = (filename, payload)
        else:
            fields[name] = payload.decode("utf-8", "replace")
    return fields


class Handler(BaseHTTPRequestHandler):
    """The UI's routes. ``device`` is where the conversion jobs run; serve()
    sets it (None: CUDA)."""

    server_version = "PolGenTorch/0.1"
    device = None

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # -- helpers ---------------------------------------------------------
    def _json(self, obj, code=200):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _file(self, path, content_type):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _body(self):
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length)

    # -- routes ----------------------------------------------------------
    def do_GET(self):
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            self._file(os.path.join(_STATIC_DIR, "index.html"),
                       "text/html; charset=utf-8")
        elif url.path == "/api/models":
            self._json({"models": get_folders()})
        elif url.path == "/api/voices":
            self._json({"voices": EDGE_VOICES})
        elif url.path == "/api/effect_defaults":
            self._json(EFFECT_DEFAULTS)
        elif url.path == "/api/embedders":
            self._json({"presets": EMBEDDER_PRESETS})
        elif url.path.startswith("/api/job/"):
            self._json(JOBS.get(url.path.rsplit("/", 1)[-1]))
        elif url.path.startswith("/audio/"):
            name = os.path.basename(url.path[len("/audio/"):])
            ext = os.path.splitext(name)[1].lstrip(".")
            ctype = {"wav": "audio/wav", "mp3": "audio/mpeg",
                     "flac": "audio/flac"}.get(ext, "application/octet-stream")
            self._file(os.path.join(OUTPUT_DIR, name), ctype)
        else:
            self.send_error(404)

    def do_POST(self):
        url = urlparse(self.path)
        try:
            if url.path == "/api/upload":
                fields = parse_multipart(
                    self._body(), self.headers.get("Content-Type", "")
                )
                os.makedirs(UPLOADS_DIR, exist_ok=True)
                saved = {}
                for name, value in fields.items():
                    if isinstance(value, tuple):
                        fname, data = value
                        path = os.path.abspath(os.path.join(
                            UPLOADS_DIR, f"{uuid.uuid4().hex[:8]}_{os.path.basename(fname)}"
                        ))
                        with open(path, "wb") as f:
                            f.write(data)
                        saved[name] = path
                self._json({"paths": saved})
                return

            req = json.loads(self._body() or b"{}")
            if url.path == "/api/convert":
                job = JOBS.start(
                    voice_pipeline,
                    req["input_path"], req["model"], float(req.get("pitch", 0)),
                    index_rate=float(req.get("index_rate", 0.5)),
                    filter_radius=int(req.get("filter_radius", 3)),
                    volume_envelope=float(req.get("volume_envelope", 0.25)),
                    f0_method=req.get("f0_method", "rmvpe+"),
                    hop_length=int(req.get("hop_length", 128)),
                    protect=float(req.get("protect", 0.33)),
                    output_format=req.get("output_format", "wav"),
                    f0_min=float(req.get("f0_min", 50)),
                    f0_max=float(req.get("f0_max", 1100)),
                    device=self.device,
                )
                self._json({"job": job})
            elif url.path == "/api/tts":
                from ..edge_tts_conversion import edge_tts_pipeline

                job = JOBS.start(
                    edge_tts_pipeline,
                    req["text"], req["model"], req["voice"],
                    float(req.get("pitch", 0)),
                    index_rate=float(req.get("index_rate", 0.5)),
                    volume_envelope=float(req.get("volume_envelope", 0.25)),
                    f0_method=req.get("f0_method", "rmvpe+"),
                    protect=float(req.get("protect", 0.33)),
                    output_format=req.get("output_format", "wav"),
                    device=self.device,
                )
                self._json({"job": job})
            elif url.path == "/api/process":
                effect_params = {
                    k: float(req.get(k, v)) for k, v in EFFECT_DEFAULTS.items()
                }
                job = JOBS.start(
                    process_audio,
                    req["vocal_path"], req["instrumental_path"],
                    output_format=req.get("output_format", "wav"),
                    vocal_gain=float(req.get("vocal_gain", 0)),
                    instrumental_gain=float(req.get("instrumental_gain", 0)),
                    use_effects=bool(req.get("use_effects", True)),
                    **effect_params,
                )
                self._json({"job": job})
            elif url.path == "/api/install/url":
                job = JOBS.start(download_from_url, req["url"], req["name"])
                self._json({"job": job})
            elif url.path == "/api/install/zip":
                res = upload_zip_file(req["zip_path"], req["name"])
                self._json({"result": res})
            elif url.path == "/api/install/files":
                res = upload_separate_files(
                    req.get("pth_path"), req.get("index_path"), req["name"]
                )
                self._json({"result": res})
            elif url.path == "/api/install/embedder":
                job = JOBS.start(
                    download_and_replace_model,
                    req.get("preset", "hubert_base.pt"), req.get("custom_url"),
                )
                self._json({"job": job})
            else:
                self.send_error(404)
        except Exception as e:  # a bad request answers 400, the server runs on
            traceback.print_exc()
            self._json({"error": str(e)}, code=400)


def serve(port: int = 7860, host: str = "127.0.0.1", on_bound=None, device=None):
    """Serve the UI; its conversion jobs run on `device` (None: CUDA, and
    without CUDA this raises before binding; "cpu" runs them on the CPU).
    The device is set on Handler, so it holds for every server of the
    process. Binds loopback by default: pass host="0.0.0.0" only behind an
    explicit --listen opt-in, since the API accepts filesystem paths and
    installs models. `on_bound(port)` runs after the socket bound and before
    serving: the share client dials out from there, so a failed bind never
    advertises a dead port through the relay."""
    Handler.device = resolve_device(device)
    httpd = ThreadingHTTPServer((host, port), Handler)  # OSError = bind fail
    try:
        print(f"PolGen-RVC UI (PyTorch, {Handler.device}) on http://{host}:{port}")
        if on_bound is not None:
            on_bound(port)
        httpd.serve_forever()
    finally:
        # an on_bound exception must not leak a bound-but-unserved socket
        # (clients would hang in its accept backlog)
        httpd.server_close()
