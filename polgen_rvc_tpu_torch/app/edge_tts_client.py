"""Minimal Microsoft Edge neural-TTS client (stdlib only): a copy of the
JAX package's app/edge_tts_client.py.

A self-contained RFC6455 websocket client speaking the public Edge
read-aloud protocol: speech.config + SSML request over WSS, binary frames
carrying "Path:audio" payloads concatenated into the output file (mp3).

Network access is required at call time; offline, the connect raises. The
frame codec and the SSML and message builders are pure and tested offline.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import json
import os
import secrets
import socket
import ssl
import struct
import uuid
from xml.sax.saxutils import escape

TRUSTED_CLIENT_TOKEN = "6A5AA1D4EAFF4E9FB37E23D68491D6F4"
WSS_HOST = "speech.platform.bing.com"
WSS_PATH = (
    "/consumer/speech/synthesize/readaloud/edge/v1"
    f"?TrustedClientToken={TRUSTED_CLIENT_TOKEN}"
)
AUDIO_FORMAT = "audio-24khz-48kbitrate-mono-mp3"
CHROME_VERSION = "130.0.2849.68"


# ---------------------------------------------------------------------------
# protocol builders (pure, unit-testable)
# ---------------------------------------------------------------------------


def sec_ms_gec() -> str:
    """Anti-abuse token: SHA256 of (windows-ticks rounded to 5 min + token)."""
    epoch = datetime.datetime(1601, 1, 1, tzinfo=datetime.timezone.utc)
    now = datetime.datetime.now(datetime.timezone.utc)
    ticks = int((now - epoch).total_seconds())
    ticks -= ticks % 300
    data = f"{ticks * 10_000_000}{TRUSTED_CLIENT_TOKEN}"
    return hashlib.sha256(data.encode("ascii")).hexdigest().upper()


def _timestamp() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%a %b %d %Y %H:%M:%S GMT+0000 (Coordinated Universal Time)"
    )


def build_ssml(text: str, voice: str, rate: str = "+0%", volume: str = "+0%",
               pitch: str = "+0Hz") -> str:
    return (
        "<speak version='1.0' xmlns='http://www.w3.org/2001/10/synthesis' "
        "xml:lang='en-US'>"
        f"<voice name='{voice}'>"
        f"<prosody pitch='{pitch}' rate='{rate}' volume='{volume}'>"
        f"{escape(text)}</prosody></voice></speak>"
    )


def build_config_message() -> str:
    config = {
        "context": {
            "synthesis": {
                "audio": {
                    "metadataoptions": {
                        "sentenceBoundaryEnabled": "false",
                        "wordBoundaryEnabled": "true",
                    },
                    "outputFormat": AUDIO_FORMAT,
                }
            }
        }
    }
    return (
        "X-Timestamp:" + _timestamp() + "\r\n"
        "Content-Type:application/json; charset=utf-8\r\n"
        "Path:speech.config\r\n\r\n"
        + json.dumps(config) + "\r\n"
    )


def build_ssml_message(request_id: str, ssml: str) -> str:
    return (
        f"X-RequestId:{request_id}\r\n"
        "Content-Type:application/ssml+xml\r\n"
        f"X-Timestamp:{_timestamp()}Z\r\n"
        "Path:ssml\r\n\r\n"
        + ssml
    )


def parse_binary_frame(payload: bytes) -> tuple[dict, bytes]:
    """Binary message: u16 header length + ascii headers + audio bytes."""
    header_len = struct.unpack(">H", payload[:2])[0]
    header_text = payload[2 : 2 + header_len].decode("utf-8", "replace")
    headers = {}
    for line in header_text.split("\r\n"):
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip()] = v.strip()
    return headers, payload[2 + header_len :]


# ---------------------------------------------------------------------------
# RFC6455 websocket framing (client side, masked)
# ---------------------------------------------------------------------------


def encode_ws_frame(opcode: int, payload: bytes) -> bytes:
    out = bytearray([0x80 | opcode])
    n = len(payload)
    if n < 126:
        out.append(0x80 | n)
    elif n < 1 << 16:
        out.append(0x80 | 126)
        out += struct.pack(">H", n)
    else:
        out.append(0x80 | 127)
        out += struct.pack(">Q", n)
    mask = secrets.token_bytes(4)
    out += mask
    out += bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return bytes(out)


def read_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket closed mid-frame")
        buf += chunk
    return buf


def decode_ws_frame(sock) -> tuple[int, bytes]:
    """Read one (unmasked, server->client) frame: (opcode, payload)."""
    h = read_exact(sock, 2)
    opcode = h[0] & 0x0F
    length = h[1] & 0x7F
    if length == 126:
        length = struct.unpack(">H", read_exact(sock, 2))[0]
    elif length == 127:
        length = struct.unpack(">Q", read_exact(sock, 8))[0]
    if h[1] & 0x80:  # masked server frame (nonstandard)
        mask = read_exact(sock, 4)
        data = read_exact(sock, length)
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    else:
        payload = read_exact(sock, length)
    return opcode, payload


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


def synthesize(text: str, voice: str, output_path: str, *,
               rate: str = "+0%", volume: str = "+0%",
               timeout: float = 30.0) -> str:
    """text + voice -> mp3 file (reference text_to_speech semantics)."""
    ctx = ssl.create_default_context()
    raw = socket.create_connection((WSS_HOST, 443), timeout=timeout)
    sock = ctx.wrap_socket(raw, server_hostname=WSS_HOST)
    try:
        ws_key = base64.b64encode(secrets.token_bytes(16)).decode()
        path = (
            f"{WSS_PATH}&Sec-MS-GEC={sec_ms_gec()}"
            f"&Sec-MS-GEC-Version=1-{CHROME_VERSION}"
            f"&ConnectionId={uuid.uuid4().hex}"
        )
        handshake = (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {WSS_HOST}\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {ws_key}\r\n"
            "Sec-WebSocket-Version: 13\r\n"
            "Pragma: no-cache\r\n"
            "Cache-Control: no-cache\r\n"
            "Origin: chrome-extension://jdiccldimpdaibmpdkjnbmckianbfold\r\n"
            f"User-Agent: Mozilla/5.0 (Windows NT 10.0; Win64; x64) "
            f"AppleWebKit/537.36 (KHTML, like Gecko) "
            f"Chrome/{CHROME_VERSION.split('.')[0]}.0.0.0 Safari/537.36\r\n"
            "\r\n"
        )
        sock.sendall(handshake.encode())
        response = b""
        while b"\r\n\r\n" not in response:
            response += sock.recv(4096)
        status = response.split(b"\r\n", 1)[0].decode()
        if "101" not in status:
            raise ConnectionError(f"websocket handshake failed: {status}")

        sock.sendall(encode_ws_frame(0x1, build_config_message().encode()))
        req_id = uuid.uuid4().hex
        sock.sendall(
            encode_ws_frame(0x1, build_ssml_message(req_id, build_ssml(
                text, voice, rate=rate, volume=volume)).encode())
        )

        audio = bytearray()
        while True:
            opcode, payload = decode_ws_frame(sock)
            if opcode == 0x8:  # close
                break
            if opcode == 0x1:  # text
                if "Path:turn.end" in payload.decode("utf-8", "replace"):
                    break
            elif opcode == 0x2:  # binary
                headers, data = parse_binary_frame(payload)
                if headers.get("Path") == "audio":
                    audio += data
        if not audio:
            raise RuntimeError("edge-tts returned no audio")
        with open(output_path, "wb") as f:
            f.write(bytes(audio))
        return output_path
    finally:
        sock.close()
