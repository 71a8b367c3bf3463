"""Per-host model downloaders: a copy of the JAX package's
app/download_source.py.

Hosts: Google Drive, HuggingFace, Pixeldrain, Yandex Disk, Mega. Drive
is a direct requests flow (confirm-token dance), Mega a first-party client
(public-file API handshake + AES-CTR stream decryption), the rest plain
HTTP. All need the network at call time. ``requests`` and
``cryptography`` are imported inside the functions that use them, so
model_manager (which imports this module) loads where neither is
installed; the Mega URL parsing, key folding and attribute decryption are
tested offline (tests/test_torch_model_manager.py).
"""

from __future__ import annotations

import os
import re
import urllib.request

from ..utils.progress import NULL_PROGRESS


class DownloadError(RuntimeError):
    pass


def _stream_to_file(resp, path, progress=NULL_PROGRESS, label="downloading"):
    total = int(resp.headers.get("content-length", 0) or 0)
    done = 0
    with open(path, "wb") as f:
        for chunk in resp.iter_content(chunk_size=1 << 20):
            f.write(chunk)
            done += len(chunk)
            if total:
                progress(min(0.79, 0.1 + 0.6 * done / total), label)


def download_gdrive(url: str, zip_path: str, progress=NULL_PROGRESS):
    """Google Drive public file (gdown-equivalent confirm-token flow)."""
    m = re.search(r"(?:/d/|id=)([\w-]+)", url)
    if not m:
        raise DownloadError(f"cannot parse Google Drive id from {url}")
    file_id = m.group(1)
    import requests

    session = requests.Session()
    resp = session.get(
        "https://drive.usercontent.google.com/download",
        params={"id": file_id, "export": "download", "confirm": "t"},
        stream=True, timeout=60,
    )
    if "text/html" in resp.headers.get("content-type", ""):
        html = resp.text
        token = re.search(r'name="confirm" value="([^"]+)"', html)
        uuid_f = re.search(r'name="uuid" value="([^"]+)"', html)
        params = {"id": file_id, "export": "download"}
        if token:
            params["confirm"] = token.group(1)
        if uuid_f:
            params["uuid"] = uuid_f.group(1)
        resp = session.get(
            "https://drive.usercontent.google.com/download",
            params=params, stream=True, timeout=60,
        )
    resp.raise_for_status()
    _stream_to_file(resp, zip_path, progress)


def download_huggingface(url: str, zip_path: str, progress=NULL_PROGRESS):
    urllib.request.urlretrieve(url.replace("/blob/", "/resolve/"), zip_path)


def download_pixeldrain(url: str, zip_path: str, progress=NULL_PROGRESS):
    import requests

    file_id = url.rstrip("/").split("/")[-1]
    resp = requests.get(
        f"https://pixeldrain.com/api/file/{file_id}", stream=True, timeout=60
    )
    resp.raise_for_status()
    _stream_to_file(resp, zip_path, progress)


def download_yandex(url: str, zip_path: str, progress=NULL_PROGRESS):
    import requests

    api = (
        "https://cloud-api.yandex.net/v1/disk/public/resources/download"
        f"?public_key={requests.utils.quote(url)}"
    )
    meta = requests.get(api, timeout=60)
    meta.raise_for_status()
    href = meta.json()["href"]
    resp = requests.get(href, stream=True, timeout=60)
    resp.raise_for_status()
    _stream_to_file(resp, zip_path, progress)


# -- Mega (first-party client; replaces mega.py) ----------------------------
#
# Public-file protocol (reference used mega.py, download_source.py:44-57):
#   1. URL carries the file handle + a base64url 32-byte node key
#      (new style  mega.nz/file/<handle>#<key>,
#       old style  mega.nz/#!<handle>!<key>)
#   2. The AES-128 file key = XOR of the node key's two 16-byte halves;
#      bytes 16..24 are the CTR nonce (IV), 24..32 the meta-MAC.
#   3. POST https://g.api.mega.co.nz/cs  [{"a":"g","g":1,"p":<handle>}]
#      returns the download URL, size, and encrypted attributes.
#   4. Attributes decrypt with AES-CBC (zero IV) to b'MEGA{"n":<name>,...}'.
#   5. The payload decrypts with AES-CTR, counter = nonce || block index.


def _b64url_decode(s: str) -> bytes:
    import base64

    s = s.replace("-", "+").replace("_", "/").rstrip(",")
    return base64.b64decode(s + "=" * (-len(s) % 4))


def parse_mega_url(url: str) -> tuple[str, bytes]:
    """-> (file handle, 32-byte node key)."""
    m = re.search(r"mega(?:\.co)?\.nz/file/([\w-]+)#([\w,_-]+)", url)
    if not m:
        m = re.search(r"mega(?:\.co)?\.nz/#!([\w-]+)!([\w,_-]+)", url)
    if not m:
        raise DownloadError(f"cannot parse Mega file URL: {url}")
    handle, key_b64 = m.group(1), m.group(2)
    key = _b64url_decode(key_b64)
    if len(key) != 32:
        raise DownloadError(
            f"Mega node key must be 32 bytes, got {len(key)} (folder link?)"
        )
    return handle, key


def mega_file_key(node_key: bytes) -> tuple[bytes, bytes]:
    """32-byte node key -> (16-byte AES key, 8-byte CTR nonce)."""
    k = bytes(a ^ b for a, b in zip(node_key[:16], node_key[16:]))
    return k, node_key[16:24]


def mega_decrypt_attributes(at_b64: str, key: bytes) -> dict:
    """Decrypt the 'at' attribute block -> {"n": filename, ...}."""
    import json

    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    data = _b64url_decode(at_b64)
    dec = Cipher(algorithms.AES(key), modes.CBC(b"\0" * 16)).decryptor()
    plain = dec.update(data) + dec.finalize()
    if not plain.startswith(b"MEGA"):
        raise DownloadError("Mega attribute decryption failed (bad key?)")
    return json.loads(plain[4:].rstrip(b"\0").decode("utf-8", "replace"))


def mega_ctr_decryptor(key: bytes, nonce: bytes):
    """Streaming AES-CTR decryptor positioned at byte 0."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    return Cipher(
        algorithms.AES(key), modes.CTR(nonce + b"\0" * 8)
    ).decryptor()


def mega_api_request(handle: str, session=None) -> dict:
    """g-command: resolve a public handle to (download url, size, attrs)."""
    if session is None:
        import requests as session
    resp = session.post(
        "https://g.api.mega.co.nz/cs",
        params={"id": 0},
        json=[{"a": "g", "g": 1, "p": handle}],
        timeout=60,
    )
    resp.raise_for_status()
    body = resp.json()
    if isinstance(body, int) or (isinstance(body, list) and isinstance(body[0], int)):
        code = body if isinstance(body, int) else body[0]
        raise DownloadError(f"Mega API error {code} for handle {handle}")
    info = body[0]
    if "g" not in info:
        raise DownloadError(f"Mega file {handle} is not directly downloadable")
    return info


def download_mega(url: str, zip_path: str, progress=NULL_PROGRESS,
                  session=None):
    handle, node_key = parse_mega_url(url)
    key, nonce = mega_file_key(node_key)
    info = mega_api_request(handle, session=session)
    if "at" in info:  # verify the key before streaming the body
        mega_decrypt_attributes(info["at"], key)
    total = int(info.get("s", 0) or 0)
    if session is None:
        import requests as session
    resp = session.get(info["g"], stream=True, timeout=60)
    resp.raise_for_status()
    dec = mega_ctr_decryptor(key, nonce)
    done = 0
    with open(zip_path, "wb") as f:
        for chunk in resp.iter_content(chunk_size=1 << 20):
            f.write(dec.update(chunk))
            done += len(chunk)
            if total:
                progress(min(0.79, 0.1 + 0.6 * done / total), "downloading (mega)")
        f.write(dec.finalize())


def download_file(url: str, zip_path: str, progress=NULL_PROGRESS):
    """Dispatch by host (reference download_source.py:9-78)."""
    try:
        if "drive.google.com" in url:
            download_gdrive(url, zip_path, progress)
        elif "huggingface.co" in url:
            download_huggingface(url, zip_path, progress)
        elif "pixeldrain.com" in url:
            download_pixeldrain(url, zip_path, progress)
        elif "mega.nz" in url:
            download_mega(url, zip_path, progress)
        elif "disk.yandex" in url:
            download_yandex(url, zip_path, progress)
        else:  # direct link
            import requests

            resp = requests.get(url, stream=True, timeout=60)
            resp.raise_for_status()
            _stream_to_file(resp, zip_path, progress)
    except DownloadError:
        raise
    except Exception as e:
        raise DownloadError(f"download failed for {url}: {e}") from e
