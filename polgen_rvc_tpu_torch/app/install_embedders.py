"""Alternate HuBERT embedder installer: the port of the JAX package's
app/install_embedders.py.

Six preset embedders from the Politrees/RVC_resources hub plus custom .pt
URLs, each written to a temporary file and then atomically renamed over
the active assets/embedders/hubert_base.pt. Installing one empties the
port's converter cache, whose converters hold the old embedder's weights.
"""

from __future__ import annotations

import os
import re
import shutil
import urllib.request

from ..utils.progress import NULL_PROGRESS
from . import voice_conversion
from .voice_conversion import EMBEDDERS_DIR

BASE_URL = "https://huggingface.co/Politrees/RVC_resources/resolve/main/embedders/"

EMBEDDER_PRESETS = [
    "hubert_base.pt",
    "contentvec_base.pt",
    "korean_hubert_base.pt",
    "chinese_hubert_base.pt",
    "portuguese_hubert_base.pt",
    "japanese_hubert_base.pt",
]


def download_and_replace_model(model_name: str, custom_url: str | None = None,
                               progress=NULL_PROGRESS,
                               embedders_dir: str | None = None) -> str:
    """Fetch a preset (or custom_url, which must name a .pt file) and
    install it as hubert_base.pt. Returns a message; a bad URL or an
    unknown preset returns an error message and downloads nothing."""
    dest_dir = embedders_dir or EMBEDDERS_DIR
    os.makedirs(dest_dir, exist_ok=True)
    if custom_url:
        if not re.search(r"\.pt(\?.*)?$", custom_url):
            return "Error: the URL must point to a .pt file"
        model_url = custom_url
    else:
        if model_name not in EMBEDDER_PRESETS:
            return f"Error: unknown embedder preset {model_name}"
        model_url = BASE_URL + model_name

    tmp_path = os.path.join(dest_dir, "tmp_model.pt")
    progress(0.4, f'installing embedder "{model_name}"')
    try:
        with urllib.request.urlopen(model_url) as resp, open(tmp_path, "wb") as out:
            shutil.copyfileobj(resp, out)
        os.replace(tmp_path, os.path.join(dest_dir, "hubert_base.pt"))
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)
    # the embedder changed: the cached converters hold the old one's weights
    voice_conversion._CONVERTER_CACHE.clear()
    progress(1.0, "done")
    return f'[+] Embedder "{model_name}" installed successfully!'
