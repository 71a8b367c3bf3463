"""Predictor and embedder bootstrap: the port of the JAX package's
app/download_assets.py.

Fetches rmvpe.pt, fcpe.pt and hubert_base.pt from the Politrees/RVC_resources
hub into the asset layout the port's pipelines read (paths relative to the
working directory, as app/voice_conversion.py's). Files already present
are skipped. Network required:

    python -m polgen_rvc_tpu_torch.app.download_assets
"""

from __future__ import annotations

import os
import urllib.request

from .voice_conversion import EMBEDDERS_DIR, PREDICTORS_DIR

RVC_DOWNLOAD_LINK = "https://huggingface.co/Politrees/RVC_resources/resolve/main/"

ASSETS = {
    os.path.join(PREDICTORS_DIR, "rmvpe.pt"): "predictors/rmvpe.pt",
    os.path.join(PREDICTORS_DIR, "fcpe.pt"): "predictors/fcpe.pt",
    os.path.join(EMBEDDERS_DIR, "hubert_base.pt"): "embedders/hubert_base.pt",
}


def dl_model(link: str, remote_name: str, dest_path: str):
    """Download link + remote_name to dest_path through a temporary file,
    so that a cut download leaves no file that a later run would skip."""
    os.makedirs(os.path.dirname(dest_path), exist_ok=True)
    tmp_path = f"{dest_path}.part"
    try:
        with urllib.request.urlopen(f"{link}{remote_name}") as resp:
            with open(tmp_path, "wb") as f:
                while chunk := resp.read(1 << 20):
                    f.write(chunk)
        os.replace(tmp_path, dest_path)
    finally:
        if os.path.exists(tmp_path):
            os.remove(tmp_path)


def main():
    for dest, remote in ASSETS.items():
        if os.path.exists(dest):
            print(f"[=] {os.path.basename(dest)} already present")
            continue
        print(f"[~] downloading {remote}...")
        dl_model(RVC_DOWNLOAD_LINK, remote, dest)
    print("[+] all assets ready")


if __name__ == "__main__":
    main()
