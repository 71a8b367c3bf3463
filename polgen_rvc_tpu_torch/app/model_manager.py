"""Voice-model installation: URL download / zip / separate files + CLI;
the port of the JAX package's app/model_manager.py.

Zip extraction with size-gated .pth (>40 MB) / .index (>100 KB) discovery
and folder flattening, the traversal, zip-slip and duplicate-name guards,
and the `python -m polgen_rvc_tpu_torch.app.model_manager <url> <dir>`
CLI. Host only. The models directory is relative to the working
directory, as app/voice_conversion.py reads it.
"""

from __future__ import annotations

import os
import shutil
import sys
import zipfile

from ..utils.progress import NULL_PROGRESS
from .download_source import DownloadError, download_file

RVC_MODELS_DIR = "models"


class ModelInstallError(RuntimeError):
    pass


def get_folders(models_dir: str = RVC_MODELS_DIR) -> list[str]:
    if not os.path.isdir(models_dir):
        return []
    return [
        item for item in os.listdir(models_dir)
        if os.path.isdir(os.path.join(models_dir, item))
    ]


def _safe_model_dir(models_dir: str, dir_name: str) -> str:
    """Join dir_name under models_dir, rejecting traversal — dir_name comes
    from HTTP requests, so '../x' must not escape the models directory."""
    if (not dir_name or any(sep in dir_name for sep in ("/", "\\"))
            or dir_name in (".", "..")):
        raise ModelInstallError(f"invalid model name {dir_name!r}")
    path = os.path.realpath(os.path.join(models_dir, dir_name))
    if os.path.dirname(path) != os.path.realpath(models_dir):
        raise ModelInstallError(f"invalid model name {dir_name!r}")
    return path


def extract_zip(extraction_folder: str, zip_name: str,
                *, min_pth_bytes: int = 1024 * 1024 * 40,
                min_index_bytes: int = 1024 * 100):
    """Unpack + locate model files + flatten (model_manager.py:29-78)."""
    os.makedirs(extraction_folder, exist_ok=True)
    root_real = os.path.realpath(extraction_folder)
    with zipfile.ZipFile(zip_name, "r") as zf:
        for member in zf.namelist():
            dest = os.path.realpath(os.path.join(extraction_folder, member))
            if dest != root_real and not dest.startswith(root_real + os.sep):
                raise ModelInstallError(f"zip entry escapes target: {member}")
        zf.extractall(extraction_folder)
    os.remove(zip_name)

    index_filepath = model_filepath = None
    for root, _, files in os.walk(extraction_folder):
        for name in files:
            path = os.path.join(root, name)
            if name.endswith(".index") and os.stat(path).st_size > min_index_bytes:
                index_filepath = path
            if name.endswith(".pth") and os.stat(path).st_size > min_pth_bytes:
                model_filepath = path

    if not model_filepath:
        raise ModelInstallError(
            "no .pth model file found in the unpacked zip; "
            f"check the contents of {extraction_folder}"
        )

    os.rename(
        model_filepath,
        os.path.join(extraction_folder, os.path.basename(model_filepath)),
    )
    if index_filepath:
        os.rename(
            index_filepath,
            os.path.join(extraction_folder, os.path.basename(index_filepath)),
        )
    for item in os.listdir(extraction_folder):
        full = os.path.join(extraction_folder, item)
        if os.path.isdir(full):
            shutil.rmtree(full)


def _guard_duplicate(extraction_folder: str, dir_name: str):
    if os.path.exists(extraction_folder):
        raise ModelInstallError(
            f"voice model directory {dir_name} already exists! "
            "pick a different name"
        )


def download_from_url(url: str, dir_name: str, progress=NULL_PROGRESS,
                      models_dir: str = RVC_MODELS_DIR) -> str:
    os.makedirs(models_dir, exist_ok=True)
    extraction_folder = _safe_model_dir(models_dir, dir_name)
    zip_name = extraction_folder + ".zip"
    _guard_duplicate(extraction_folder, dir_name)
    progress(0.0, f"downloading voice model {dir_name}")
    download_file(url, zip_name, progress)
    progress(0.8, "unpacking zip")
    extract_zip(extraction_folder, zip_name)
    return f"[+] Model {dir_name} installed successfully!"


def upload_zip_file(zip_path: str, dir_name: str, progress=NULL_PROGRESS,
                    models_dir: str = RVC_MODELS_DIR) -> str:
    extraction_folder = _safe_model_dir(models_dir, dir_name)
    _guard_duplicate(extraction_folder, dir_name)
    progress(0.8, "unpacking zip")
    extract_zip(extraction_folder, zip_path)
    return f"[+] Model {dir_name} installed successfully!"


def upload_separate_files(pth_file: str | None, index_file: str | None,
                          dir_name: str, progress=NULL_PROGRESS,
                          models_dir: str = RVC_MODELS_DIR) -> str:
    extraction_folder = _safe_model_dir(models_dir, dir_name)
    _guard_duplicate(extraction_folder, dir_name)
    os.makedirs(extraction_folder, exist_ok=True)
    if pth_file:
        shutil.copyfile(
            pth_file, os.path.join(extraction_folder, os.path.basename(pth_file))
        )
    if index_file:
        shutil.copyfile(
            index_file, os.path.join(extraction_folder, os.path.basename(index_file))
        )
    return f"[+] Model {dir_name} installed successfully!"


def main():
    if len(sys.argv) != 3:
        print(
            "\nUsage:\npython -m polgen_rvc_tpu_torch.app.model_manager "
            '"url" "dir_name"\n'
        )
        sys.exit(1)
    try:
        print(download_from_url(sys.argv[1], sys.argv[2]))
    except (ModelInstallError, DownloadError) as e:
        print(f"Error: {e}")
        sys.exit(1)


if __name__ == "__main__":
    main()
