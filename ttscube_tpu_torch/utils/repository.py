"""Model volumes: the port's counterpart of `ttscube_tpu/utils/repository.py`.

`split_volumes` cuts an export's tar.gz into `model-NN` volumes; `download_model`
fetches a named voice's volumes, joins them and unpacks the archive. It reads URLs with
the standard library's `urllib.request`, so a `file://` base serves volumes from a local
directory."""

from __future__ import annotations

import os
import shutil
import tarfile
import urllib.request

DOWNLOAD_BASE = "https://github.com/tiberiu44/TTS-Cube-Models/raw/main/models/{0}/model"
MAX_VOLUMES = 20


def _download_file(url: str, filename: str) -> None:
    """Copy `url` to `filename`; raises where it cannot be read."""
    with urllib.request.urlopen(url) as r, open(filename, "wb") as fp:
        shutil.copyfileobj(r, fp, 1 << 20)


def download_model(local_path: str, model: str, download_base: str | None = None) -> None:
    """Fetch the volumes `{base}-00` … `{base}-19` of `model` (`base` is
    `download_base` or DOWNLOAD_BASE, formatted with the model's name) into
    `local_path`, stopping at the first that cannot be read; join them, unpack the
    tar.gz there and delete the volumes. Raises RuntimeError where there is no volume."""
    base = (download_base or DOWNLOAD_BASE).format(model)
    file_list = []
    for i in range(MAX_VOLUMES):
        target = os.path.join(local_path, f"model-{i:02d}")
        try:
            _download_file(f"{base}-{i:02d}", target)
        except Exception:
            if os.path.exists(target):
                os.unlink(target)
            break
        file_list.append(target)
    if not file_list:
        raise RuntimeError(f"no model volumes found for {model}")

    combined = os.path.join(local_path, "model")
    with open(combined, "wb") as out:
        for f in file_list:
            with open(f, "rb") as src:
                shutil.copyfileobj(src, out, 1 << 20)
    with tarfile.open(combined, "r:gz") as tar:
        tar.extractall(local_path, filter="data")
    for f in file_list:
        os.unlink(f)
    os.unlink(combined)


def split_volumes(tar_path: str, output_base: str, chunk_size: int = 49 * 1024 * 1024) -> int:
    """Split a tar.gz into `{output_base}-NN` volumes of `chunk_size` bytes; returns how
    many."""
    count = 0
    with open(tar_path, "rb") as src:
        while True:
            chunk = src.read(chunk_size)
            if not chunk:
                break
            with open(f"{output_base}-{count:02d}", "wb") as out:
                out.write(chunk)
            count += 1
    return count
