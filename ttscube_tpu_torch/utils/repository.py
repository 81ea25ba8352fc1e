"""Model volumes: the port's counterpart of `ttscube_tpu/utils/repository.py`, with
`split_volumes` only (the exporter's). Downloading is not ported."""

from __future__ import annotations


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
