"""Which process of a process group writes files. A mesh (parallel/mesh.py) runs one
process per rank; every rank calls the savers, because gathering sharded parameters is
a collective, and rank 0 alone writes. A lone process is its own writer."""

from __future__ import annotations

import torch.distributed as dist


def is_writer() -> bool:
    """Whether this process writes files: rank 0 of a process group, or a lone process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group (nothing for a lone process)."""
    if dist.is_initialized():
        dist.barrier()
