"""Process-group start-up (``deltakd_tpu/parallel/distributed.py``).

The reference launches one process per card with torchrun and initialises
NCCL from its environment (reference tools/utils.py:23-65): ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK``, a 1800 s timeout. The JAX package's
counterpart starts ``jax.distributed`` on a multi-host pod; the port starts
the process group the reference starts.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=1800)


def maybe_initialize_distributed(device_type: str = "cuda") -> bool:
    """Join the process group that torchrun's environment describes: select
    card ``LOCAL_RANK`` and initialise NCCL (gloo for ``device_type`` 'cpu').
    A group that already exists is used as it is, whatever its backend;
    without torchrun's variables this does nothing. Returns whether a process
    group is up."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo", timeout=TIMEOUT)
    return True


def rank_device(device: torch.device) -> torch.device:
    """Join torchrun's process group (``maybe_initialize_distributed``) and
    return this rank's device: a bare 'cuda' becomes the card it selected."""
    maybe_initialize_distributed(device.type)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
