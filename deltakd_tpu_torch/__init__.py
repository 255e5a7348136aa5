"""PyTorch/CUDA port of deltakd_tpu (the JAX/TPU package beside it).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU the fused block, ``sorted_l1``, ``flash_attention``
and the fused MLP run their plain PyTorch versions.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The requested device; raises if it is CUDA and no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device
