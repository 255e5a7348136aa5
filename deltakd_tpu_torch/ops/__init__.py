"""The port's ops: each module holds a function's plain PyTorch version, the
wrappers of its hand-written CUDA kernels and the dispatch between them."""

import torch


def on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    version); raises for any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no implementation for device {t.device}")
    return t.device.type == "cuda"


def current_stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_entry(name: str, t: torch.Tensor) -> str:
    """The entry point of kernel ``name`` for ``t``'s dtype: its fp32 form is
    ``<name>_f32``."""
    return f"{name}_f32" if t.dtype == torch.float32 else name
