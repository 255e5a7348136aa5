"""Startup probes (``deltakd_tpu/obs/profiling.py``): the parameter count,
the forward GFLOPs and the inference throughput of the startup banner
(reference tools/train.py:230-241, tools/utils.py:162-180)."""

from __future__ import annotations

import math
import time

import torch


def count_params(model: torch.nn.Module) -> float:
    """Parameters in millions: the whole model's, where a parameter is one
    rank's shard over a model axis (``parallel.tensor.shard_parameters``)."""
    def numel(p):
        shard = getattr(p, "model_shard", None)
        return p.numel() if shard is None else math.prod(shard.full_shape)

    return sum(numel(p) for p in model.parameters()) / 1e6


@torch.no_grad()
def model_gflops(model, input_size: int) -> float:
    """Forward GFLOPs per image, counted by ``FlopCounterMode`` on the plain
    PyTorch path of a model of ``model``'s configuration on the meta device
    (shapes alone: a kernel launched through ctypes is invisible to the
    counter, and a model whose parameters are one rank's shards counts as
    the whole model, with no collective)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        plain = type(model)(model.cfg, dtype=model.dtype, collect_features=False)
        x = torch.zeros(1, input_size, input_size, 3)
    counter = FlopCounterMode(display=False)
    with counter:
        plain(x, train=False)
    return counter.get_total_flops() / 1e9


@torch.no_grad()
def measure_throughput(model, *, batch_size: int = 64, input_size: int = 224,
                       num_batches: int = 10) -> float:
    """Images per second of inference, one warm-up batch outside the timer;
    on the card the timer is closed by a synchronize."""
    device = model.pos_embed.device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    x = torch.zeros(batch_size, input_size, input_size, 3, device=device)
    model(x, train=False)
    sync()
    start = time.perf_counter()
    for _ in range(num_batches):
        model(x, train=False)
    sync()
    return batch_size * num_batches / (time.perf_counter() - start)
