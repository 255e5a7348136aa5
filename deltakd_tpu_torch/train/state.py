"""Train state (``deltakd_tpu/train/state.py``): the trainable parameters as
one flat fp32 vector, the optimizer state (``train/optim.py``: AdamW's or
Adam's moments or SGD's trace over the same vector, and the LR scale where
the optimizer has one) and an optional EMA copy.

``TrainState`` rebinds every trainable parameter of the student (and of the
aux heads, when a KD objective has any) to a view into ``params``, so the
module computes with the vector that the fused optimizer updates in place.
Under tensor parallelism the student's parameters are this rank's shards,
so the vector, the optimizer's buffers and the EMA hold them, and
``shards`` (``parallel.tensor.FlatShards``) maps them to the full layout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from deltakd_tpu_torch.parallel.tensor import FlatShards


def trainable_parameters(student: nn.Module, aux: Optional[nn.Module] = None
                         ) -> List[Tuple[str, nn.Parameter]]:
    """(name, parameter) pairs in the flat vector's order; the optimizer's
    decay mask is built from the same list."""
    named = [(f"student.{n}", p) for n, p in student.named_parameters()]
    if aux is not None:
        named += [(f"aux.{n}", p) for n, p in aux.named_parameters()]
    return named


class TrainState:
    def __init__(self, student: nn.Module, *, tx, aux: Optional[nn.Module] = None,
                 ema_decay: Optional[float] = None):
        self.named_params = trainable_parameters(student, aux)
        self.params = torch.cat([p.detach().float().reshape(-1)
                                 for _, p in self.named_params])
        offset = 0
        for _, p in self.named_params:
            n = p.numel()
            p.data = self.params[offset:offset + n].view_as(p)
            offset += n
        self.shards = FlatShards.of(self.named_params)   # None without a model axis
        self.step = 0
        self.opt_state = tx.init(self.params)
        self.ema_params = self.params.clone() if ema_decay else None

    def parameters(self) -> List[nn.Parameter]:
        return [p for _, p in self.named_params]

    def apply_gradients(self, *, grads: torch.Tensor, tx,
                        ema_decay: Optional[float] = None) -> None:
        """One optimizer step on the flat ``grads``, in place; then the timm
        ModelEma update ema = decay*ema + (1-decay)*params."""
        tx.update(grads, self.opt_state, self.params)
        if self.ema_params is not None and ema_decay:
            self.ema_params.mul_(ema_decay).add_(self.params, alpha=1.0 - ema_decay)
        self.step += 1
