"""Auxiliary distillation heads (``deltakd_tpu/kd/aux.py``): the align layers,
the mask token and the conv3x3-ReLU-conv3x3 generation head that the
feature-KD objectives train beside the student.

``AuxHeads`` is the counterpart of ``init_aux_params``: one module per
distillation type whose parameter names keep the JAX tree's keys
(``align_wasskd.0``, ``align2.1``, ``align``, ``mask_token``,
``generation.conv1``), with nn.Linear / nn.Conv2d layouts (``weight`` [out, in]
and OIHW for the JAX ``kernel`` [in, out] and HWIO). Initialisation follows
the torch defaults the reference relies on: weights and biases from
U(-1/sqrt(fan_in), 1/sqrt(fan_in)), ``mask_token`` zero.

The functions keep the JAX package's layouts at their boundary: ``conv3x3``
and ``generation_apply`` take and return NHWC grids.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

PORTED_TYPES = ("wasskd", "mgd", "vitkd")
_LATER_TYPES = ("lrkd", "diffkd", "curkd", "saliency_mgd")


def dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel + bias in the dtype of ``x``."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def conv3x3(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """3x3 same-padding convolution on an NHWC grid, in the dtype of ``x``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), layer.weight.to(x.dtype),
                 layer.bias.to(x.dtype), padding=1)
    return y.permute(0, 2, 3, 1)


class Generation(nn.Module):
    """conv3x3 -> ReLU -> conv3x3 over ``dim`` channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)


def generation_apply(gen: Generation, x: torch.Tensor) -> torch.Tensor:
    return conv3x3(gen.conv2, F.relu(conv3x3(gen.conv1, x)))


class AuxHeads(nn.Module):
    """The aux heads of one distillation type, drawn from ``generator``."""

    def __init__(self, distillation_type: str, student_dim: int, teacher_dim: int,
                 generator: torch.Generator):
        super().__init__()
        t = distillation_type.lower()
        if t in _LATER_TYPES:
            raise NotImplementedError(
                f"the aux heads of '{t}' are not ported yet (wasskd, mgd and vitkd are)")
        if t not in PORTED_TYPES:
            raise ValueError(f"distillation type '{t}' has no aux heads")

        def align():
            return nn.Linear(student_dim, teacher_dim)

        if t == "wasskd":
            self.align_wasskd = nn.ModuleList(align() for _ in range(3))
        else:
            if t == "vitkd":
                self.align2 = nn.ModuleList(align() for _ in range(2))
            self.align = align()
            self.mask_token = nn.Parameter(torch.zeros(1, 1, teacher_dim))
            self.generation = Generation(teacher_dim)
        self._torch_default_init(generator)

    def _torch_default_init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())   # 1/sqrt(fan_in)
                    for p in (m.weight, m.bias):
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                              generator=generator))
