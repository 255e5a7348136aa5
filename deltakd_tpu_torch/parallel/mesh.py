"""Data parallelism (``deltakd_tpu/parallel/mesh.py``).

The JAX package shards the batch over the ``data`` axis of a device mesh
and XLA inserts the gradient all-reduce. The port runs one process per card
(the reference's DDP launch): each rank holds a replica of the parameters
and its local batch, and ``DataParallel`` is what a step needs to make the
ranks' work the JAX package's global-batch step: the gradient all-reduce,
the batch-coupled loss terms' all-reduces, and mixup's exchange with the
partner rank. At world 1 every collective is skipped.

Tensor parallelism (the JAX package's ``model`` axis) is not ported: a
model axis > 1 under more than one rank raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the data axis: ``world`` ranks, this one
    ``rank``; the collectives run on the default process group."""

    world: int = 1
    rank: int = 0

    @property
    def active(self) -> bool:
        return self.world > 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def partner(self) -> int:
        """The rank whose batch the global batch's flip pairs with this one's."""
        return self.world - 1 - self.rank

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the ranks, in place; ``t`` itself at world 1."""
        if self.active:
            dist.all_reduce(t, op=op)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``t`` (a new tensor); ``t`` at world 1."""
        if not self.active:
            return t
        return self.all_reduce(t.clone()) / self.world

    def any_rank(self, flag: bool, device) -> bool:
        """Whether ``flag`` is set on any rank (a MAX all-reduce of one value
        on ``device``)."""
        if not self.active:
            return flag
        t = torch.tensor([float(flag)], device=device)
        return bool(self.all_reduce(t, op=dist.ReduceOp.MAX).item())

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self.active:
            dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self.active:
            dist.barrier()

    def swap_with_partner(self, t: torch.Tensor) -> torch.Tensor:
        """The partner rank's ``t`` (same shape and dtype on every rank): one
        all_to_all_single that sends all of ``t`` to the partner and nothing
        to the others. The middle rank of an odd world is its own partner."""
        if not self.active:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        splits = [t.shape[0] if r == self.partner else 0 for r in range(self.world)]
        dist.all_to_all_single(out, t, splits, splits)
        return out


LOCAL = DataParallel()


def current() -> DataParallel:
    """The default process group as a ``DataParallel``; ``LOCAL`` without one."""
    if dist.is_available() and dist.is_initialized():
        return DataParallel(dist.get_world_size(), dist.get_rank())
    return LOCAL


def world() -> int:
    return current().world


def rank() -> int:
    return current().rank


def is_main_process() -> bool:
    """Rank-0 gating (reference train.py:221,230,243)."""
    return current().is_main


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              dp: Optional[DataParallel] = None) -> Tuple[int, int]:
    """The (data, model) axis sizes for ``mesh_shape`` over ``dp``'s ranks
    (default: the current process group), with the JAX package's check:
    under more than one rank the shape must cover exactly the ranks. At one
    rank ``mesh_shape`` only picks the model path (``models.factory``)."""
    dp = dp or current()
    if mesh_shape is None:
        return dp.world, 1
    shape = tuple(int(n) for n in mesh_shape)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if dp.world == 1:
        return shape
    if math.prod(shape) != dp.world:
        raise ValueError(f"mesh shape {shape} != {dp.world} devices")
    if shape[1] > 1:
        raise NotImplementedError(
            f"mesh shape {shape}: a model axis over several ranks is tensor "
            f"parallelism, which the port does not have yet (ROADMAP.md, "
            f"Queue 1: parallelism)")
    return shape
