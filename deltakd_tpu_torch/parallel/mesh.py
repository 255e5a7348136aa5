"""The (data, model) device mesh (``deltakd_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``('data', 'model')`` mesh: the
batch is sharded over ``data``, and over ``model`` the Megatron rules of
``_param_spec`` split the qkv and fc1 kernels on their output features and
the fc2 and attention proj kernels on their input features; XLA inserts the
collectives. The port runs one process per card (the reference's DDP
launch) with the JAX package's layout, ``ranks.reshape(mesh_shape)``
row-major: global rank ``r`` is data rank ``r // M`` and model rank
``r % M``.

``DataParallel`` is one rank's place on the data axis, the ranks of its
model column: what a step needs to make the ranks' work the JAX package's
global-batch step (the gradient all-reduce, the batch-coupled loss terms'
all-reduces, mixup's exchange with the partner rank). ``ModelParallel`` is
its place on the model axis, the ranks of its data row: the group over
which ``parallel/tensor.py``'s operators reduce the row-parallel products
and gather the shards. ``Mesh`` holds both. At world 1 every collective is
skipped; at a model axis of 1 the data axis is the default group, as it was
before the model axis existed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the data axis: ``world`` ranks, this one
    ``rank``; the collectives run on ``group`` (None: the default group),
    whose members are the global ranks ``ranks`` (None: 0 .. world - 1)."""

    world: int = 1
    rank: int = 0
    group: Any = None
    ranks: Optional[Tuple[int, ...]] = None

    @property
    def active(self) -> bool:
        return self.world > 1

    def global_rank(self, rank: int) -> int:
        """The global rank of data rank ``rank`` of this group."""
        return rank if self.ranks is None else self.ranks[rank]

    @property
    def is_main(self) -> bool:
        """Global rank 0: the one rank that logs and writes."""
        return self.global_rank(self.rank) == 0

    @property
    def partner(self) -> int:
        """The rank whose batch the global batch's flip pairs with this one's."""
        return self.world - 1 - self.rank

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced over the ranks, in place; ``t`` itself at world 1."""
        if self.active:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' mean of ``t`` (a new tensor); ``t`` at world 1."""
        if not self.active:
            return t
        return self.all_reduce(t.clone()) / self.world

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of data rank ``src``, in place."""
        if self.active:
            dist.broadcast(t, self.global_rank(src), group=self.group)
        return t

    def swap_with_partner(self, t: torch.Tensor) -> torch.Tensor:
        """The partner rank's ``t`` (same shape and dtype on every rank): one
        all_to_all_single that sends all of ``t`` to the partner and nothing
        to the others. The middle rank of an odd world is its own partner."""
        if not self.active:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        splits = [t.shape[0] if r == self.partner else 0 for r in range(self.world)]
        dist.all_to_all_single(out, t, splits, splits, group=self.group)
        return out


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """This process's place in the model axis: ``size`` ranks holding the
    shards of one replica, this one ``rank``; the collectives run on
    ``group``."""

    size: int = 1
    rank: int = 0
    group: Any = None

    @property
    def active(self) -> bool:
        return self.size > 1

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model ranks, in place."""
        if self.active:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> list:
        """Every model rank's ``t`` (same shape on each), by model rank."""
        if not self.active:
            return [t]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return out


LOCAL = DataParallel()
NO_MODEL = ModelParallel()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, model) mesh as this rank sees it: ``shape`` as checked
    (at one rank it only picks the model path), the data axis ``data`` and
    the model axis ``model``."""

    shape: Tuple[int, int]
    data: DataParallel = LOCAL
    model: ModelParallel = NO_MODEL

    @property
    def world(self) -> int:
        return self.data.world * self.model.size

    @property
    def rank(self) -> int:
        """This process's global rank (row-major over (data, model))."""
        return self.data.rank * self.model.size + self.model.rank

    @property
    def is_main(self) -> bool:
        """Global rank 0: the one rank that logs and writes."""
        return self.data.is_main and self.model.rank == 0

    def barrier(self) -> None:
        """Every rank of the mesh."""
        if self.world > 1:
            dist.barrier()

    def any_rank(self, flag: bool, device) -> bool:
        """Whether ``flag`` is set on any rank of the mesh (a MAX all-reduce of
        one value on ``device``)."""
        if self.world == 1:
            return flag
        t = torch.tensor([float(flag)], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


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


def mesh_shape(shape: Optional[Sequence[int]], world_size: int) -> Tuple[int, int]:
    """The (data, model) axis sizes of ``shape`` over ``world_size`` ranks,
    with the JAX package's check: under more than one rank the shape must
    cover exactly the ranks. None puts every rank on the data axis; one
    number is the data axis."""
    if shape is None:
        return world_size, 1
    shape = tuple(int(n) for n in shape)
    if len(shape) == 1:
        shape = (shape[0], 1)
    if world_size > 1 and math.prod(shape) != world_size:
        raise ValueError(f"mesh shape {shape} != {world_size} devices")
    return shape


def make_mesh(shape: Optional[Sequence[int]] = None,
              dp: Optional[DataParallel] = None) -> Mesh:
    """The mesh of ``shape`` over ``dp``'s ranks (default: the current
    process group). At one rank ``shape`` only picks the model path
    (``models.factory``); with a model axis of 1 the data axis is ``dp``.
    With a model axis M > 1 every rank creates, in the same order, the data
    group of each model column (global ranks m, m + M, ...) and the model
    group of each data row (d M .. d M + M - 1), and keeps its own two."""
    dp = dp or current()
    D, M = mesh_shape(shape, dp.world)
    if dp.world == 1:
        return Mesh((D, M))
    if M == 1:
        return Mesh((D, M), dp)
    columns = [tuple(d * M + m for d in range(D)) for m in range(M)]
    rows = [tuple(d * M + m for m in range(M)) for d in range(D)]
    data_groups = [dist.new_group(list(ranks)) for ranks in columns]
    model_groups = [dist.new_group(list(ranks)) for ranks in rows]
    d, m = divmod(dp.rank, M)
    return Mesh((D, M), DataParallel(D, d, data_groups[m], columns[m]),
                ModelParallel(M, m, model_groups[d]))


def param_spec(name: str, tensor) -> Optional[str]:
    """The JAX package's ``_param_spec`` on the port's parameter names (an
    nn.Linear weight is the [out, in] transpose of a Flax kernel):
    'column' where the output features are split (the qkv and fc1 weights,
    dim 0), 'row' where the input features are (the fc2 and attention proj
    weights, dim 1), None where the tensor is replicated (everything below
    2-D, patch_embed's proj, the heads, the aux heads). ``tensor`` may be
    a shape."""
    if len(getattr(tensor, "shape", tensor)) < 2:
        return None
    parts = name.split(".")
    if ("qkv" in parts or "fc1" in parts) and "weight" in parts:
        return "column"
    if ("fc2" in parts or ("attn" in name and "proj" in parts)) and "weight" in parts:
        return "row"
    return None
