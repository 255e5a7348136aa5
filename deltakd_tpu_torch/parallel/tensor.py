"""Tensor parallelism over the model axis: the Megatron operators and the
shard layout (the JAX package has no counterpart: XLA partitions its
unfused model by ``_param_spec`` and inserts the collectives).

The operators, each a ``torch.autograd.Function`` on the model group
(``parallel.mesh.ModelParallel``):

* ``copy_to_model``: identity forward, all-reduce of the gradient backward
  (the replicated input of a column-parallel product);
* ``reduce_from_model``: all-reduce forward, identity backward (the partial
  outputs of a row-parallel product);
* ``gather_from_model``: all-gather of the ranks' chunks along the last dim
  forward, reduce-scatter of the gradient backward (an all-reduce, then
  this rank's chunk: gloo has no reduce-scatter of CUDA tensors);
* ``shard_of``: this rank's entries of a replicated tensor forward; the
  gradient placed at them and all-reduced backward, so every rank holds the
  whole gradient of the replicated tensor (the entries are disjoint, so the
  sum is exact: the same bits on every rank).

The shard layout: ``shard_index`` says where a rank's shard of a parameter
sits in the full tensor. A column-parallel weight [out, in] keeps rows
``index`` of dim 0, a row-parallel one columns ``index`` of dim 1, each a
contiguous 1/M of the dim, as JAX's ``device_put`` cuts it, except the qkv
weight of a model whose heads M divides: its rows are head-aligned,
``[q_heads_r; k_heads_r; v_heads_r]`` of the full ``[3, H, head_dim]``
order, so attention runs on the rank's H/M heads. ``shard_state_dict`` cuts
a full state_dict into one rank's shards; ``full_state_dict`` and
``load_full_state_dict`` gather a sharded module's parameters and cut them
again, and ``FlatShards`` does both for the flat fp32 vectors of
``train/state.py`` (the parameters, the optimizer's buffers, the EMA).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from deltakd_tpu_torch.parallel.mesh import ModelParallel, param_spec


def _reduce(t: torch.Tensor, tp: ModelParallel) -> torch.Tensor:
    """The model ranks' sum of ``t`` (a new tensor), summed in fp32 for a
    16-bit ``t``."""
    out = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t.clone()
    return tp.all_reduce(out).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return torch.cat(tp.all_gather(x), dim=-1)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        return _reduce(g, tp).chunk(tp.size, dim=-1)[tp.rank].contiguous(), None


class _ShardOf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, tp):
        ctx.tp, ctx.shape = tp, x.shape
        ctx.save_for_backward(index)
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        full = g.new_zeros(ctx.shape).index_copy_(0, index, g)
        return _reduce(full, ctx.tp), None, None


def copy_to_model(x: torch.Tensor, tp: ModelParallel) -> torch.Tensor:
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp: ModelParallel) -> torch.Tensor:
    return _ReduceFromModel.apply(x, tp)


def gather_from_model(x: torch.Tensor, tp: ModelParallel) -> torch.Tensor:
    return _GatherFromModel.apply(x, tp)


def shard_of(x: torch.Tensor, index: torch.Tensor, tp: ModelParallel) -> torch.Tensor:
    """Entries ``index`` of dim 0 of the replicated ``x``."""
    return _ShardOf.apply(x, index.to(x.device), tp)


# -----------------------------------------------------------------------------
# The shard layout
# -----------------------------------------------------------------------------

def heads_split(num_heads: int, size: int) -> bool:
    """Whether attention runs on each rank's own heads (M divides the head
    count); otherwise the qkv product's columns are gathered first."""
    return num_heads % size == 0


def qkv_rows(dim: int, num_heads: int, size: int, rank: int) -> torch.Tensor:
    """The rows of the full qkv weight [3 D, D] (and entries of its bias) that
    rank ``rank`` of ``size`` holds."""
    if heads_split(num_heads, size):
        w = dim // size
        return torch.cat([s * dim + rank * w + torch.arange(w) for s in range(3)])
    w = 3 * dim // size
    return torch.arange(rank * w, (rank + 1) * w)


def shard_index(name: str, full_shape: Sequence[int], num_heads: int, size: int,
                rank: int) -> Optional[Tuple[int, torch.Tensor]]:
    """(dim, index) of rank ``rank``'s shard of the parameter ``name`` of
    full shape ``full_shape`` over a model axis of ``size``, or None where
    it is replicated. Raises ValueError where ``size`` does not divide the
    dim the rule splits, as JAX's ``device_put`` refuses it."""
    kind = param_spec(name, tuple(full_shape))
    if kind is None or size == 1:
        return None
    dim = 0 if kind == "column" else 1
    n = full_shape[dim]
    if n % size:
        raise ValueError(f"{name}: its {kind}-parallel dimension {dim} of size {n} does "
                         f"not split over a model axis of {size}")
    if name.split(".")[-2] == "qkv":
        return dim, qkv_rows(n // 3, num_heads, size, rank)
    w = n // size
    return dim, torch.arange(rank * w, (rank + 1) * w)


def shard_state_dict(sd: Mapping[str, torch.Tensor], num_heads: int, size: int,
                     rank: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shards of a full state_dict (the replicated tensors as
    they are)."""
    out = {}
    for name, t in sd.items():
        where = shard_index(name, t.shape, num_heads, size, rank)
        out[name] = t if where is None else t.index_select(
            where[0], where[1].to(t.device)).contiguous()
    return out


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter's shard: dim ``dim`` of the full tensor, which has
    ``full_shape``, at ``indices[r]`` on model rank r of ``tp``."""
    tp: ModelParallel
    dim: int
    full_shape: Tuple[int, ...]
    indices: Tuple[torch.Tensor, ...]


def shard_parameters(module: nn.Module, num_heads: int, tp: ModelParallel,
                     prefix: str = "") -> None:
    """Replaces each parameter of ``module`` that the rule splits by an empty
    parameter of its shard's shape, tagged with its ``Shard`` as
    ``.model_shard``; load the values with ``shard_state_dict``."""
    for name, p in list(module.named_parameters()):
        full = tuple(p.shape)
        where = [shard_index(prefix + name, full, num_heads, tp.size, r)
                 for r in range(tp.size)]
        if where[0] is None:
            continue
        dim, indices = where[0][0], tuple(index for _, index in where)
        shape = list(full)
        shape[dim] //= tp.size
        owner = module.get_submodule(name.rpartition(".")[0])
        shard = nn.Parameter(p.new_empty(shape), requires_grad=p.requires_grad)
        shard.model_shard = Shard(tp, dim, full, indices)
        setattr(owner, name.rpartition(".")[2], shard)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The full parameters of a module whose parameters may be shards
    (collective over each shard's model group), detached."""
    out = {}
    for name, p in module.named_parameters():
        out[name] = _full(p.detach(), getattr(p, "model_shard", None))
    return out


def load_full_state_dict(module: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Copies the full tensors of ``sd`` into ``module``'s parameters, each
    shard its own rows or columns."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(_cut(sd[name].to(p.device), getattr(p, "model_shard", None)))


def _join(parts: Sequence[torch.Tensor], shard: Shard) -> torch.Tensor:
    """The full tensor from every model rank's shard, by model rank."""
    full = parts[0].new_empty(shard.full_shape)
    for r, part in enumerate(parts):
        full.index_copy_(shard.dim, shard.indices[r].to(part.device), part)
    return full


def _full(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    return t if shard is None else _join(shard.tp.all_gather(t), shard)


def _cut(t: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    if shard is None:
        return t
    return t.index_select(shard.dim, shard.indices[shard.tp.rank].to(t.device))


class FlatShards:
    """The layout of a flat fp32 vector over ``named_params`` (local
    parameters, some tagged by ``shard_parameters``): the full names and
    shapes, ``gather`` to the full vector (collective over the model group)
    and ``cut`` back, and the sum of squares over the model axis."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]]):
        self.shards = [getattr(p, "model_shard", None) for _, p in named_params]
        self.tp = next(s.tp for s in self.shards if s is not None)
        self.names = [n for n, _ in named_params]
        self.local_shapes = [tuple(p.shape) for _, p in named_params]
        self.full_shapes = [tuple(p.shape) if s is None else s.full_shape
                            for (_, p), s in zip(named_params, self.shards)]
        self.mask = torch.cat([torch.full((p.numel(),), s is not None, device=p.device)
                               for (_, p), s in zip(named_params, self.shards)])

    @classmethod
    def of(cls, named_params) -> Optional["FlatShards"]:
        """The layout, or None where no parameter is a shard."""
        named_params = list(named_params)
        if not any(getattr(p, "model_shard", None) is not None for _, p in named_params):
            return None
        return cls(named_params)

    def _split(self, flat: torch.Tensor, shapes) -> List[torch.Tensor]:
        sizes = [int(torch.Size(s).numel()) for s in shapes]
        return [t.view(s) for t, s in zip(flat.split(sizes), shapes)]

    def gather(self, flat: torch.Tensor) -> torch.Tensor:
        """The full flat vector (a one-rank run's layout) from every model
        rank's local one; collective over the model group."""
        ranks = [self._split(f, self.local_shapes) for f in self.tp.all_gather(flat)]
        out = []
        for i, shard in enumerate(self.shards):
            t = ranks[self.tp.rank][i] if shard is None else _join(
                [part[i] for part in ranks], shard)
            out.append(t.reshape(-1))
        return torch.cat(out)

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's local flat vector from the full one."""
        parts = self._split(full, self.full_shapes)
        return torch.cat([_cut(t, s).reshape(-1) for t, s in zip(parts, self.shards)])

    def square_sum(self, g: torch.Tensor) -> torch.Tensor:
        """The sum of squares of the full vector whose local part is ``g``, in
        fp64: the shards' squares summed over the model group, the
        replicated tensors' counted once."""
        zero = g.new_zeros(())
        sharded = torch.linalg.vector_norm(torch.where(self.mask, g, zero),
                                           dtype=torch.float64).square().reshape(1)
        replicated = torch.linalg.vector_norm(torch.where(self.mask, zero, g),
                                              dtype=torch.float64).square()
        return self.tp.all_reduce(sharded)[0] + replicated
