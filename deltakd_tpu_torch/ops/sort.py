"""Sorting along an axis and the sorted-L1 distance (the WassKD-l1 building
block): plain PyTorch versions, CUDA kernel wrappers and the autograd Function
that joins them.

Counterpart of ``deltakd_tpu/ops/sort.py``.

    sorted_l1(s, t, axis) = mean |sort(s, axis) - sort(t, axis)|

sorts in the dtype of ``s`` (``t`` is cast to it and treated as a constant),
takes differences and the mean in fp32, and gives ``s`` the gradient
``sign(s_sorted - t_sorted) / numel`` scattered back to the row each sorted
value came from. Equal keys are ordered by row (a stable sort), which fixes
the split of the gradient inside a group of tied rows; any other split is an
equally valid subgradient of the same loss.

Dispatch is by the device of the input: a CPU tensor takes the plain version,
a CUDA tensor the hand-written kernels in ``csrc/sort.cu``, anything else
raises. The kernels work on a contiguous [B, n, d] tensor sorted along n,
2 <= n <= 2**30 (``KERNEL_MAX_N``: positions and rows are 32-bit ints);
another axis or rank is brought to that layout by a transpose, not by
another code path. The whole batch goes through one call. Both sorts run
one bitonic network in registers and warp shuffles, one warp a column of up
to 1024 rows (up to 4096: n / 1024 warps, which merge their runs through
shared memory), on unsigned key images whose order is the order to sort by
(``value_sort_keys``). Longer columns take the long route: runs of 4096
rows sorted that way into a key workspace in device memory, then the merge
stages of stride 4096 and up in device memory, one launch a stage, and
after each merge phase the strides below 4096 in the block
(``long_schedule``). The value sort takes bf16, fp16, fp32 and int32 and
equals ``torch.sort(x, dim=1).values``: every NaN sorts last (a column with k
NaNs ends in k NaNs), -0.0 and +0.0 keep their signs (the -0.0s first, equal
as floats to torch.sort's result). The sorted_l1 kernels take bf16 and fp32;
their s keys carry the row, with -0.0 folded onto +0.0 (``sort_keys``).
"""

from __future__ import annotations

import collections
from typing import Tuple

import torch

from deltakd_tpu_torch.ops import current_stream, on_card

# Kernel launches by kernel name (the row: the long route's runs, stages and
# finishes all count under the sort that launches them). Each wrapper adds one
# where it launches a kernel; nothing else touches the count.
LAUNCHES: collections.Counter = collections.Counter()

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# the value sort's dtypes, by the code dk_sort_bitonic takes
_SORT_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int32: 3}
# (integer view, bits, the bits of +inf: anything above is a NaN; None for an integer)
_KEY_BITS = {torch.bfloat16: (torch.int16, 16, 0x7f80), torch.float16: (torch.int16, 16, 0x7c00),
             torch.float32: (torch.int32, 32, 0x7f800000), torch.int32: (torch.int32, 32, None)}
_MIN_N = 2
# The longest column the kernels sort: n_pad, the positions and the rows the
# keys carry are 32-bit ints (sort.cu kLongMaxN). Past 4096 rows the long route.
KERNEL_MAX_N = 1 << 30
_SHORT_MAX_N = 4096
_CHUNK = 4096   # the rows of a run, and of a finish's chunk, on the long route


def reset_launches() -> None:
    LAUNCHES.clear()


# -----------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# -----------------------------------------------------------------------------

def sorted_l1_reference(s: torch.Tensor, t: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Plain PyTorch sorted_l1 on any device, differentiable by autograd
    through the stable sort; fp32 mean."""
    t = t.detach().to(s.dtype)
    s_sorted = torch.sort(s, dim=axis, stable=True).values.float()
    t_sorted = torch.sort(t, dim=axis).values.float()
    return (s_sorted - t_sorted).abs().mean()


def _plain_sl1_fwd(s3: torch.Tensor, t3: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes on [B, n, d]: the fp32 sum of
    |s_sorted - t_sorted| and the int8 signs in row order."""
    s_sorted, idx = torch.sort(s3, dim=1, stable=True)
    diff = s_sorted.float() - torch.sort(t3, dim=1).values.float()
    sign = torch.zeros(s3.shape, dtype=torch.int8, device=s3.device)
    sign.scatter_(1, idx, torch.sign(diff).to(torch.int8))
    return diff.abs().sum(), sign


def value_sort_keys(x: torch.Tensor) -> torch.Tensor:
    """The value-sort kernel's key image of each element of a bf16, fp16,
    fp32 or int32 tensor, as int64 (16 or 32 bits used): unsigned, and its
    order is the value order. A float's: every NaN onto the largest image
    (all ones, which is also the padding's), otherwise sign bit set: all bits
    flipped; clear: sign bit set (so -0.0 lies just below +0.0). An int32's:
    ``x ^ 0x80000000``. ``value_from_keys`` is its inverse."""
    if x.dtype not in _KEY_BITS:
        raise ValueError(f"value_sort_keys: takes bf16, fp16, fp32 or int32, got {x.dtype}")
    view, bits, inf = _KEY_BITS[x.dtype]
    sign, mask = 1 << (bits - 1), (1 << bits) - 1
    u = x.contiguous().view(view).to(torch.int64) & mask
    if inf is None:
        return u ^ sign
    image = torch.where((u & sign) != 0, ~u & mask, u | sign)
    return torch.where((u & (sign - 1)) > inf, mask, image)


def value_from_keys(keys: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The values of ``value_sort_keys`` images, as the kernel decodes them:
    the bits back for every value but a NaN, and the largest image decodes to
    the NaN with every bit but the sign set (INT32_MAX for int32)."""
    view, bits, inf = _KEY_BITS[dtype]
    sign, mask = 1 << (bits - 1), (1 << bits) - 1
    if inf is None:
        u = keys ^ sign
    else:
        u = torch.where((keys & sign) != 0, keys ^ sign, ~keys & mask)
    return torch.where(u >= sign, u - (1 << bits), u).to(view).view(dtype)


def sort_keys(x3: torch.Tensor) -> torch.Tensor:
    """The forward kernel's packed s keys of a [B, n, d] bf16 or fp32 tensor
    sorted along axis 1, as int64: the ``value_sort_keys`` image of each
    value, -0.0 folded onto +0.0, above its row index. bf16:
    ``image << 16 | row``, the kernel's 32-bit key; fp32: the kernel's
    ``image << 32 | row`` less 2**63, which keeps its order inside int64. The
    keys are distinct, and ascending key order is the stable ascending order
    of the values (torch.sort(stable=True) puts NaN last as well)."""
    bits = {torch.bfloat16: 16, torch.float32: 32}.get(x3.dtype)
    if bits is None or x3.dim() != 3:
        raise ValueError(f"sort_keys: takes a bf16 or fp32 [B, n, d] tensor, got "
                         f"{x3.dtype} {tuple(x3.shape)}")
    sign = 1 << (bits - 1)
    image = value_sort_keys(x3)
    image = torch.where(image == sign - 1, sign, image)   # -0.0 onto +0.0
    row = torch.arange(x3.shape[1], dtype=torch.int64, device=x3.device).view(1, -1, 1)
    if bits == 16:
        return (image << 16) | row
    return ((image - (1 << 31)) << 32) | row


def _plain_sl1_bwd(sign: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """What the backward kernel computes: sign * scale in fp32, cast."""
    return (sign.float() * scale).to(dtype)


# -----------------------------------------------------------------------------
# CUDA kernel wrappers
# -----------------------------------------------------------------------------

def _kernel_operand(x: torch.Tensor, name: str, dtypes=_KERNEL_DTYPES) -> torch.Tensor:
    if x.dim() != 3 or x.dtype not in dtypes:
        raise ValueError(f"{name}: takes a [B, n, d] tensor of "
                         f"{', '.join(str(t).split('.')[-1] for t in dtypes)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if not _MIN_N <= x.shape[1] <= KERNEL_MAX_N or x.shape[0] < 1 or x.shape[2] < 1:
        raise ValueError(f"{name}: sorts {_MIN_N} <= n <= {KERNEL_MAX_N} rows of a "
                         f"non-empty [B, n, d] tensor, got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: needs a CUDA tensor, got one on {x.device}")
    return x.contiguous()


def _call(fn: str, name: str, *args) -> None:
    from deltakd_tpu_torch.ops import _build

    err = getattr(_build.library("sort"), fn)(*args)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[name] += 1


def long_schedule(n: int):
    """The long route's passes after its runs (each 4096 rows of a column
    sorted ascending), for a column of ``n`` > 4096 rows padded to n_pad, a
    power of two: for each merge phase of block size Kb = 8192 .. n_pad,
    ``("stage", Kb / 2, True)`` (the mirror stage, p against p ^ (Kb - 1)),
    ``("stage", J, False)`` for J = Kb / 4 .. 4096 (p against p | J), then
    ``("finish", Kb == n_pad)`` (the strides 2048 .. 1 in the block; the
    last one writes the result)."""
    n_pad = 1 << (n - 1).bit_length()
    steps, kb = [], 2 * _CHUNK
    while kb <= n_pad:
        steps.append(("stage", kb // 2, True))
        j = kb // 4
        while j >= _CHUNK:
            steps.append(("stage", j, False))
            j //= 2
        steps.append(("finish", kb == n_pad))
        kb *= 2
    return steps


def launches_per_call(n: int, key_arrays: int = 1) -> int:
    """The kernel launches of one sort call on columns of ``n`` rows: one on
    the short route; on the long route the runs, each stage once for each of
    the ``key_arrays`` (sorted_l1's forward sorts two) and each finish."""
    if n <= _SHORT_MAX_N:
        return 1
    return 1 + sum(key_arrays if step[0] == "stage" else 1 for step in long_schedule(n))


def _long_route(name: str, x: torch.Tensor, y, code: int, finish) -> None:
    """The long route on [B, n, d] ``x`` (and sorted_l1's t ``y``): the
    runs, then ``long_schedule``'s stages on the key workspace, ``finish(k64,
    k32, last)`` at each finish."""
    B, n, d = x.shape
    n_pad = 1 << (n - 1).bit_length()
    cols, st = B * d, current_stream(x)
    k32 = torch.empty(cols * n_pad, dtype=torch.int32, device=x.device)
    k64 = (torch.empty(cols * n_pad, dtype=torch.int64, device=x.device)
           if y is not None else None)
    keys = [k for k in (k64, k32) if k is not None]
    _call("dk_sort_long_runs", name, x.data_ptr(), None if y is None else y.data_ptr(),
          None if k64 is None else k64.data_ptr(), k32.data_ptr(), B, n, d, code, st)
    for step in long_schedule(n):
        if step[0] == "stage":
            for k in keys:
                _call("dk_sort_long_stage", name, k.data_ptr(), k.element_size(), cols,
                      n_pad, step[1], int(step[2]), st)
        else:
            finish(k64, k32, int(step[1]))


def bitonic_sort_kernel(x: torch.Tensor) -> torch.Tensor:
    """The value-sort kernel: ascending along axis 1 of a CUDA [B, n, d]
    tensor of bf16, fp16, fp32 or int32."""
    x = _kernel_operand(x, "bitonic_sort", tuple(_SORT_DTYPE_CODES))
    B, n, d = x.shape
    code = _SORT_DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        st = current_stream(x)
        if n <= _SHORT_MAX_N:
            _call("dk_sort_bitonic", "bitonic_sort", x.data_ptr(), out.data_ptr(), B, n, d,
                  code, st)
        else:
            _long_route("bitonic_sort", x, None, code, lambda k64, k32, last: _call(
                "dk_sort_long_finish_value", "bitonic_sort", k32.data_ptr(), out.data_ptr(), B,
                n, d, code, last, st))
    return out


def kernel_sorted_l1_fwd(s: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA [B, n, d] tensors of one dtype: (fp32 sum of
    |s_sorted - t_sorted|, int8 signs in row order). One loss partial per
    thread block (on the long route per column and 4096-row chunk), summed
    here in a fixed order."""
    from deltakd_tpu_torch.ops import _build

    s = _kernel_operand(s, "sorted_l1_fwd")
    if t.shape != s.shape or t.dtype != s.dtype or t.device != s.device:
        raise ValueError(f"sorted_l1_fwd: t is {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"s is {s.dtype} {tuple(s.shape)} on {s.device}")
    t = t.contiguous()
    B, n, d = s.shape
    tiles = _build.library("sort").dk_sort_tiles(n, d)
    is_bf16 = int(s.dtype == torch.bfloat16)
    with torch.cuda.device(s.device):
        partials = torch.empty(B * tiles, dtype=torch.float32, device=s.device)
        sign = torch.empty(s.shape, dtype=torch.int8, device=s.device)
        st = current_stream(s)
        if n <= _SHORT_MAX_N:
            _call("dk_sort_sl1_fwd", "sorted_l1_fwd", s.data_ptr(), t.data_ptr(),
                  partials.data_ptr(), sign.data_ptr(), B, n, d, is_bf16, st)
        else:
            _long_route("sorted_l1_fwd", s, t, is_bf16,
                        lambda k64, k32, last: _call(
                            "dk_sort_long_finish_sl1", "sorted_l1_fwd", k64.data_ptr(),
                            k32.data_ptr(), partials.data_ptr(), sign.data_ptr(), B, n, d,
                            is_bf16, last, st))
    return partials.sum(), sign


def kernel_sorted_l1_bwd(sign: torch.Tensor, scale: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """The backward kernel: ``sign`` (CUDA int8, row order) times the fp32
    device scalar ``scale`` (ct / numel), cast to ``dtype``."""
    if sign.device.type != "cuda" or sign.dtype != torch.int8 or dtype not in _KERNEL_DTYPES:
        raise ValueError(f"sorted_l1_bwd: takes CUDA int8 signs and a bf16 or fp32 "
                         f"output, got {sign.dtype} on {sign.device} and {dtype}")
    sign = sign.contiguous()
    scale = scale.to(device=sign.device, dtype=torch.float32).reshape(1).contiguous()
    with torch.cuda.device(sign.device):
        g = torch.empty(sign.shape, dtype=dtype, device=sign.device)
        _call("dk_sort_sl1_bwd", "sorted_l1_bwd", sign.data_ptr(), scale.data_ptr(),
              g.data_ptr(), sign.numel(), int(dtype == torch.bfloat16), current_stream(sign))
    return g


# -----------------------------------------------------------------------------
# Dispatch and autograd
# -----------------------------------------------------------------------------

def _to_rows(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x`` as [B, n, d] with the sorted axis in the middle: as it is for the
    token axis of a 3-D tensor, else the axis moved to the front of [1, n, rest]."""
    if x.dim() == 3 and axis == 1:
        return x
    return x.movedim(axis, 0).reshape(1, x.shape[axis], -1)


def bitonic_sort(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Ascending sort along ``axis`` (values only, not differentiable): the
    kernel for CUDA tensors, ``torch.sort`` for CPU tensors."""
    axis = axis % x.dim()
    if not on_card(x, "bitonic_sort"):
        return torch.sort(x, dim=axis).values
    if x.dim() == 3 and axis == 1:
        return bitonic_sort_kernel(x)
    moved = x.movedim(axis, 0)
    out = bitonic_sort_kernel(moved.reshape(1, x.shape[axis], -1))
    return out.reshape(moved.shape).movedim(0, axis)


class _SortedL1(torch.autograd.Function):
    """Saves only the int8 sign residual (one byte an element of s)."""

    @staticmethod
    def forward(ctx, s3, t3):
        if on_card(s3, "sorted_l1"):
            total, sign = kernel_sorted_l1_fwd(s3, t3)
        else:
            total, sign = _plain_sl1_fwd(s3, t3)
        ctx.save_for_backward(sign)
        ctx.dtype = s3.dtype
        return total / s3.numel()

    @staticmethod
    def backward(ctx, ct):
        (sign,) = ctx.saved_tensors
        scale = ct.float() / sign.numel()
        if sign.device.type == "cuda":
            g = kernel_sorted_l1_bwd(sign, scale, ctx.dtype)
        else:
            g = _plain_sl1_bwd(sign, scale, ctx.dtype)
        return g, (torch.zeros_like(g) if ctx.needs_input_grad[1] else None)


def sorted_l1(s: torch.Tensor, t: torch.Tensor, axis: int) -> torch.Tensor:
    """mean |sort(s, axis) - sort(t, axis)| in fp32; the gradient goes to ``s``
    and ``t`` gets zero. The kernels for CUDA tensors, the plain version for
    CPU tensors."""
    if t.shape != s.shape:
        raise ValueError(f"sorted_l1: shapes differ, {tuple(s.shape)} and {tuple(t.shape)}")
    axis = axis % s.dim()
    return _SortedL1.apply(_to_rows(s, axis), _to_rows(t.to(s.dtype), axis))
