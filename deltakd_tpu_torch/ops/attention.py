"""Fused attention for ViT-length sequences: plain PyTorch versions, CUDA kernel
wrappers and the autograd Function that joins them.

Counterpart of ``deltakd_tpu/ops/attention.py``. Per (batch, head), with
``scale = head_dim ** -0.5``:

    s   = q k^T * scale                 fp32
    p   = softmax(s) cast to v's dtype
    o   = p v                           fp32 accumulate, cast to q's dtype
    lse = max(s) + log(sum exp(s - max(s)))    fp32, kept for the backward

and the backward, from the saved ``(q, k, v, o, lse)`` and the cotangent dO,
rebuilds ``p = exp(s - lse)`` and emits
``dv = p^T dO``, ``dp = dO v^T``, ``delta = rowsum(dO * o)``,
``ds = p (dp - delta) scale``, ``dq = ds k``, ``dk = ds^T q``.

Tensors are [B, H, N, head_dim] (the kernels alone also take [B*H, N,
head_dim]). Dispatch is by the device of ``q``: a CPU tensor takes the plain
version, a CUDA tensor the hand-written kernels in ``csrc/attention.cu`` (bf16
or fp32, head dim 64, any N and any batch x heads), anything else raises. The
fp32 forms run every product on TF32 tensor cores in 3xTF32 (each operand as a
high and a low TF32 part, three products: fp32 accuracy) and round nothing to
bf16: o, lse, dq, dk, dv are fp32, as the TPU kernels emit their input's
dtype. The kernels read q, k, v and dO through
their strides when the head dim is contiguous, so the views of a packed qkv
projection are not copied.
"""

from __future__ import annotations

import collections
from typing import Callable, Optional, Tuple

import torch

from deltakd_tpu_torch.ops import current_stream, kernel_entry, on_card

_HEAD_DIM = 64

# Kernel launches by (entry point, batch * heads): the fp32 forms count under
# ``flash_fwd_f32`` and ``flash_bwd_f32``. Each wrapper adds one where it
# launches its kernel; nothing else touches the count.
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


# -----------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# -----------------------------------------------------------------------------

def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain attention with an fp32 softmax: [B, H, N, d] each -> [B, H, N, d].
    The scale goes on q before the product and p is cast to q's dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def _plain_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes: (o in q's dtype, lse [..., N] fp32)."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(-1, keepdim=True)
    p = (e / denom).to(v.dtype)
    o = torch.matmul(p.float(), v.float()).to(q.dtype)
    return o, (m + torch.log(denom)).squeeze(-1)


def _plain_bwd(q, k, v, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the backward kernel computes, written from its formulas (not from
    autograd), with fp32 operands in every product: (dq, dk, dv) in q's dtype."""
    scale = q.shape[-1] ** -0.5
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.unsqueeze(-1))
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v32.transpose(-1, -2))
    delta = (do32 * o.float()).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.matmul(ds, k32)
    dk = torch.matmul(ds.transpose(-1, -2), q32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _plain_fwd_rows(q, k, v, rows: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_plain_fwd`` in query-row chunks of ``rows``: the same formulas on
    [rows, N] scores at a time, for lengths whose [N, N] fp32 scores do not
    fit (8.9 GB a head at N = 47,105)."""
    parts = [_plain_fwd(q[..., i:i + rows, :], k, v) for i in range(0, q.shape[-2], rows)]
    return torch.cat([o for o, _ in parts], -2), torch.cat([lse for _, lse in parts], -1)


def _plain_bwd_rows(q, k, v, o, lse, do, rows: int = 1024
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_plain_bwd`` in query-row chunks of ``rows``: dq a chunk at a time,
    dk and dv summed over the chunks in fp32, then cast as there."""
    scale = q.shape[-1] ** -0.5
    k32, v32 = k.float(), v.float()
    dk, dv, dq = torch.zeros_like(k32), torch.zeros_like(v32), []
    for i in range(0, q.shape[-2], rows):
        q32, do32 = q[..., i:i + rows, :].float(), do[..., i:i + rows, :].float()
        s = torch.matmul(q32, k32.transpose(-1, -2)) * scale
        p = torch.exp(s - lse[..., i:i + rows].unsqueeze(-1))
        dv += torch.matmul(p.transpose(-1, -2), do32)
        delta = (do32 * o[..., i:i + rows, :].float()).sum(-1, keepdim=True)
        ds = p * (torch.matmul(do32, v32.transpose(-1, -2)) - delta) * scale
        dq.append(torch.matmul(ds, k32))
        dk += torch.matmul(ds.transpose(-1, -2), q32)
    return torch.cat(dq, -2).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# -----------------------------------------------------------------------------
# CUDA kernel wrappers
# -----------------------------------------------------------------------------

def _library():
    from deltakd_tpu_torch.ops import _build

    return _build.library("attention")


def _operands(name: str, *tensors: torch.Tensor):
    """Checks what the kernels take and returns ((B, H, N), the tensors as
    [B, H, N, 64] views): CUDA, all bf16 or all fp32, head dim 64, one shape,
    [B, H, N, 64] or [B*H, N, 64]. Raises ValueError, before any launch, for
    anything else, a mix of dtypes among it."""
    q = tensors[0]
    if q.dtype not in (torch.bfloat16, torch.float32) or any(t.dtype != q.dtype
                                                             for t in tensors):
        raise ValueError(f"{name}: takes all bf16 or all fp32 tensors, got "
                         f"{[str(t.dtype) for t in tensors]}")
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: takes CUDA bf16 or fp32 tensors, got one on {t.device}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name}: operands differ, {tuple(t.shape)} on {t.device} "
                             f"and {tuple(q.shape)} on {q.device}")
    if q.dim() not in (3, 4) or q.shape[-1] != _HEAD_DIM or q.numel() == 0:
        raise ValueError(f"{name}: takes non-empty [B, H, N, {_HEAD_DIM}] or "
                         f"[B*H, N, {_HEAD_DIM}] tensors, got {tuple(q.shape)}")
    if q.dim() == 3:
        tensors = tuple(t.unsqueeze(1) for t in tensors)
    return tuple(tensors[0].shape[:3]), tensors


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels can read it in place: head dim contiguous, rows
    16-byte aligned; otherwise a contiguous copy."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in t.stride()[:3]))
    return t if ok else t.contiguous()


def kernel_flash_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel alone on CUDA bf16 or fp32 tensors: (o, lse), o
    contiguous in the shape and dtype of q and lse fp32 over its leading
    dims."""
    (B, H, N), (q4, k4, v4) = _operands("flash_fwd", q, k, v)
    name = kernel_entry("flash_fwd", q)
    lib = _library()
    q4, k4, v4 = _strided(q4), _strided(k4), _strided(v4)
    with torch.cuda.device(q.device):
        o = torch.empty((B, H, N, _HEAD_DIM), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
        err = getattr(lib, f"dk_{name}")(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), *q4.stride()[:3], *k4.stride()[:3],
            *v4.stride()[:3], o.data_ptr(), lse.data_ptr(), B, H, N, current_stream(q))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[(name, B * H)] += 1
    return o.reshape(q.shape), lse.reshape(q.shape[:-1])


# The bf16 backward's routes that ``kernel_flash_bwd(route=...)`` forces
# (attention_bwd.cuh ``AttnBwdRoute``), and the longest N of the short one.
_ROUTES = {"short": 1, "split": 2}
SHORT_ROUTE_MAX_N = 704


def kernel_flash_bwd(q, k, v, o, lse, do, route: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel alone on CUDA bf16 or fp32 tensors: (dq, dk, dv),
    contiguous in the shape and dtype of q. ``o`` and ``lse`` are the forward
    kernel's outputs; one call, which also forms delta = rowsum(dO * o).
    ``route`` ("short", N <= 704, or "split"; bf16 only) forces a route of
    the bf16 backward, which otherwise takes the short one up to 256 rows
    and the split one above them, and counts under
    ``flash_bwd_<route>``: it holds the two routes to the same bits and
    times them beside each other on the card, and no model path sets it."""
    (B, H, N), (q4, k4, v4, o4, do4) = _operands("flash_bwd", q, k, v, o, do)
    name = kernel_entry("flash_bwd", q)
    if route is not None:
        if q.dtype != torch.bfloat16 or route not in _ROUTES:
            raise ValueError(f"flash_bwd: route {route!r} at {q.dtype}: the bf16 backward "
                             f"has the routes {sorted(_ROUTES)} (bf16 only)")
        if route == "short" and N > SHORT_ROUTE_MAX_N:
            raise ValueError(f"flash_bwd: the short route takes N up to {SHORT_ROUTE_MAX_N}, "
                             f"got {N}")
    if lse.dtype != torch.float32 or lse.numel() != B * H * N or lse.device != q.device:
        raise ValueError(f"flash_bwd: lse must be fp32 with one value a row on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    lib = _library()
    q4, k4, v4, do4 = _strided(q4), _strided(k4), _strided(v4), _strided(do4)
    o4, lse = o4.contiguous(), lse.contiguous()
    with torch.cuda.device(q.device):
        dq, dk, dv = (torch.empty((B, H, N, _HEAD_DIM), dtype=q.dtype, device=q.device)
                      for _ in range(3))
        # the workspace: fp32, Q^T, dO^T and the dQ partials of its key tiles;
        # bf16, the split route's delta and column-sum partials (none on the
        # short route)
        forced = () if route is None else (_ROUTES[route],)
        entry = name if route is None else "flash_bwd_route"
        nbytes = getattr(lib, f"dk_{entry}_workspace")(B, H, N, *forced)
        work = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
        err = getattr(lib, f"dk_{entry}")(
            q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), do4.data_ptr(),
            *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3], *do4.stride()[:3],
            o4.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, N, None if work is None else work.data_ptr(), current_stream(q), *forced)
    if route is not None:
        name = f"flash_bwd_{route}"
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[(name, B * H)] += 1
    return dq.reshape(q.shape), dk.reshape(q.shape), dv.reshape(q.shape)


# -----------------------------------------------------------------------------
# Dispatch and autograd
# -----------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, o, lse); the backward rebuilds p from them."""

    @staticmethod
    def forward(ctx, q, k, v):
        fwd = kernel_flash_fwd if on_card(q, "flash_attention") else _plain_fwd
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = kernel_flash_bwd if q.device.type == "cuda" else _plain_bwd
        return bwd(q, k, v, o, lse, do)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Fused attention, [B, H, N, d] -> [B, H, N, d], differentiable: the
    kernels for CUDA tensors, the plain version for CPU tensors."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: takes three [B, H, N, d] tensors, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    return _FlashAttention.apply(q, k, v)


def best_attention_fn(enabled: bool = True) -> Optional[Callable]:
    """attention_fn for VisionTransformer: ``flash_attention``, or None (the
    model's own matmul-softmax-matmul). Which implementation runs is decided
    at call time by the tensors' device."""
    return flash_attention if enabled else None
