"""Fused transformer MLP (fc1 -> erf-GELU -> fc2): plain PyTorch versions, CUDA
kernel wrappers, the forward-only function and the autograd Function.

Counterpart of ``deltakd_tpu/ops/fused_mlp.py``.

    h = gelu(x W1^T + b1)   fp32, cast to x's dtype
    o = h W2^T + b2         fp32 accumulate, cast to x's dtype

**Weight layout.** Every function of this module takes nn.Linear's [out, in]
layout, as the rest of the port does: ``w1`` is ``fc1.weight`` [F, D], ``w2``
is ``fc2.weight`` [D, F] (the JAX functions take the transposes, [D, F] and
[F, D]). Weights and biases are cast to x's dtype first, as the JAX function
casts them.

``fused_mlp`` is forward only (the frozen teacher and evaluation): the [M, F]
hidden never reaches device memory. ``fused_mlp_train`` is differentiable: it
saves ``(x, w1, b1, w2)`` and its backward recomputes the hidden, with
``gelu'(t) = Phi(t) + t phi(t)``, and returns the weight gradients summed in
fp32 and cast to the parameters' dtypes.

Dispatch is by the device of ``x``: a CPU tensor takes the plain version, a
CUDA tensor the hand-written kernels in ``csrc/fused_mlp.cu`` (bf16, D and F
multiples of 16; the forward takes the widths of :func:`forward_takes`, every
model width among them), anything else raises. Both kernels also have an
fp32 form (fp32 x with fp32 weights: 3xTF32 products, nothing rounded to
bf16, the hidden through device memory), so ``fused_mlp`` serves an fp32
teacher and ``fused_mlp_train`` an fp32 model; a mix of dtypes raises
ValueError before a launch.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Optional, Tuple

import torch

from deltakd_tpu_torch.ops import current_stream, kernel_entry, on_card

# Kernel launches by (kernel name, width D). Each wrapper adds one where it
# launches its kernel; nothing else touches the count.
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


# -----------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# -----------------------------------------------------------------------------

def reference_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """The unfused MLP in x's dtype (what nn.Linear + exact GELU compute)."""
    dt = x.dtype
    h = torch.nn.functional.gelu(torch.nn.functional.linear(x, w1.to(dt), b1.to(dt)))
    return torch.nn.functional.linear(h, w2.to(dt), b2.to(dt))


def _gelu_and_grad(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    cdf = 0.5 * (1.0 + torch.erf(t * (1.0 / math.sqrt(2.0))))
    return t * cdf, cdf + t * torch.exp(-0.5 * t * t) / math.sqrt(2.0 * math.pi)


def _hidden(x2, w1, b1):
    """(gelu(hpre), gelu'(hpre)) in fp32 for x2 [M, D]."""
    dt = x2.dtype
    hpre = torch.matmul(x2.float(), w1.to(dt).float().t()) + b1.to(dt).float()
    return _gelu_and_grad(hpre)


def _plain_fwd(x2, w1, b1, w2, b2) -> torch.Tensor:
    """What the forward kernel computes on x2 [M, D]."""
    dt = x2.dtype
    h, _ = _hidden(x2, w1, b1)
    o = torch.matmul(h.to(dt).float(), w2.to(dt).float().t()) + b2.to(dt).float()
    return o.to(dt)


def _plain_bwd(x2, w1, b1, w2, dy2):
    """What the backward kernel computes, written from its formulas: dx in
    x's dtype and fp32 (dw1 [F, D], db1 [F], dw2 [D, F], db2 [D])."""
    dt = x2.dtype
    h, hgrad = _hidden(x2, w1, b1)
    dy32 = dy2.float()
    dhpre = torch.matmul(dy32, w2.to(dt).float()) * hgrad
    dhpre_lp = dhpre.to(dt).float()
    dx = torch.matmul(dhpre_lp, w1.to(dt).float()).to(dt)
    dw1 = torch.matmul(dhpre_lp.t(), x2.float())
    dw2 = torch.matmul(dy32.t(), h.to(dt).float())
    return dx, dw1, dhpre.sum(0), dw2, dy32.sum(0)


# -----------------------------------------------------------------------------
# The forward kernel's widths
# -----------------------------------------------------------------------------

def forward_takes(D: int, F: int, dtype: torch.dtype = torch.bfloat16) -> bool:
    """Whether the forward kernel at ``dtype`` takes width D and hidden width
    F. bf16: D a multiple of 192 or 256 up to 1024 (the widest model; its x
    tile fills most of shared memory), F a multiple of 128, or of 32 where D
    is a multiple of 192 (one warpgroup's plan, whose hidden chunks are 64
    and, for F an odd multiple of 32, a 32-wide tail: a model rank's shard
    of the hidden, such as DeiT-Ti's 768 / 4 and 768 / 8). Every width of
    the model zoo with F = 4D is taken. The kernel's entry point
    (csrc/fused_mlp.cu `dk_fused_mlp_fwd`) holds the same rule and picks the
    kernel's plan. float32 (the fp32 form, a chain of GEMM products): D and
    F multiples of 16."""
    if dtype == torch.float32:
        return D > 0 and F > 0 and D % 16 == 0 and F % 16 == 0
    return (0 < D <= 1024 and (D % 192 == 0 or D % 256 == 0) and F > 0 and F % 32 == 0
            and (F % 128 == 0 or D % 192 == 0))


# -----------------------------------------------------------------------------
# CUDA kernel wrappers
# -----------------------------------------------------------------------------

def _library():
    from deltakd_tpu_torch.ops import _build

    return _build.library("fused_mlp")


def _operands(name, x2, w1, b1, w2, b2=None):
    """Checks what the kernels take and returns contiguous (x2, w1, b1, w2,
    b2): x2 CUDA bf16 [M, D] with weights bf16 and biases rounded to bf16 and
    held in fp32, or x2 fp32 with fp32 weights and biases, kept. Raises
    ValueError, before any launch, for anything else, a mix such as fp32 x
    with bf16 weights among it."""
    if x2.dtype not in (torch.bfloat16, torch.float32) or x2.dim() != 2:
        raise ValueError(f"{name}: x must be torch.bfloat16 or torch.float32 [M, D], "
                         f"got {x2.dtype} {tuple(x2.shape)}")
    M, D = x2.shape
    F = w1.shape[0]
    if M < 1 or D % 16 or F % 16:
        raise ValueError(f"{name}: needs M >= 1 and D, F multiples of 16, got "
                         f"M={M}, D={D}, F={F}")
    shapes = [(F, D), (F,), (D, F)] + ([(D,)] if b2 is not None else [])
    given = [w1, b1, w2] + ([b2] if b2 is not None else [])
    for t, shape in zip(given, shapes):
        if tuple(t.shape) != shape or t.device != x2.device:
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} on {t.device}, "
                             f"expected {shape} on {x2.device}")
        if x2.dtype == torch.float32 and t.dtype != torch.float32:
            raise ValueError(f"{name}: fp32 x takes fp32 weights and biases, got a "
                             f"{t.dtype} operand of shape {tuple(t.shape)}")
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: takes CUDA tensors, got x on {x2.device}")
    if x2.dtype == torch.float32:
        return tuple(None if t is None else t.contiguous() for t in (x2, w1, b1, w2, b2))
    lp = lambda t: t.to(torch.bfloat16).contiguous()            # noqa: E731
    bias = lambda t: t.to(torch.bfloat16).float().contiguous()  # noqa: E731
    return (x2.contiguous(), lp(w1), bias(b1), lp(w2),
            None if b2 is None else bias(b2))


def kernel_fused_mlp(x2, w1, b1, w2, b2) -> torch.Tensor:
    """The forward kernel alone on a CUDA bf16 or fp32 [M, D] tensor (fp32:
    the fp32 form, ``dk_fused_mlp_fwd_f32``, counted as
    ``("fused_mlp_fwd_f32", D)``). Raises ValueError for widths the bf16
    kernel does not take (:func:`forward_takes`), on a bf16 [M, D] tensor of
    any device before its device is looked at."""
    D, F = x2.shape[-1], w1.shape[0]
    if not forward_takes(D, F) and x2.dtype == torch.bfloat16 and x2.dim() == 2:
        raise ValueError(f"fused_mlp: the forward kernel takes no width D={D}, F={F} (D "
                         f"a multiple of 192 or 256 up to 1024, F of 128, or of 32 where "
                         f"D is a multiple of 192)")
    x2, w1, b1, w2, b2 = _operands("fused_mlp", x2, w1, b1, w2, b2)
    M = x2.shape[0]
    name = kernel_entry("fused_mlp_fwd", x2)
    lib = _library()
    with torch.cuda.device(x2.device):
        out = torch.empty_like(x2)
        ptrs = [t.data_ptr() for t in (x2, w1, b1, w2, b2, out)]
        if name == "fused_mlp_fwd":
            err = lib.dk_fused_mlp_fwd(*ptrs, M, D, F, current_stream(x2))
        else:
            work = torch.empty(lib.dk_fused_mlp_fwd_f32_workspace(M, D, F), dtype=torch.uint8,
                               device=x2.device)
            err = lib.dk_fused_mlp_fwd_f32(*ptrs, work.data_ptr(), M, D, F, current_stream(x2))
    if err == -1:
        raise ValueError(f"fused_mlp: the kernel refused D={D}, F={F} or an operand not "
                         f"16-byte aligned; nothing was launched")
    if err:
        raise RuntimeError(f"fused_mlp: CUDA error {err} at launch")
    LAUNCHES[(name, D)] += 1
    return out


def workspace_bytes(M: int, D: int, F: int, name: str = "fused_mlp_bwd") -> int:
    """Bytes of the workspace of backward kernel ``name`` (``fused_mlp_bwd``
    or ``fused_mlp_bwd_f32``) at [M, D] and hidden width F: h and dhpre in
    the operand dtype, gelu' in fp32, W1 and W2 transposed, the partials of
    the wider weight gradient and of the column sums."""
    return getattr(_library(), f"dk_{name}_workspace")(M, D, F)


def kernel_fused_mlp_bwd(x2, w1, b1, w2, dy2):
    """The backward kernel alone on CUDA bf16 or fp32 [M, D] tensors (fp32:
    the fp32 form, ``dk_fused_mlp_bwd_f32``, counted as
    ``("fused_mlp_bwd_f32", D)``): (dx in x's dtype, dw1, db1, dw2, db2
    fp32)."""
    x2, w1, b1, w2, _ = _operands("fused_mlp_bwd", x2, w1, b1, w2)
    if dy2.shape != x2.shape or dy2.dtype != x2.dtype or dy2.device != x2.device:
        raise ValueError(f"fused_mlp_bwd: dy is {dy2.dtype} {tuple(dy2.shape)} on "
                         f"{dy2.device}, x is {x2.dtype} {tuple(x2.shape)} on {x2.device}")
    dy2 = dy2.contiguous()
    M, D = x2.shape
    F = w1.shape[0]
    name = kernel_entry("fused_mlp_bwd", x2)
    with torch.cuda.device(x2.device):
        f32 = dict(dtype=torch.float32, device=x2.device)
        dx = torch.empty_like(x2)
        dw1, db1 = torch.empty((F, D), **f32), torch.empty(F, **f32)
        dw2, db2 = torch.empty((D, F), **f32), torch.empty(D, **f32)
        work = torch.empty(workspace_bytes(M, D, F, name), dtype=torch.uint8,
                           device=x2.device)
        err = getattr(_library(), f"dk_{name}")(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dy2.data_ptr(),
            dx.data_ptr(), dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            work.data_ptr(), M, D, F, current_stream(x2))
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[(name, D)] += 1
    return dx, dw1, db1, dw2, db2


# -----------------------------------------------------------------------------
# Dispatch and autograd
# -----------------------------------------------------------------------------

def _forward(x, w1, b1, w2, b2, name):
    fwd = kernel_fused_mlp if on_card(x, name) else _plain_fwd
    return fwd(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2).reshape(x.shape)


def fused_mlp(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """[..., D] -> [..., D], forward only. Raises when a gradient would be
    needed (gradient mode on and an operand requiring one): the result would
    silently carry no graph. Use ``fused_mlp_train`` to differentiate."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise RuntimeError("fused_mlp is forward only: call it under torch.no_grad() "
                           "or on operands that need no gradient, or use fused_mlp_train")
    return _forward(x, w1, b1, w2, b2, "fused_mlp")


class _FusedMlpTrain(torch.autograd.Function):
    """Saves (x, w1, b1, w2); the backward recomputes the hidden."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.b2_dtype = b2.dtype
        return _forward(x, w1, b1, w2, b2, "fused_mlp_train")

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        bwd = kernel_fused_mlp_bwd if x.device.type == "cuda" else _plain_bwd
        D = x.shape[-1]
        dx, dw1, db1, dw2, db2 = bwd(x.reshape(-1, D), w1, b1, w2,
                                     dy.to(x.dtype).reshape(-1, D))
        return (dx.reshape(x.shape), dw1.to(w1.dtype), db1.to(b1.dtype),
                dw2.to(w2.dtype), db2.to(ctx.b2_dtype))


def fused_mlp_train(x: torch.Tensor, w1, b1, w2, b2) -> torch.Tensor:
    """[..., D] -> [..., D], differentiable in all five operands, at x's
    dtype (bf16, or fp32 with fp32 parameters)."""
    return _FusedMlpTrain.apply(x, w1, b1, w2, b2)


def best_mlp_fn(enabled: bool = True) -> Optional[Callable]:
    """mlp_fn for forward-only VisionTransformer modules (the frozen teacher,
    evaluation): ``fused_mlp``, or None (the model's own nn.Linear path)."""
    return fused_mlp if enabled else None


def best_train_mlp_fn(enabled: bool = True) -> Optional[Callable]:
    """Differentiable mlp_fn for training modules: ``fused_mlp_train``, or
    None."""
    return fused_mlp_train if enabled else None
