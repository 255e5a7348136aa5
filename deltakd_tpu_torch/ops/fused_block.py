"""Fused pre-norm ViT block: plain PyTorch versions, CUDA kernel wrappers and
the autograd Function that joins them.

Counterpart of ``deltakd_tpu/ops/fused_block.py``. One block computes

    x2  = x  + s_attn * proj(attention(LN1(x)))
    out = x2 + s_mlp  * feat,    feat = fc2(gelu(fc1(LN2(x2))))

with per-sample drop-path scales ``s_attn``/``s_mlp`` (0 or 1/keep under
stochastic depth, 1 otherwise) and ``feat`` the post-MLP, pre-drop-path,
pre-residual hidden state a feature-KD objective reads.

Numerics follow the TPU kernel: matmul operands are rounded to the compute
dtype (x's: bf16, or fp32) and accumulated in fp32; LayerNorm, softmax, GELU
and the residual stream run in fp32; the softmax normalisation is applied after
the ``e @ v`` product (``post_div``). The backward saves only ``x`` and the
scales and recomputes the forward. Its plain version folds the softmax
normalisations into row scalings, as the JAX package does; the kernel reaches
the same gradient in the flash form, from the forward's row statistic lse and
delta = rowsum(dO * O), and never stores the [N, N] scores.

The block pair (``fused_vit_block_pair``) runs two consecutive blocks as one
function with its own forward and backward kernels. What it does that two
single blocks do not: the activation between the two blocks, and in the
backward its cotangent, never leave fp32 (a single block rounds its output to
the compute dtype), and the backward saves one tensor per pair.

Dispatch is by the device of ``x``: a CPU tensor takes the plain version, a
CUDA tensor the hand-written kernels in ``csrc/``, anything else raises. The
single-block kernels take bf16 x (any float weights, rounded to bf16) or fp32
x with fp32 weights: the fp32 form runs every product on TF32 tensor cores
in 3xTF32 (a high and a low TF32 part of each operand, three products: about
fp32 accuracy) and rounds nothing to bf16, as the TPU kernel runs at its
input's dtype; its plain version is the same function at fp32, `_mm` in full
fp32. The pair kernels take the same two forms. Weights use nn.Linear's
[out, in] layout and timm's names.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Mapping, Optional, Tuple

import torch

from deltakd_tpu_torch.ops import kernel_entry

# timm names of one block's parameters, in the kernels' operand order
# (_weight_arrays in the JAX package: g1, b1, wqkv, bqkv, wproj, bproj, g2,
# b2, w1, bf1, w2, bf2).
PARAM_NAMES = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
               "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")
_MATMUL_WEIGHTS = (2, 4, 8, 10)
# Head dims the block kernels take: the forward's attention (attention_fwd.cuh)
# has an instantiation for these only.
KERNEL_HEAD_DIMS = (64,)

# Kernel launches by (entry point, embed width): the fp32 forms count under
# their own entry points (``fused_block_fwd_f32``, ...). Each wrapper adds one
# where it launches its kernel; nothing else touches the count.
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


# -----------------------------------------------------------------------------
# Plain versions (the CPU path, and the reference the kernels are held to)
# -----------------------------------------------------------------------------

def _mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a @ b with both operands rounded to ``dtype``, accumulated in fp32."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def _gelu_and_grad(x):
    cdf = 0.5 * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    return x * cdf, cdf + x * torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def _ln_fwd(x32, gamma, beta, eps):
    """Returns (y, xhat, rstd), all fp32, over the last dim."""
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    return xhat * gamma + beta, xhat, rstd


def _ln_bwd(dy, xhat, rstd, gamma):
    """dx for y = xhat*gamma + beta; the weight grads are summed by the caller."""
    dxhat = dy * gamma
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd


def _heads(t, H):
    """[B, N, H*hd] -> [B, H, N, hd]"""
    B, N, D = t.shape
    return t.reshape(B, N, H, D // H).transpose(1, 2)


def _merge(t):
    """[B, H, N, hd] -> [B, N, H*hd]"""
    B, H, N, hd = t.shape
    return t.transpose(1, 2).reshape(B, N, H * hd)


def _split_qkv(qkv, H):
    D = qkv.shape[-1] // 3
    return (_heads(qkv[..., :D], H), _heads(qkv[..., D:2 * D], H),
            _heads(qkv[..., 2 * D:], H))


def _block_fwd_stash(x32, w, s_attn, eps, H, dtype, s_mlp=None):
    """Forward up to the GELU, keeping what the reverse sweep needs
    (_block_fwd_stash / _attention_fwd_stash); the softmax normalisation is
    applied to the e @ v product (post_div). With ``s_mlp`` also fc2 and the
    block output. Returns (out, feat, stash), all fp32; out and feat are None
    without ``s_mlp``."""
    D = x32.shape[-1]
    scale = (D // H) ** -0.5
    y, xhat1, rstd1 = _ln_fwd(x32, w[0], w[1], eps)
    qkv = _mm(y, w[2].t(), dtype) + w[3]
    q, k, v = _split_qkv(qkv, H)
    s = _mm(q * scale, k.transpose(-1, -2), dtype)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    rs = 1.0 / e.sum(-1, keepdim=True)
    merged = _merge(_mm(e, v, dtype) * rs)
    attn = _mm(merged, w[4].t(), dtype) + w[5]
    x2 = x32 + s_attn.view(-1, 1, 1) * attn
    z, xhat2, rstd2 = _ln_fwd(x2, w[6], w[7], eps)
    h, hgrad = _gelu_and_grad(_mm(z, w[8].t(), dtype) + w[9])
    out = feat = None
    if s_mlp is not None:
        feat = _mm(h, w[10].t(), dtype) + w[11]
        out = x2 + s_mlp.view(-1, 1, 1) * feat
    return out, feat, (y, qkv, e, rs, merged, xhat1, rstd1, xhat2, rstd2, z, h, hgrad)


def _block_bwd_reverse(stash, w, g_out, g_feat, s_attn, s_mlp, H, dtype):
    """Reverse sweep of one block from its stash (_block_bwd_reverse,
    _attention_bwd_one). ``g_out`` is the fp32 cotangent at the block output,
    ``g_feat`` an optional extra cotangent on the feature. Returns the fp32
    dx and the 12 fp32 weight grads summed over the batch, in nn.Linear
    layout."""
    y, qkv, e, rs, merged, xhat1, rstd1, xhat2, rstd2, z, h, hgrad = stash
    scale = (y.shape[-1] // H) ** -0.5
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731

    g_feat32 = g_out * s_mlp.view(-1, 1, 1)
    if g_feat is not None:
        g_feat32 = g_feat32 + g_feat.float()
    dw2 = plain_weight_grad(g_feat32, h, dtype)
    dbf2 = rows(g_feat32).sum(0)
    dhpre = _mm(g_feat32, w[10], dtype) * hgrad
    dw1 = plain_weight_grad(dhpre, z, dtype)
    dbf1 = rows(dhpre).sum(0)
    dz = _mm(dhpre, w[8], dtype)
    dx2 = g_out + _ln_bwd(dz, xhat2, rstd2, w[6])
    dg2 = rows(dz * xhat2).sum(0)
    db2 = rows(dz).sum(0)

    dattn = dx2 * s_attn.view(-1, 1, 1)
    dwproj = plain_weight_grad(dattn, merged, dtype)
    dbproj = rows(dattn).sum(0)
    dmerged = _mm(dattn, w[4], dtype)

    q, k, v = _split_qkv(qkv, H)
    do = _heads(dmerged, H)
    dv = _mm(e.transpose(-1, -2), do * rs, dtype)
    dp = _mm(do, v.transpose(-1, -2), dtype)
    c = (dp * e).sum(-1, keepdim=True) * rs
    t = e * (dp - c)
    dq = _mm(t, k, dtype) * (scale * rs)
    dk = _mm(t.transpose(-1, -2), q * (scale * rs), dtype)
    dqkv = torch.cat([_merge(dq), _merge(dk), _merge(dv)], dim=-1)

    dwqkv = plain_weight_grad(dqkv, y, dtype)
    dbqkv = rows(dqkv).sum(0)
    dy = _mm(dqkv, w[2], dtype)
    dx = dx2 + _ln_bwd(dy, xhat1, rstd1, w[0])
    dg1 = rows(dy * xhat1).sum(0)
    db1 = rows(dy).sum(0)
    return dx, (dg1, db1, dwqkv, dbqkv, dwproj, dbproj, dg2, db2,
                dw1, dbf1, dw2, dbf2)


def _plain_fwd(x, s_attn, s_mlp, w, H, eps, need_feat):
    """reference_vit_block on the kernel operand tuple ``w``."""
    out, feat, _ = _block_fwd_stash(x.float(), w, s_attn, eps, H, x.dtype, s_mlp)
    return out.to(x.dtype), (feat.to(x.dtype) if need_feat else None)


def _plain_bwd(x, s_attn, s_mlp, w, g_out, g_feat, H, eps):
    """Recompute + reverse sweep. Returns dx in x's dtype and the 12 fp32
    weight grads summed over the batch, in nn.Linear layout."""
    _, _, stash = _block_fwd_stash(x.float(), w, s_attn, eps, H, x.dtype)
    dx, dws = _block_bwd_reverse(stash, w, g_out.float(), g_feat, s_attn, s_mlp,
                                 H, x.dtype)
    return dx.to(x.dtype), dws


def _plain_pair_fwd(x, scales, w1, w2, H, eps, nf1, nf2):
    """Two consecutive blocks (_pair_fwd_kernel); ``scales`` is (s_attn1,
    s_mlp1, s_attn2, s_mlp2). The activation between them stays fp32.
    Returns (out, feat1|None, feat2|None) in x's dtype."""
    sa1, sm1, sa2, sm2 = scales
    mid, f1, _ = _block_fwd_stash(x.float(), w1, sa1, eps, H, x.dtype, sm1)
    out, f2, _ = _block_fwd_stash(mid, w2, sa2, eps, H, x.dtype, sm2)
    return (out.to(x.dtype), f1.to(x.dtype) if nf1 else None,
            f2.to(x.dtype) if nf2 else None)


def _plain_pair_bwd(x, scales, w1, w2, g_out, g_f1, g_f2, H, eps):
    """_pair_bwd_kernel: recompute block 1 with its output, block 2's stash
    from that output, then the two reverse sweeps; the cotangent between
    them stays fp32. Returns dx in x's dtype and the 12 + 12 fp32 weight
    grads (block 1's, then block 2's)."""
    sa1, sm1, sa2, sm2 = scales
    dtype = x.dtype
    mid, _, stash1 = _block_fwd_stash(x.float(), w1, sa1, eps, H, dtype, sm1)
    _, _, stash2 = _block_fwd_stash(mid, w2, sa2, eps, H, dtype)
    dmid, dws2 = _block_bwd_reverse(stash2, w2, g_out.float(), g_f2, sa2, sm2, H, dtype)
    dx, dws1 = _block_bwd_reverse(stash1, w1, dmid, g_f1, sa1, sm1, H, dtype)
    return dx.to(dtype), dws1 + dws2


# -----------------------------------------------------------------------------
# CUDA kernel wrappers
# -----------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel_operands(x, s_attn, s_mlp, w, H, name):
    """Checks what the kernels take and returns (x, s_attn, s_mlp, weights)
    as contiguous tensors: x bf16 or fp32 [B,N,D] with a head dim in
    KERNEL_HEAD_DIMS, scales fp32 [B], matmul weights in x's dtype (bf16 x:
    any float weights, rounded to bf16; fp32 x: fp32 weights, kept), LN
    params and biases fp32. Raises ValueError, before any launch, for
    anything else, a mix such as fp32 x with bf16 weights among it."""
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 3:
        raise ValueError(f"{name}: x must be bf16 or fp32 [B, N, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, N, D = x.shape
    if D % H:
        raise ValueError(f"{name}: width {D} is not divisible by {H} heads")
    if D // H not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D // H} (width {D}, {H} heads) is not one "
                         f"the kernels take: {KERNEL_HEAD_DIMS}")
    F = w[8].shape[0]
    shapes = ((D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,),
              (F, D), (F,), (D, F), (D,))
    for t, shape in zip(w, shapes):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: weight of shape {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {x.device}")
        if x.dtype == torch.float32 and t.dtype != torch.float32:
            raise ValueError(f"{name}: fp32 x takes fp32 weights, got a {t.dtype} "
                             f"weight of shape {tuple(t.shape)}")
    ws = tuple((t.to(x.dtype) if i in _MATMUL_WEIGHTS else t.float()
                ).contiguous() for i, t in enumerate(w))
    scales = tuple(s.reshape(B).float().contiguous() for s in (s_attn, s_mlp))
    return x.contiguous(), scales[0], scales[1], ws


# The source under csrc/ that holds a kernel's entry point, where it is not
# named like the kernel.
_SOURCE_OF = {"fused_pair_fwd": "fused_block_pair", "fused_pair_bwd": "fused_block_pair",
              "fused_pair_fwd_f32": "fused_block_pair",
              "fused_pair_bwd_f32": "fused_block_pair",
              "fused_block_fwd_f32": "fused_block_fwd",
              "fused_block_bwd_f32": "fused_block_bwd"}


def _library(name):
    from deltakd_tpu_torch.ops import _build

    return _build.library(_SOURCE_OF.get(name, name))


def _launch(name, ptrs, x, H, F, eps):
    """Calls the entry point ``dk_<name>`` and counts the launch."""
    lib = _library(name)
    B, N, D = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    err = getattr(lib, f"dk_{name}")(table, B, N, D, H, F, eps, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[(name, D)] += 1


def workspace_bytes(name, shape, H, F) -> int:
    """Bytes of scratch that kernel ``name`` needs for x of ``shape``."""
    B, N, D = shape
    return getattr(_library(name), f"dk_{name}_workspace")(B, N, D, H, F)


def _workspace(name, x, H, F):
    return torch.empty(workspace_bytes(name, x.shape, H, F), dtype=torch.uint8,
                       device=x.device)


def fused_block_fwd_cuda(x, s_attn, s_mlp, w, H, eps, need_feat):
    """The forward kernel (csrc/fused_block_fwd.cu) on CUDA tensors, in x's
    dtype (bf16, or fp32 in 3xTF32)."""
    x, s_attn, s_mlp, ws = _kernel_operands(x, s_attn, s_mlp, w, H,
                                            "fused_block_fwd")
    name = kernel_entry("fused_block_fwd", x)
    F = ws[8].shape[0]
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        feat = torch.empty_like(x) if need_feat else None
        work = _workspace(name, x, H, F)
        _launch(name, [_ptr(t) for t in (x, s_attn, s_mlp, *ws, out, feat, work)],
                x, H, F, eps)
    return out, feat


def fused_block_bwd_cuda(x, s_attn, s_mlp, w, g_out, g_feat, H, eps):
    """The backward kernel (csrc/fused_block_bwd.cu) on CUDA tensors, in x's
    dtype (bf16, or fp32 in 3xTF32): dx in x's dtype and the 12 fp32 weight
    grads summed over the batch."""
    x, s_attn, s_mlp, ws = _kernel_operands(x, s_attn, s_mlp, w, H,
                                            "fused_block_bwd")
    name = kernel_entry("fused_block_bwd", x)
    g_out = g_out.to(x.dtype).contiguous()
    if g_feat is not None:
        g_feat = g_feat.to(x.dtype).contiguous()
    F = ws[8].shape[0]
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        dws = tuple(torch.empty(t.shape, dtype=torch.float32, device=x.device)
                    for t in ws)
        work = _workspace(name, x, H, F)
        _launch(name, [_ptr(t) for t in (x, s_attn, s_mlp, *ws, g_out, g_feat, dx,
                                         *dws, work)],
                x, H, F, eps)
    return dx, dws


def _pair_operands(x, scales, w1, w2, H, name):
    """_kernel_operands for both blocks of a pair, which must have the same
    widths: (x, four scales, weights of block 1, weights of block 2); bf16 x
    (any float weights, rounded) or fp32 x with fp32 weights in both blocks,
    and ValueError before any launch for anything else."""
    x, sa1, sm1, ws1 = _kernel_operands(x, scales[0], scales[1], w1, H, name)
    _, sa2, sm2, ws2 = _kernel_operands(x, scales[2], scales[3], w2, H, name)
    if ws1[8].shape != ws2[8].shape:
        raise ValueError(f"{name}: the two blocks have hidden widths "
                         f"{ws1[8].shape[0]} and {ws2[8].shape[0]}")
    return x, (sa1, sm1, sa2, sm2), ws1, ws2


def fused_pair_fwd_cuda(x, scales, w1, w2, H, eps, nf1, nf2):
    """The pair forward kernel (csrc/fused_block_pair.cu) on CUDA tensors, in
    x's dtype (bf16, or fp32 in 3xTF32): (out, feat1|None, feat2|None)."""
    x, scales, ws1, ws2 = _pair_operands(x, scales, w1, w2, H, "fused_pair_fwd")
    name = kernel_entry("fused_pair_fwd", x)
    F = ws1[8].shape[0]
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        f1 = torch.empty_like(x) if nf1 else None
        f2 = torch.empty_like(x) if nf2 else None
        work = _workspace(name, x, H, F)
        _launch(name, [_ptr(t) for t in (x, *scales, *ws1, *ws2, out, f1, f2, work)],
                x, H, F, eps)
    return out, f1, f2


def fused_pair_bwd_cuda(x, scales, w1, w2, g_out, g_f1, g_f2, H, eps):
    """The pair backward kernel (csrc/fused_block_pair.cu) on CUDA tensors, in
    x's dtype (bf16, or fp32 in 3xTF32): dx in x's dtype and the 12 + 12
    fp32 weight grads summed over the batch."""
    x, scales, ws1, ws2 = _pair_operands(x, scales, w1, w2, H, "fused_pair_bwd")
    name = kernel_entry("fused_pair_bwd", x)
    g_out, g_f1, g_f2 = (None if g is None else g.to(x.dtype).contiguous()
                         for g in (g_out, g_f1, g_f2))
    F = ws1[8].shape[0]
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        dws = tuple(torch.empty(t.shape, dtype=torch.float32, device=x.device)
                    for t in ws1 + ws2)
        work = _workspace(name, x, H, F)
        _launch(name, [_ptr(t) for t in (x, *scales, *ws1, *ws2, g_out, g_f1, g_f2,
                                         dx, *dws, work)],
                x, H, F, eps)
    return dx, dws


# -----------------------------------------------------------------------------
# Dispatch and autograd
# -----------------------------------------------------------------------------

def block_fwd(x, s_attn, s_mlp, w, H, eps, need_feat):
    """(out, feat|None): the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if x.device.type == "cpu":
        return _plain_fwd(x, s_attn, s_mlp, w, H, eps, need_feat)
    if x.device.type == "cuda":
        return fused_block_fwd_cuda(x, s_attn, s_mlp, w, H, eps, need_feat)
    raise ValueError(f"fused block: no implementation for device {x.device}")


def block_bwd(x, s_attn, s_mlp, w, g_out, g_feat, H, eps):
    """(dx, 12 fp32 weight grads): the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return _plain_bwd(x, s_attn, s_mlp, w, g_out, g_feat, H, eps)
    if x.device.type == "cuda":
        return fused_block_bwd_cuda(x, s_attn, s_mlp, w, g_out, g_feat, H, eps)
    raise ValueError(f"fused block: no implementation for device {x.device}")


class _FusedBlock(torch.autograd.Function):
    """Saves only x, the scales and the weights; the backward recomputes."""

    @staticmethod
    def forward(ctx, x, s_attn, s_mlp, num_heads, eps, need_feat, *w):
        ctx.save_for_backward(x, s_attn, s_mlp, *w)
        ctx.cfg = (num_heads, eps, need_feat)
        out, feat = block_fwd(x, s_attn, s_mlp, w, num_heads, eps, need_feat)
        return (out, feat) if need_feat else out

    @staticmethod
    def backward(ctx, g_out, g_feat=None):
        x, s_attn, s_mlp, *w = ctx.saved_tensors
        num_heads, eps, need_feat = ctx.cfg
        dx, dws = block_bwd(x, s_attn, s_mlp, w, g_out,
                            g_feat if need_feat else None, num_heads, eps)
        # the drop-path scales are non-trainable masks: zero cotangent (None)
        return (dx, None, None, None, None, None,
                *(d.to(t.dtype) for d, t in zip(dws, w)))


def pair_fwd(x, scales, w1, w2, H, eps, nf1, nf2):
    """(out, feat1|None, feat2|None): the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return _plain_pair_fwd(x, scales, w1, w2, H, eps, nf1, nf2)
    if x.device.type == "cuda":
        return fused_pair_fwd_cuda(x, scales, w1, w2, H, eps, nf1, nf2)
    raise ValueError(f"fused block pair: no implementation for device {x.device}")


def pair_bwd(x, scales, w1, w2, g_out, g_f1, g_f2, H, eps):
    """(dx, 24 fp32 weight grads): the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    if x.device.type == "cpu":
        return _plain_pair_bwd(x, scales, w1, w2, g_out, g_f1, g_f2, H, eps)
    if x.device.type == "cuda":
        return fused_pair_bwd_cuda(x, scales, w1, w2, g_out, g_f1, g_f2, H, eps)
    raise ValueError(f"fused block pair: no implementation for device {x.device}")


class _FusedPair(torch.autograd.Function):
    """Two blocks as one function: saves x, the four scales and the 24
    weights; the backward recomputes both blocks. With ``single_forward`` the
    forward runs as two single-block forwards (so the activation between them
    is rounded to x's dtype) and only the backward is the pair's: an
    attribution variant that no model path selects."""

    @staticmethod
    def forward(ctx, x, sa1, sm1, sa2, sm2, num_heads, eps, nf1, nf2,
                single_forward, *w):
        n = len(PARAM_NAMES)
        w1, w2 = w[:n], w[n:]
        ctx.save_for_backward(x, sa1, sm1, sa2, sm2, *w)
        ctx.cfg = (num_heads, eps, nf1, nf2)
        if single_forward:
            mid, f1 = block_fwd(x, sa1, sm1, w1, num_heads, eps, nf1)
            out, f2 = block_fwd(mid, sa2, sm2, w2, num_heads, eps, nf2)
        else:
            out, f1, f2 = pair_fwd(x, (sa1, sm1, sa2, sm2), w1, w2, num_heads,
                                   eps, nf1, nf2)
        return (out, *(f for f in (f1, f2) if f is not None))

    @staticmethod
    def backward(ctx, g_out, *g_feats):
        x, sa1, sm1, sa2, sm2, *w = ctx.saved_tensors
        num_heads, eps, nf1, nf2 = ctx.cfg
        n = len(PARAM_NAMES)
        g_feats = list(g_feats)
        g_f1 = g_feats.pop(0) if nf1 else None
        g_f2 = g_feats.pop(0) if nf2 else None
        dx, dws = pair_bwd(x, (sa1, sm1, sa2, sm2), w[:n], w[n:], g_out, g_f1,
                           g_f2, num_heads, eps)
        # the drop-path scales are non-trainable masks: zero cotangent (None)
        return (dx, *([None] * 9), *(d.to(t.dtype) for d, t in zip(dws, w)))


def _scales(s, x):
    B = x.shape[0]
    if s is None:
        return torch.ones(B, dtype=torch.float32, device=x.device)
    return s.reshape(B).float()


def block_params(params: Mapping[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """A block's parameters (timm names) in the kernels' operand order."""
    return tuple(params[n] for n in PARAM_NAMES)


def fused_vit_block(x: torch.Tensor, params: Mapping[str, torch.Tensor], *,
                    num_heads: int, ln_eps: float = 1e-6,
                    scale_attn: Optional[torch.Tensor] = None,
                    scale_mlp: Optional[torch.Tensor] = None,
                    need_features: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply one fused pre-norm ViT block.

    x: [B, N, D]; params: the block's parameters by timm name (``norm1.weight``,
    ``attn.qkv.weight``, ...); scale_attn/scale_mlp: per-sample [B] drop-path
    branch scales (None = 1). Returns (out, features), features None when
    need_features is False.
    """
    res = _FusedBlock.apply(x, _scales(scale_attn, x), _scales(scale_mlp, x),
                            num_heads, ln_eps, need_features,
                            *block_params(params))
    return res if need_features else (res, None)


def reference_vit_block(x, params, *, num_heads, ln_eps=1e-6, scale_attn=None,
                        scale_mlp=None):
    """Plain PyTorch forward of the block on any device: (out, feat)."""
    return _plain_fwd(x, _scales(scale_attn, x), _scales(scale_mlp, x),
                      block_params(params), num_heads, ln_eps, True)


def reference_vit_block_bwd(x, params, g_out, g_feat=None, *, num_heads,
                            ln_eps=1e-6, scale_attn=None, scale_mlp=None):
    """Plain PyTorch backward of the block on any device: (dx, weight grads
    by timm name)."""
    dx, dws = _plain_bwd(x, _scales(scale_attn, x), _scales(scale_mlp, x),
                         block_params(params), g_out, g_feat, num_heads, ln_eps)
    return dx, dict(zip(PARAM_NAMES, dws))


def kernel_block_fwd(x, params, *, num_heads, ln_eps=1e-6, scale_attn=None,
                     scale_mlp=None, need_features=True):
    """The forward kernel alone, no autograd (CUDA tensors)."""
    return fused_block_fwd_cuda(x, _scales(scale_attn, x), _scales(scale_mlp, x),
                                block_params(params), num_heads, ln_eps,
                                need_features)


def kernel_block_bwd(x, params, g_out, g_feat=None, *, num_heads, ln_eps=1e-6,
                     scale_attn=None, scale_mlp=None):
    """The backward kernel alone (CUDA tensors): (dx, weight grads by name)."""
    dx, dws = fused_block_bwd_cuda(x, _scales(scale_attn, x),
                                   _scales(scale_mlp, x), block_params(params),
                                   g_out, g_feat, num_heads, ln_eps)
    return dx, dict(zip(PARAM_NAMES, dws))


def plain_weight_grad(g, x, dtype=torch.bfloat16):
    """What one weight gradient of the block backward computes
    (csrc/gemm_sm90.cuh ``weight_grad_kernel``), on any device: the fp32
    [O, I] sum over all rows of g[m, o] x[m, i], g [..., O] and x [..., I]
    with their leading dims flattened into rows and both rounded to
    ``dtype``: an nn.Linear's weight gradient from its output cotangent and
    its input."""
    return _mm(g.reshape(-1, g.shape[-1]).t(), x.reshape(-1, x.shape[-1]), dtype)


def kernel_weight_grad(g, x):
    """One weight gradient of the block backward alone, on its TMA + wgmma
    GEMM (``dk_weight_grad_sm90``: fp32 partials over row ranges, summed in a
    fixed order; for fp32 g and x its fp32 form ``dk_weight_grad_sm90_f32``,
    3xTF32), no autograd; CUDA tensors: g [M, O] and x [M, I], both bf16 or
    both fp32, with O and I multiples of 8. No model path calls it. Returns
    what :func:`plain_weight_grad` returns at their dtype."""
    if (g.dim() != 2 or x.dim() != 2 or g.shape[0] != x.shape[0]
            or g.dtype not in (torch.bfloat16, torch.float32) or x.dtype != g.dtype
            or g.device.type != "cuda" or x.device != g.device
            or g.shape[1] % 8 or x.shape[1] % 8):
        raise ValueError(f"weight grad: takes CUDA g [M, O] and x [M, I], both bf16 or both "
                         f"fp32, with O, I multiples of 8, got {g.dtype} {tuple(g.shape)} and "
                         f"{x.dtype} {tuple(x.shape)} on {g.device}")
    M, O = g.shape
    I = x.shape[1]
    g, x = g.contiguous(), x.contiguous()
    name = "weight_grad_sm90" + ("_f32" if g.dtype == torch.float32 else "")
    lib = _library("fused_block_bwd")
    with torch.cuda.device(g.device):
        partial = torch.empty(getattr(lib, f"dk_{name}_workspace")(M, O, I), dtype=torch.uint8,
                              device=g.device)
        out = torch.empty((O, I), dtype=torch.float32, device=g.device)
        err = getattr(lib, f"dk_{name}")(g.data_ptr(), x.data_ptr(), M, O, I, partial.data_ptr(),
                                         out.data_ptr(),
                                         torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[(name, O)] += 1
    return out


def plain_linear(a, w, bias=None, *, scale_cols=0, col_scale=1.0, mul=None, gelu=False,
                 residual=None, res_scale=None, rows_per_sample=1, dtype=torch.bfloat16):
    """What one linear product of the block forward or one input gradient of
    its backward computes (csrc/gemm_sm90.cuh), on any device: v = a w^T with
    operands rounded to ``dtype`` (bf16, or fp32 for the fp32 form) and fp32
    accumulation (a [M, K], w [N, K]), + bias, the first ``scale_cols``
    columns times ``col_scale``, times ``mul`` (fp32 [M, N]), then GELU;
    with a ``residual`` r, out = r + res_scale[row // rows_per_sample] * v.
    Returns (out fp32, out in ``dtype``, v before the residual in ``dtype``,
    gelu' before the GELU in fp32 or None)."""
    v = _mm(a, w.t(), dtype)
    if bias is not None:
        v = v + bias.float()
    if scale_cols:
        v = torch.cat([v[:, :scale_cols] * col_scale, v[:, scale_cols:]], dim=1)
    if mul is not None:
        v = v * mul.float()
    grad = None
    if gelu:
        v, grad = _gelu_and_grad(v)
    pre = v.to(dtype)
    if residual is not None:
        row_scale = res_scale.float().repeat_interleave(rows_per_sample)
        v = residual.float() + row_scale[:, None] * v
    return v, v.to(dtype), pre, grad


def kernel_linear(a, w, bias=None, *, scale_cols=0, col_scale=1.0, mul=None, gelu=False,
                  residual=None, res_scale=None, rows_per_sample=1,
                  outputs=("f32", "bf16", "pre", "grad"), col_part=None):
    """One linear product alone, on the block's TMA + wgmma GEMM
    (``dk_linear_sm90``; for fp32 a and w its fp32 form ``dk_linear_sm90_f32``,
    3xTF32, which splits w into TF32 parts first, as the fp32 chains do), no
    autograd; CUDA tensors: a [M, K] and w [N, K], both bf16 or both fp32,
    with N and K multiples of 8, bias fp32, mul fp32 [M, N] or a residual
    fp32 or bf16 [M, N] with res_scale fp32 [M // rows_per_sample] (not
    both). An input gradient dX = G W of the backward is
    ``kernel_linear(G, W.t())``. ``outputs`` names those to write ("bf16" is
    the output as a product operand, in a's dtype; "grad" only with
    ``gelu``). With ``mul``, ``col_part`` (fp32 [ceil(M / 128), N]) takes
    the column sums of each 128-row tile of v after the multiplier, as the
    backward's fc2 input gradient writes them. No model path calls it.
    Returns what :func:`plain_linear` returns at a's dtype, None for each
    output not asked for."""
    M, K = a.shape
    N = w.shape[0]
    if (a.dtype not in (torch.bfloat16, torch.float32) or w.dtype != a.dtype
            or w.shape[1] != K or a.device.type != "cuda" or w.device != a.device
            or N % 8 or K % 8):
        raise ValueError(f"linear: takes CUDA a [M, K] and w [N, K], both bf16 or both fp32, "
                         f"with N, K multiples of 8, got {a.dtype} {tuple(a.shape)} and "
                         f"{w.dtype} {tuple(w.shape)} on {a.device}")
    if (residual is None) != (res_scale is None):
        raise ValueError("linear: a residual needs its res_scale and the other way round")
    if mul is not None and residual is not None:
        raise ValueError("linear: the GEMM takes mul or a residual, not both")
    a, w = a.contiguous(), w.contiguous()
    if residual is not None:
        residual = residual.contiguous()
        res_scale = res_scale.float().contiguous()
    if bias is not None:
        bias = bias.float().contiguous()
    if mul is not None:
        if tuple(mul.shape) != (M, N) or mul.device != a.device:
            raise ValueError(f"linear: mul must be [{M}, {N}] on {a.device}, got "
                             f"{tuple(mul.shape)} on {mul.device}")
        mul = mul.float().contiguous()
    if col_part is not None and (mul is None or col_part.dtype != torch.float32
                                 or tuple(col_part.shape) != ((M + 127) // 128, N)
                                 or col_part.device != a.device
                                 or not col_part.is_contiguous()):
        raise ValueError(f"linear: col_part must be a contiguous fp32 [{(M + 127) // 128}, {N}] "
                         f"on {a.device}, with mul")

    def new(name, dtype):
        wanted = name in outputs and (name != "grad" or gelu)
        return torch.empty((M, N), dtype=dtype, device=a.device) if wanted else None

    name = "linear_sm90" + ("_f32" if a.dtype == torch.float32 else "")
    lib = _library("fused_block_fwd")
    with torch.cuda.device(a.device):
        out32, out_lp = new("f32", torch.float32), new("bf16", a.dtype)
        pre, grad = new("pre", a.dtype), new("grad", torch.float32)
        res32 = residual if residual is not None and residual.dtype == torch.float32 else None
        res_lp = residual if residual is not None and res32 is None else None
        ptrs = [_ptr(t) for t in (a, w, bias, grad, pre, res32, res_lp, res_scale, out32,
                                  out_lp, mul, col_part)]
        if name == "linear_sm90_f32":
            work = torch.empty(lib.dk_linear_sm90_f32_workspace(N, K), dtype=torch.uint8,
                               device=a.device)
            ptrs.append(work.data_ptr())
        table = (ctypes.c_void_p * len(ptrs))(*ptrs)
        err = getattr(lib, f"dk_{name}")(
            table, M, N, K, scale_cols, col_scale, int(gelu), rows_per_sample,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"linear: CUDA error {err} at launch")
    LAUNCHES[(name, N)] += 1
    return out32, out_lp, pre, grad


def _tf32_rna(v):
    """fp32 v rounded to nearest TF32, ties away from zero (the card's
    cvt.rna.tf32.f32): half the weight of the 13 low bits added to the
    magnitude's bit pattern, then those bits cleared; inf and NaN as they
    are."""
    bits = v.view(torch.int32)
    return torch.where(torch.isfinite(v), ((bits + 0x1000) & -0x2000).view(torch.float32), v)


def tf32_split(w):
    """The fp32 weight operand of the fp32 linear GEMM as the card's split
    writes it (csrc/gemm_sm90.cuh ``split_weights_tf32_kernel``; an input
    gradient's W^T is ``tf32_split(W.t())``), on any device: (hi, lo, cols)
    with hi = TF32(w) rounded to nearest (ties away from zero), lo = TF32(w -
    hi), both fp32 [R, C] with the columns of each k-step of 8 permuted:
    column j holds w's column cols[j], 2 (j % 4) + j // 4 of its k-step (C a
    multiple of 8). The plain version the split kernels are held to; only
    the tests and chip_smoke.py call it."""
    R, C = w.shape
    if C % 8:
        raise ValueError(f"tf32_split: takes C a multiple of 8, got {tuple(w.shape)}")
    j = torch.arange(C, device=w.device)
    cols = (j & ~7) | (2 * (j & 3) + ((j & 7) >> 2))
    w = w.float()[:, cols]
    hi = _tf32_rna(w)
    return hi, _tf32_rna(w - hi), cols


def kernel_tf32_split(w, transposed=False):
    """The card's split of an fp32 weight alone (``dk_tf32_split``: the
    forward's ``split_weights_tf32_kernel``, or with ``transposed`` the
    backward's ``transpose_kernel`` of w^T), no model path calls it; CUDA
    fp32 w [R, C] with C (R when transposed) a multiple of 8. Returns the
    (hi, lo) of :func:`tf32_split` of w (of w^T when transposed)."""
    if (w.dtype != torch.float32 or w.dim() != 2 or w.device.type != "cuda"
            or w.shape[0 if transposed else 1] % 8):
        raise ValueError(f"tf32_split: takes a CUDA fp32 [R, C] weight with "
                         f"{'R' if transposed else 'C'} a multiple of 8, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    w = w.contiguous()
    R, C = w.shape
    with torch.cuda.device(w.device):
        out = torch.empty((2, C, R) if transposed else (2, R, C), dtype=torch.float32,
                          device=w.device)
        err = _library("fused_block_fwd").dk_tf32_split(
            w.data_ptr(), R, C, int(transposed), out.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream)
    if err:
        raise RuntimeError(f"tf32_split: CUDA error {err} at launch")
    LAUNCHES[("tf32_split", out.shape[2])] += 1
    return out[0], out[1]


def fused_vit_block_pair(x: torch.Tensor, params1: Mapping[str, torch.Tensor],
                         params2: Mapping[str, torch.Tensor], *, num_heads: int,
                         ln_eps: float = 1e-6,
                         scale_attn1: Optional[torch.Tensor] = None,
                         scale_mlp1: Optional[torch.Tensor] = None,
                         scale_attn2: Optional[torch.Tensor] = None,
                         scale_mlp2: Optional[torch.Tensor] = None,
                         need_features1: bool = True, need_features2: bool = True,
                         single_forward: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                    Optional[torch.Tensor]]:
    """Apply two consecutive fused pre-norm ViT blocks as one function.

    The contract of two chained :func:`fused_vit_block` calls, except that the
    activation between the blocks stays fp32. Returns (out, feat1, feat2),
    a feature None when not asked for. ``single_forward`` (the JAX package's
    ``DELTAKD_PAIR_HYBRID=1``) runs the forward as two single-block forwards
    and only the backward as the pair: for attributing a time difference to
    one half, not for training.
    """
    outs = list(_FusedPair.apply(
        x, *(_scales(s, x) for s in (scale_attn1, scale_mlp1, scale_attn2, scale_mlp2)),
        num_heads, ln_eps, need_features1, need_features2, single_forward,
        *block_params(params1), *block_params(params2)))
    out = outs.pop(0)
    f1 = outs.pop(0) if need_features1 else None
    f2 = outs.pop(0) if need_features2 else None
    return out, f1, f2


def best_block_pair_fn(enabled: bool = True):
    """block_pair_fn for VisionTransformer: ``fused_vit_block_pair`` or None
    (single blocks). The device of the input decides at call time between the
    kernels and the plain version."""
    return fused_vit_block_pair if enabled else None


def _pair_scales(x, scales):
    return tuple(_scales(s, x) for s in (scales or (None,) * 4))


def reference_vit_block_pair(x, params1, params2, *, num_heads, ln_eps=1e-6,
                             scales=None):
    """Plain PyTorch forward of the pair on any device: (out, feat1, feat2).
    ``scales`` is (scale_attn1, scale_mlp1, scale_attn2, scale_mlp2) or None."""
    return _plain_pair_fwd(x, _pair_scales(x, scales), block_params(params1),
                           block_params(params2), num_heads, ln_eps, True, True)


def _named_pair_grads(dws):
    n = len(PARAM_NAMES)
    return dict(zip(PARAM_NAMES, dws[:n])), dict(zip(PARAM_NAMES, dws[n:]))


def reference_vit_block_pair_bwd(x, params1, params2, g_out, g_feat1=None,
                                 g_feat2=None, *, num_heads, ln_eps=1e-6, scales=None):
    """Plain PyTorch backward of the pair on any device: (dx, block 1's weight
    grads by timm name, block 2's)."""
    dx, dws = _plain_pair_bwd(x, _pair_scales(x, scales), block_params(params1),
                              block_params(params2), g_out, g_feat1, g_feat2,
                              num_heads, ln_eps)
    return (dx, *_named_pair_grads(dws))


def kernel_block_pair_fwd(x, params1, params2, *, num_heads, ln_eps=1e-6, scales=None,
                          need_features1=True, need_features2=True):
    """The pair forward kernel alone, no autograd (CUDA tensors)."""
    return fused_pair_fwd_cuda(x, _pair_scales(x, scales), block_params(params1),
                               block_params(params2), num_heads, ln_eps,
                               need_features1, need_features2)


def kernel_block_pair_bwd(x, params1, params2, g_out, g_feat1=None, g_feat2=None, *,
                          num_heads, ln_eps=1e-6, scales=None):
    """The pair backward kernel alone (CUDA tensors): (dx, block 1's weight
    grads by name, block 2's)."""
    dx, dws = fused_pair_bwd_cuda(x, _pair_scales(x, scales), block_params(params1),
                                  block_params(params2), g_out, g_feat1, g_feat2,
                                  num_heads, ln_eps)
    return (dx, *_named_pair_grads(dws))
