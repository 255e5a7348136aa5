"""Fused pre-norm ViT block: plain PyTorch versions, CUDA kernel wrappers and
the autograd Function that joins them.

Counterpart of ``deltakd_tpu/ops/fused_block.py``. One block computes

    x2  = x  + s_attn * proj(attention(LN1(x)))
    out = x2 + s_mlp  * feat,    feat = fc2(gelu(fc1(LN2(x2))))

with per-sample drop-path scales ``s_attn``/``s_mlp`` (0 or 1/keep under
stochastic depth, 1 otherwise) and ``feat`` the post-MLP, pre-drop-path,
pre-residual hidden state a feature-KD objective reads.

Numerics follow the TPU kernel: matmul operands are rounded to the compute
dtype (bf16 on the card) and accumulated in fp32; LayerNorm, softmax, GELU and
the residual stream run in fp32; the softmax normalisation is applied after
the ``e @ v`` product (``post_div``). The backward saves only ``x`` and the
scales and recomputes the forward, then folds the softmax normalisations into
row scalings.

Dispatch is by the device of ``x``: a CPU tensor takes the plain version, a
CUDA tensor the hand-written kernels in ``csrc/`` (bf16 only), anything else
raises. Weights use nn.Linear's [out, in] layout and timm's names.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Mapping, Optional, Tuple

import torch

# timm names of one block's parameters, in the kernels' operand order
# (_weight_arrays in the JAX package: g1, b1, wqkv, bqkv, wproj, bproj, g2,
# b2, w1, bf1, w2, bf2).
PARAM_NAMES = ("norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias",
               "attn.proj.weight", "attn.proj.bias", "norm2.weight", "norm2.bias",
               "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")
_MATMUL_WEIGHTS = (2, 4, 8, 10)

# Kernel launches by (kernel name, embed width). Each wrapper adds one where
# it launches its kernel; nothing else touches the count.
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


def _block_fwd_stash(x32, w, s_attn, eps, H, dtype):
    """Forward up to the GELU, keeping what the reverse sweep needs
    (_block_fwd_stash / _attention_fwd_stash); the softmax normalisation is
    applied to the e @ v product (post_div)."""
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
    return x2, (y, qkv, e, rs, merged, xhat1, rstd1, xhat2, rstd2, z, h, hgrad)


def _plain_fwd(x, s_attn, s_mlp, w, H, eps, need_feat):
    """reference_vit_block on the kernel operand tuple ``w``."""
    x2, stash = _block_fwd_stash(x.float(), w, s_attn, eps, H, x.dtype)
    feat = _mm(stash[10], w[10].t(), x.dtype) + w[11]
    out = x2 + s_mlp.view(-1, 1, 1) * feat
    return out.to(x.dtype), (feat.to(x.dtype) if need_feat else None)


def _plain_bwd(x, s_attn, s_mlp, w, g_out, g_feat, H, eps):
    """Recompute + reverse sweep (_block_bwd_reverse, _attention_bwd_one).
    Returns dx in x's dtype and the 12 fp32 weight grads summed over the
    batch, in nn.Linear layout."""
    dtype = x.dtype
    scale = (x.shape[-1] // H) ** -0.5
    _, (y, qkv, e, rs, merged, xhat1, rstd1, xhat2, rstd2, z, h, hgrad) = \
        _block_fwd_stash(x.float(), w, s_attn, eps, H, dtype)
    g_out = g_out.float()
    rows = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731

    def wgrad(g, a):  # sum over rows of g^T a, operands rounded to dtype
        return _mm(rows(g).t(), rows(a), dtype)

    g_feat32 = g_out * s_mlp.view(-1, 1, 1)
    if g_feat is not None:
        g_feat32 = g_feat32 + g_feat.float()
    dw2 = wgrad(g_feat32, h)
    dbf2 = rows(g_feat32).sum(0)
    dhpre = _mm(g_feat32, w[10], dtype) * hgrad
    dw1 = wgrad(dhpre, z)
    dbf1 = rows(dhpre).sum(0)
    dz = _mm(dhpre, w[8], dtype)
    dx2 = g_out + _ln_bwd(dz, xhat2, rstd2, w[6])
    dg2 = rows(dz * xhat2).sum(0)
    db2 = rows(dz).sum(0)

    dattn = dx2 * s_attn.view(-1, 1, 1)
    dwproj = wgrad(dattn, merged)
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

    dwqkv = wgrad(dqkv, y)
    dbqkv = rows(dqkv).sum(0)
    dy = _mm(dqkv, w[2], dtype)
    dx = dx2 + _ln_bwd(dy, xhat1, rstd1, w[0])
    dg1 = rows(dy * xhat1).sum(0)
    db1 = rows(dy).sum(0)
    return dx.to(dtype), (dg1, db1, dwqkv, dbqkv, dwproj, dbproj, dg2, db2,
                          dw1, dbf1, dw2, dbf2)


# -----------------------------------------------------------------------------
# CUDA kernel wrappers
# -----------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _kernel_operands(x, s_attn, s_mlp, w, H, name):
    """Checks what the kernels take and returns (x, s_attn, s_mlp, weights)
    as contiguous tensors: x bf16 [B,N,D], scales fp32 [B], matmul weights
    bf16, LN params and biases fp32."""
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{name}: x must be bf16 [B, N, D], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, N, D = x.shape
    if D % H:
        raise ValueError(f"{name}: width {D} is not divisible by {H} heads")
    F = w[8].shape[0]
    shapes = ((D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,),
              (F, D), (F,), (D, F), (D,))
    for t, shape in zip(w, shapes):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{name}: weight of shape {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {x.device}")
    ws = tuple((t.to(torch.bfloat16) if i in _MATMUL_WEIGHTS else t.float()
                ).contiguous() for i, t in enumerate(w))
    scales = tuple(s.reshape(B).float().contiguous() for s in (s_attn, s_mlp))
    return x.contiguous(), scales[0], scales[1], ws


def _launch(name, ptrs, x, H, F, eps):
    from deltakd_tpu_torch.ops import _build

    lib = _build.library(name)
    B, N, D = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    table = (ctypes.c_void_p * len(ptrs))(*ptrs)
    err = getattr(lib, f"dk_{name}")(table, B, N, D, H, F, eps, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
    LAUNCHES[(name, D)] += 1


def _workspace(name, x, H, F):
    from deltakd_tpu_torch.ops import _build

    B, N, D = x.shape
    nbytes = getattr(_build.library(name), f"dk_{name}_workspace")(B, N, D, H, F)
    return torch.empty(nbytes, dtype=torch.uint8, device=x.device)


def fused_block_fwd_cuda(x, s_attn, s_mlp, w, H, eps, need_feat):
    """The forward kernel (csrc/fused_block_fwd.cu) on CUDA tensors."""
    x, s_attn, s_mlp, ws = _kernel_operands(x, s_attn, s_mlp, w, H,
                                            "fused_block_fwd")
    F = ws[8].shape[0]
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        feat = torch.empty_like(x) if need_feat else None
        work = _workspace("fused_block_fwd", x, H, F)
        _launch("fused_block_fwd",
                [_ptr(t) for t in (x, s_attn, s_mlp, *ws, out, feat, work)],
                x, H, F, eps)
    return out, feat


def fused_block_bwd_cuda(x, s_attn, s_mlp, w, g_out, g_feat, H, eps):
    """The backward kernel (csrc/fused_block_bwd.cu) on CUDA tensors:
    dx (bf16) and the 12 fp32 weight grads summed over the batch."""
    x, s_attn, s_mlp, ws = _kernel_operands(x, s_attn, s_mlp, w, H,
                                            "fused_block_bwd")
    g_out = g_out.to(torch.bfloat16).contiguous()
    if g_feat is not None:
        g_feat = g_feat.to(torch.bfloat16).contiguous()
    F = ws[8].shape[0]
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        dws = tuple(torch.empty(t.shape, dtype=torch.float32, device=x.device)
                    for t in ws)
        work = _workspace("fused_block_bwd", x, H, F)
        _launch("fused_block_bwd",
                [_ptr(t) for t in (x, s_attn, s_mlp, *ws, g_out, g_feat, dx,
                                   *dws, work)],
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

