"""Auxiliary distillation heads (``deltakd_tpu/kd/aux.py``): the layers that
the feature-KD objectives train beside the student (align linears, the mask
token, the conv3x3-ReLU-conv3x3 generation head, DiffKD's denoiser and the
saliency attention projections) and the functions that apply them.

``AuxHeads`` is the counterpart of ``init_aux_params``: one module per
distillation type whose parameter names keep the JAX tree's keys
(``align_wasskd.0``, ``align2.1``, ``align``, ``mask_token``,
``generation.conv1``, ``denoise.time1``, ``saliency_attn.qk``,
``curkd_align_mid.3``), with nn.Linear / nn.Conv2d layouts (``weight``
[out, in] and OIHW for the JAX ``kernel`` [in, out] and HWIO).
Initialisation follows the torch defaults the reference relies on: weights
and biases from U(-1/sqrt(fan_in), 1/sqrt(fan_in)), ``mask_token`` zero.

The functions keep the JAX package's layouts at their boundary: ``conv3x3``
and ``generation_apply`` take and return NHWC grids.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


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


class Denoise(nn.Module):
    """DiffKD's denoising network over ``dim`` channels: a time embedding
    (Linear(1, dim) -> GELU -> Linear) and Linear(dim, 2 dim) -> GELU ->
    Linear(2 dim, dim)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net1 = nn.Linear(dim, dim * 2)
        self.net2 = nn.Linear(dim * 2, dim)
        self.time1 = nn.Linear(1, dim)
        self.time2 = nn.Linear(dim, dim)


def denoise_apply(p: Denoise, x: torch.Tensor, t: torch.Tensor,
                  generator: Optional[torch.Generator] = None, train: bool = True, *,
                  keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, N, D] + time_embed(t [B]) broadcast over tokens, then
    Linear -> GELU -> Linear -> Dropout(0.1). In training the keep mask
    (True = kept, probability 0.9) is drawn from ``generator`` unless
    ``keep`` [B, N, D] is given; with neither, or ``train`` False, no
    dropout."""
    t_emb = t.to(x.dtype).reshape(-1, 1)
    t_emb = dense(p.time2, F.gelu(dense(p.time1, t_emb)))
    h = x + t_emb[:, None, :]
    h = dense(p.net2, F.gelu(dense(p.net1, h)))
    if train and (keep is not None or generator is not None):
        if keep is None:
            keep = torch.rand(h.shape, generator=generator, device=h.device) < 0.9
        h = torch.where(keep, h / 0.9, 0.0).to(h.dtype)
    return h


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, heads, N, C / heads]."""
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _head_mean_softmax(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) in fp32, averaged over the heads."""
    attn = torch.matmul(q.float(), k.float().transpose(-2, -1)) * (q.shape[-1] ** -0.5)
    return torch.softmax(attn, dim=-1).mean(dim=1)


def simple_attention_scores(p: nn.Module, x: torch.Tensor, num_heads: int = 8,
                            diagonal: bool = True) -> torch.Tensor:
    """SimpleAttention: self-attention from the fused ``p.qk`` projection;
    the head-mean attention diagonal [B, N] (or the whole map [B, N, N])."""
    q, k = dense(p.qk, x).chunk(2, dim=-1)
    attn = _head_mean_softmax(_heads(q, num_heads), _heads(k, num_heads))
    return torch.diagonal(attn, dim1=-2, dim2=-1) if diagonal else attn


def simple_attention_cls_row(p: nn.Module, x: torch.Tensor, num_heads: int = 8
                             ) -> torch.Tensor:
    """Saliency method 2: the CLS query's head-mean attention row over all
    tokens from the ``p.qk`` projection -> [B, N]."""
    q, k = dense(p.qk, x).chunk(2, dim=-1)
    return _head_mean_softmax(_heads(q[:, :1], num_heads), _heads(k, num_heads))[:, 0]


def cross_attention_scores(p: nn.Module, x_query: torch.Tensor, x_key: torch.Tensor,
                           num_heads: int = 8) -> torch.Tensor:
    """SimpleCrossAttention: separate ``p.q`` / ``p.k`` projections, the
    head-mean attention of the query rows over the keys -> [B, Nq, Nk]."""
    return _head_mean_softmax(_heads(dense(p.q, x_query), num_heads),
                              _heads(dense(p.k, x_key), num_heads))


class AuxHeads(nn.Module):
    """The aux heads of one feature distillation type, drawn from
    ``generator``; ``lrkd_rank`` sizes LRKD's align layers and
    ``saliency_method`` picks Saliency-MGD's attention (``qk`` for methods 1
    and 2, ``q`` and ``k`` for method 3)."""

    def __init__(self, distillation_type: str, student_dim: int, teacher_dim: int,
                 generator: torch.Generator, *, lrkd_rank: int = 32,
                 saliency_method: int = 1):
        super().__init__()
        t = distillation_type.lower()

        def align(n=None, out=teacher_dim):
            if n is None:
                return nn.Linear(student_dim, out)
            return nn.ModuleList(nn.Linear(student_dim, out) for _ in range(n))

        def masked_generation():
            self.mask_token = nn.Parameter(torch.zeros(1, 1, teacher_dim))
            self.generation = Generation(teacher_dim)

        if t == "vitkd":
            self.align2 = align(2)
            self.align = align()
            masked_generation()
        elif t == "lrkd":
            self.align = align(3, out=lrkd_rank)
        elif t == "diffkd":
            self.denoise = Denoise(teacher_dim)
            self.align = align(3)
        elif t == "saliency_mgd":
            if saliency_method not in (1, 2, 3):
                raise ValueError(f"Invalid saliency masking method: {saliency_method}")
            self.align = align()
            masked_generation()
            self.saliency_attn = nn.Module()
            if saliency_method in (1, 2):
                self.saliency_attn.qk = nn.Linear(teacher_dim, teacher_dim * 2)
            else:
                self.saliency_attn.q = nn.Linear(teacher_dim, teacher_dim)
                self.saliency_attn.k = nn.Linear(teacher_dim, teacher_dim)
        elif t == "mgd":
            self.align = align()
            masked_generation()
        elif t == "curkd":
            self.curkd_align_early = align(3)
            self.curkd_align_mid = align(4)
            self.curkd_align_last = align()
            masked_generation()
        elif t == "wasskd":
            self.align_wasskd = align(3)
        else:
            raise ValueError(f"distillation type '{t}' has no aux heads")
        self._torch_default_init(generator)

    def _torch_default_init(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    bound = 1.0 / math.sqrt(m.weight[0].numel())   # 1/sqrt(fan_in)
                    for p in (m.weight, m.bias):
                        p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                              generator=generator))
