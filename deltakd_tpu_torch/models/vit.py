"""DeiT / ViT in PyTorch with explicit per-block MLP intermediates.

Counterpart of ``deltakd_tpu/models/vit.py``, with timm's parameter names
(``patch_embed.proj.weight``, ``blocks.0.attn.qkv.weight``, ...) so a timm
checkpoint loads natively. The contract is the JAX model's:

* images arrive NHWC ([B, H, W, 3]), as in the JAX package;
* compute runs in ``dtype`` (bf16 by default) over fp32 parameters;
* each block's feature is its post-MLP, pre-drop-path, pre-residual hidden;
* LayerNorm eps is 1e-6; drop-path rates ramp linearly across depth;
* with ``drop_rate`` > 0, train mode drops tokens after the position
  embedding as flax ``nn.Dropout`` does (keep with probability 1 - p, kept
  values scaled by 1 / (1 - p)), the mask drawn from the step's generator;
* a distilled model returns ``(cls, dist)`` logits in train mode and the
  average of the two heads in eval mode.

With ``block_fn`` set (the fused block, ``ops/fused_block.fused_vit_block``)
and a qkv bias, each block runs as one fused call and only the features a KD
objective reads are written. With ``block_pair_fn`` too
(``ops/fused_block.fused_vit_block_pair``) blocks ``i``, ``i + 1`` run as one
call and an odd last block through ``block_fn``; each block keeps its own
parameters and drop-path scales, so a ``state_dict`` and the masks drawn from
a generator are the same with and without pairing. Otherwise the unfused
module path below runs (the path of a model without a qkv bias, and of tensor parallelism in the JAX
package): LayerNorms and the qkv / proj projections through PyTorch, the
attention core through ``attention_fn(q, k, v)`` on [B, H, N, head_dim]
(``ops/attention.flash_attention``) and the MLP through
``mlp_fn(x, fc1.weight, fc1.bias, fc2.weight, fc2.bias)``
(``ops/fused_mlp.fused_mlp``, forward only) when they are set, else through
PyTorch's matmul, softmax and GELU.

With ``tp`` (``parallel.mesh.ModelParallel``, a model axis of M > 1 ranks)
the model holds one rank's Megatron shards (``parallel/tensor.py``) and
runs the unfused path: qkv and fc1 split on their output features, proj and
fc2 on their input features, the row-parallel outputs summed over the model
group with their biases added once; the LayerNorms, residuals, drop-path
scales, token dropout, heads and features are replicated. Where M divides
the heads attention runs on the rank's H/M heads; otherwise (DeiT-Tiny's 3
heads over 2 ranks) the qkv output is gathered and attention runs on all
heads.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deltakd_tpu_torch.parallel.mesh import ModelParallel
from deltakd_tpu_torch.parallel.tensor import (copy_to_model, gather_from_model, heads_split,
                                               qkv_rows, reduce_from_model, shard_of,
                                               shard_parameters)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static architecture description (one per model-zoo name)."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 192
    depth: int = 12
    num_heads: int = 3
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    distilled: bool = False
    drop_path_rate: float = 0.0
    drop_rate: float = 0.0
    ln_eps: float = 1e-6

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        return 2 if self.distilled else 1


@dataclasses.dataclass
class ViTOutput:
    """Everything a KD objective may need from one forward pass."""

    logits: torch.Tensor                   # [B, C] cls head, or head average (distilled eval)
    logits_dist: Optional[torch.Tensor]    # [B, C] dist head (distilled models only)
    features: Tuple[Optional[torch.Tensor], ...]  # depth x [B, N, D] (None: not collected)


def _linear(x, layer: nn.Linear, dtype):
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(x, layer: nn.LayerNorm, dtype):
    """Statistics in fp32, output in the compute dtype (flax LayerNorm)."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight,
                        layer.bias, layer.eps).to(dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 tp: Optional[ModelParallel] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.tp = tp if tp is not None and tp.active else None
        if self.tp is not None:
            # the qkv bias is replicated (below 2-D); each rank adds the
            # entries of its own rows
            self.register_buffer("qkv_rows", qkv_rows(dim, num_heads, tp.size, tp.rank),
                                 persistent=False)

    def forward(self, x, dtype, attention_fn: Optional[Callable] = None):
        B, N, D = x.shape
        hd = D // self.num_heads
        if self.tp is not None:
            return self._forward_sharded(x, dtype, attention_fn)
        qkv = _linear(x, self.qkv, dtype).reshape(B, N, 3, self.num_heads, hd)
        out = _attend(qkv, dtype, attention_fn)
        return _linear(out.reshape(B, N, D), self.proj, dtype)

    def _forward_sharded(self, x, dtype, attention_fn):
        """Column-parallel qkv, row-parallel proj. Where M divides the heads
        the rank's qkv rows are its heads' q, k and v and attention runs on
        those; otherwise the qkv output is gathered, attention runs on every
        head and the rank keeps its D/M columns for proj."""
        tp, (B, N, D) = self.tp, x.shape
        hd = D // self.num_heads
        bias = self.qkv.bias
        if bias is not None:
            bias = shard_of(bias, self.qkv_rows, tp).to(dtype)
        qkv = F.linear(copy_to_model(x, tp).to(dtype), self.qkv.weight.to(dtype), bias)
        if heads_split(self.num_heads, tp.size):
            out = _attend(qkv.reshape(B, N, 3, self.num_heads // tp.size, hd), dtype,
                          attention_fn)
        else:
            qkv = gather_from_model(qkv, tp).reshape(B, N, 3, self.num_heads, hd)
            out = _attend(qkv, dtype, attention_fn).reshape(B, N, D)
            out = out.chunk(tp.size, dim=-1)[tp.rank]
        partial = F.linear(out.reshape(B, N, -1), self.proj.weight.to(dtype))
        return _row_parallel_out(partial, self.proj.bias, dtype, tp)


def _attend(qkv, dtype, attention_fn):
    """Attention on qkv [B, N, 3, H, hd] -> [B, N, H, hd]."""
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if attention_fn is not None:
        out = attention_fn(q, k, v)
    else:
        s = torch.matmul((q * q.shape[-1] ** -0.5).float(), k.float().transpose(-1, -2))
        p = torch.softmax(s, dim=-1).to(dtype)
        out = torch.matmul(p, v)
    return out.transpose(1, 2)


def _row_parallel_out(partial, bias, dtype, tp):
    """The model ranks' sum of the row-parallel partial products (summed in
    fp32), the bias added once."""
    return (reduce_from_model(partial.float(), tp) + bias.to(dtype).float()).to(dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, tp: Optional[ModelParallel] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.tp = tp if tp is not None and tp.active else None
        if self.tp is not None:
            w = hidden // tp.size
            self.register_buffer("fc1_rows", torch.arange(tp.rank * w, (tp.rank + 1) * w),
                                 persistent=False)

    def forward(self, x, dtype, mlp_fn: Optional[Callable] = None):
        if self.tp is not None:
            return self._forward_sharded(x, dtype, mlp_fn)
        if mlp_fn is not None:
            return mlp_fn(x.to(dtype), self.fc1.weight, self.fc1.bias,
                          self.fc2.weight, self.fc2.bias)
        h = F.gelu(_linear(x, self.fc1, dtype))
        return _linear(h, self.fc2, dtype)

    def _forward_sharded(self, x, dtype, mlp_fn):
        """Column-parallel fc1 on the rank's F/M hidden features, row-parallel
        fc2; ``mlp_fn`` runs on the shards with a zero fc2 bias."""
        tp = self.tp
        x = copy_to_model(x, tp).to(dtype)
        b1 = shard_of(self.fc1.bias, self.fc1_rows, tp)
        if mlp_fn is not None:
            partial = mlp_fn(x, self.fc1.weight, b1, self.fc2.weight,
                             torch.zeros_like(self.fc2.bias))
        else:
            h = F.gelu(F.linear(x, self.fc1.weight.to(dtype), b1.to(dtype)))
            partial = F.linear(h, self.fc2.weight.to(dtype))
        return _row_parallel_out(partial, self.fc2.bias, dtype, tp)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 ln_eps: float, tp: Optional[ModelParallel] = None):
        super().__init__()
        self.num_heads = num_heads
        self.ln_eps = ln_eps
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, tp)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), tp)

    def forward(self, x, dtype, scales: Optional[Tuple[torch.Tensor, torch.Tensor]],
                block_fn: Optional[Callable], collect: bool,
                attention_fn: Optional[Callable] = None,
                mlp_fn: Optional[Callable] = None):
        """Returns (x, feature); scales are the per-sample drop-path branch
        scales (s_attn, s_mlp) or None. ``block_fn`` runs the whole block and
        needs a qkv bias; without one the unfused path runs."""
        s_attn, s_mlp = scales if scales is not None else (None, None)
        if block_fn is not None and self.attn.qkv.bias is not None:
            return block_fn(x, dict(self.named_parameters()),
                            num_heads=self.num_heads, ln_eps=self.ln_eps,
                            scale_attn=s_attn, scale_mlp=s_mlp,
                            need_features=collect)
        y = self.attn(_layer_norm(x, self.norm1, dtype), dtype, attention_fn)
        if s_attn is not None:
            y = y * s_attn.view(-1, 1, 1).to(dtype)
        x = x + y
        mlp_out = self.mlp(_layer_norm(x, self.norm2, dtype), dtype, mlp_fn)
        z = mlp_out if s_mlp is None else mlp_out * s_mlp.view(-1, 1, 1).to(dtype)
        return x + z, mlp_out


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, dim, patch, patch)


class VisionTransformer(nn.Module):
    """DeiT/ViT backbone with the dual-head distilled variant."""

    def __init__(self, cfg: ViTConfig, *, dtype: torch.dtype = torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 mlp_fn: Optional[Callable] = None,
                 block_fn: Optional[Callable] = None,
                 block_pair_fn: Optional[Callable] = None, collect_features=True,
                 tp: Optional[ModelParallel] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        # block_fn (the whole block fused) wins where the model has a qkv bias;
        # otherwise the unfused path runs with attention_fn and mlp_fn
        self.attention_fn = attention_fn
        self.mlp_fn = mlp_fn
        self.block_fn = block_fn
        # two consecutive blocks per call, where the model has a qkv bias
        self.block_pair_fn = block_pair_fn
        # True/False, or a collection of the block indices whose features the
        # KD objective reads (kd.losses.feature_indices)
        self.collect_features = collect_features
        D = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.in_chans, D)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, D)) if cfg.distilled else None
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.num_prefix_tokens + cfg.num_patches, D))
        # the model axis: the blocks hold this rank's shards (load them with
        # parallel.tensor.shard_state_dict or load_full_state_dict)
        self.tp = tp if tp is not None and tp.active else None
        self._check_tp()
        self.blocks = nn.ModuleList(
            Block(D, cfg.num_heads, cfg.mlp_ratio, cfg.qkv_bias, cfg.ln_eps, self.tp)
            for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(D, eps=cfg.ln_eps)
        self.head = nn.Linear(D, cfg.num_classes)
        self.head_dist = nn.Linear(D, cfg.num_classes) if cfg.distilled else None
        if self.tp is not None:
            shard_parameters(self, cfg.num_heads, self.tp)

    def _check_tp(self):
        if self.tp is not None and (self.block_fn is not None
                                    or self.block_pair_fn is not None):
            raise ValueError("a model sharded over a model axis runs the unfused path: "
                             "the fused block and pair take whole weight matrices")

    def drop_path_rates(self):
        """timm's linspace(0, rate, depth) ramp."""
        cfg = self.cfg
        return [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
                for i in range(cfg.depth)]

    def draw_drop_scales(self, batch: int, generator: torch.Generator,
                         device) -> list:
        """Per block, two independent per-sample branch scales (mask/keep);
        None for blocks whose rate is 0."""
        scales = []
        for rate in self.drop_path_rates():
            if rate == 0.0:
                scales.append(None)
                continue
            keep = 1.0 - rate
            scales.append(tuple(
                (torch.rand(batch, generator=generator, device=device) < keep
                 ).float() / keep for _ in range(2)))
        return scales

    # what view() may override: the functions that choose the path, and the
    # feature collection
    VIEW_OVERRIDES = ("attention_fn", "mlp_fn", "block_fn", "block_pair_fn",
                      "collect_features")

    def view(self, **overrides) -> "VisionTransformer":
        """A model that shares this one's parameters (the same storage, so it
        follows every update) with other values for any of ``VIEW_OVERRIDES``:
        evaluation is forward only and can run ``fused_mlp``, or single blocks
        where training runs block pairs."""
        unknown = set(overrides) - set(self.VIEW_OVERRIDES)
        if unknown:
            raise TypeError(f"view() got unexpected arguments {sorted(unknown)}; "
                            f"it takes {', '.join(self.VIEW_OVERRIDES)}")
        other = copy.copy(self)
        for name, value in overrides.items():
            setattr(other, name, value)
        other._check_tp()
        return other

    def _collect(self, i: int, override) -> bool:
        cf = self.collect_features if override is None else override
        return bool(cf) if isinstance(cf, bool) else i in cf

    def token_dropout(self, x: torch.Tensor, generator: Optional[torch.Generator],
                      keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """flax nn.Dropout(drop_rate) on the tokens x [B, N, D] in train mode:
        each value kept with probability 1 - drop_rate and then scaled by
        1 / (1 - drop_rate). ``keep`` (bool, x's shape) pins the mask; else it
        is drawn from ``generator``."""
        rate = self.cfg.drop_rate
        if rate >= 1.0:
            return torch.zeros_like(x)
        if keep is None:
            if generator is None:
                raise ValueError("train mode with drop_rate > 0 needs token_keep or a "
                                 "generator")
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def forward(self, x: torch.Tensor, *, train: bool = False,
                drop_scales: Optional[Sequence] = None,
                generator: Optional[torch.Generator] = None,
                collect_features=None,
                token_keep: Optional[torch.Tensor] = None) -> ViTOutput:
        """x: [B, H, W, C] images. In train mode with a drop-path rate, the
        branch scales are ``drop_scales`` (one (s_attn, s_mlp) pair or None
        per block) or else drawn from ``generator``; with a token dropout
        rate, the keep mask of the tokens is ``token_keep`` or else drawn
        from ``generator`` after the drop-path scales."""
        cfg, dt = self.cfg, self.dtype
        B = x.shape[0]
        if train and cfg.drop_path_rate > 0.0 and drop_scales is None:
            if generator is None:
                raise ValueError("train mode with drop_path_rate > 0 needs "
                                 "drop_scales or a generator")
            drop_scales = self.draw_drop_scales(B, generator, x.device)
        if not train:
            drop_scales = None

        w = self.patch_embed.proj
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), w.weight.to(dt),
                     w.bias.to(dt), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)
        prefix = [self.cls_token.to(dt).expand(B, -1, -1)]
        if cfg.distilled:
            prefix.append(self.dist_token.to(dt).expand(B, -1, -1))
        x = torch.cat(prefix + [x], dim=1) + self.pos_embed.to(dt)
        if train and cfg.drop_rate > 0.0:
            x = self.token_dropout(x, generator, token_keep)

        def scales_of(i):
            pair = drop_scales[i] if drop_scales is not None else None
            return pair if pair is not None else (None, None)

        feats = []
        pair_on = self.block_pair_fn is not None and cfg.qkv_bias
        i = 0
        while i < cfg.depth:
            if pair_on and i + 1 < cfg.depth:
                (sa1, sm1), (sa2, sm2) = scales_of(i), scales_of(i + 1)
                x, f1, f2 = self.block_pair_fn(
                    x, dict(self.blocks[i].named_parameters()),
                    dict(self.blocks[i + 1].named_parameters()),
                    num_heads=cfg.num_heads, ln_eps=cfg.ln_eps,
                    scale_attn1=sa1, scale_mlp1=sm1, scale_attn2=sa2, scale_mlp2=sm2,
                    need_features1=self._collect(i, collect_features),
                    need_features2=self._collect(i + 1, collect_features))
                feats.extend([f1, f2])
                i += 2
                continue
            x, feat = self.blocks[i](
                x, dt, drop_scales[i] if drop_scales is not None else None,
                self.block_fn, self._collect(i, collect_features),
                self.attention_fn, self.mlp_fn)
            feats.append(feat)
            i += 1

        x = _layer_norm(x, self.norm, dt)
        logits = _linear(x[:, 0], self.head, dt).float()
        if cfg.distilled:
            logits_dist = _linear(x[:, 1], self.head_dist, dt).float()
            if train:
                return ViTOutput(logits, logits_dist, tuple(feats))
            return ViTOutput((logits + logits_dist) / 2.0, logits_dist, tuple(feats))
        return ViTOutput(logits, None, tuple(feats))


def init_weights(model: VisionTransformer, generator: torch.Generator) -> None:
    """The JAX model's initialisation: truncated normal (std 0.02, cut at two
    standard deviations) for every kernel and token, zero biases, unit
    LayerNorm scales. Draws on the CPU, then copies into the parameters."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".norm" in name or name.startswith("norm"):
                p.fill_(1.0)
            else:
                t = torch.empty(p.shape)
                nn.init.trunc_normal_(t, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
                p.copy_(t)
