"""AdamW with a per-epoch cosine schedule and timm's weight-decay rule
(``deltakd_tpu/train/optim.py``, the ``opt='adamw'``, ``sched='cosine'``
path).

* weight decay is masked off for 1-D params and for the ViT no-decay set
  {pos_embed, cls_token, dist_token} (timm ``param_groups_weight_decay``);
* the cosine schedule steps per epoch, with a linear warmup from
  ``warmup_lr`` that carves into the cycle (timm warmup_prefix=False) and
  ``min_lr`` beyond it;
* optional clipping by the global norm.

The update runs over ONE flat fp32 vector holding every trainable parameter
(``train/state.py`` makes the parameters views into it), as a handful of
element passes instead of a few per tensor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

NO_DECAY_NAMES = ("bias", "pos_embed", "cls_token", "dist_token", "saliency_attn")


def wd_mask(named_params: Sequence[Tuple[str, torch.Tensor]]) -> Dict[str, bool]:
    """True where weight decay applies (ndim > 1 and no no-decay name part)."""
    return {name: p.dim() > 1 and not any(part in NO_DECAY_NAMES
                                          for part in name.split("."))
            for name, p in named_params}


def cosine_epoch_schedule(cfg) -> Callable[[float], float]:
    """timm CosineLRScheduler(t_initial=epochs, warmup_t, warmup_lr_init,
    lr_min, cycle_limit=1) at integer epochs."""
    base, warm0, lr_min = cfg.lr, cfg.warmup_lr, cfg.min_lr
    warmup_t, t_initial = cfg.warmup_epochs, cfg.epochs

    def lr_at_epoch(epoch: float) -> float:
        if epoch >= t_initial:
            return lr_min
        if epoch < warmup_t:
            return warm0 + epoch * (base - warm0) / max(warmup_t, 1)
        t = min(max(epoch, 0.0), float(t_initial))
        return lr_min + 0.5 * (base - lr_min) * (1.0 + math.cos(math.pi * t / t_initial))

    return lr_at_epoch


def make_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    if cfg.sched != "cosine":
        raise NotImplementedError(f"scheduler '{cfg.sched}' is not ported "
                                  f"(cosine is)")
    per_epoch = cosine_epoch_schedule(cfg)
    return lambda step: per_epoch(step // steps_per_epoch)


@dataclasses.dataclass
class FusedAdamWState:
    """Update count and the moments, each one flat fp32 vector."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class FusedClippedAdamW:
    """Global-norm clip + AdamW with masked decay over one flat vector."""

    def __init__(self, learning_rate: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float,
                 named_params: Sequence[Tuple[str, torch.Tensor]],
                 clip_norm: Optional[float] = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        mask = wd_mask(named_params)
        self.mask = torch.cat([
            torch.full((p.numel(),), 1.0 if mask[n] else 0.0, device=p.device)
            for n, p in named_params])

    def init(self, flat_params: torch.Tensor) -> FusedAdamWState:
        return FusedAdamWState(0, torch.zeros_like(flat_params),
                               torch.zeros_like(flat_params))

    def update(self, grads: torch.Tensor, state: FusedAdamWState,
               params: torch.Tensor) -> None:
        """Applies one step IN PLACE: ``params`` and the moments in ``state``
        are overwritten (the JAX version returns new arrays instead)."""
        g = grads.float()
        if self.clip_norm is not None:
            gnorm = torch.linalg.vector_norm(g)
            g = g * (self.clip_norm / torch.clamp(gnorm, min=self.clip_norm))
        lr = self.learning_rate(state.count)
        state.count += 1
        state.mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        state.nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        mu_hat = state.mu / (1.0 - self.b1 ** state.count)
        nu_hat = state.nu / (1.0 - self.b2 ** state.count)
        upd = mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * self.mask * params
        params.sub_(lr * upd)


def fused_clipped_adamw(learning_rate, b1, b2, eps, weight_decay, named_params,
                        clip_norm=None) -> FusedClippedAdamW:
    return FusedClippedAdamW(learning_rate, b1, b2, eps, weight_decay,
                             named_params, clip_norm)


def make_optimizer(cfg, named_params, steps_per_epoch: int) -> FusedClippedAdamW:
    if cfg.opt != "adamw" or cfg.sched != "cosine":
        raise NotImplementedError(
            f"optimizer '{cfg.opt}' with scheduler '{cfg.sched}' is not ported "
            f"(adamw with cosine is)")
    betas = cfg.opt_betas or (0.9, 0.999)
    return fused_clipped_adamw(make_schedule(cfg, steps_per_epoch), betas[0],
                               betas[1], cfg.opt_eps, cfg.weight_decay,
                               list(named_params), cfg.clip_grad)
