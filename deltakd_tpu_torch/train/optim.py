"""Optimizers and LR schedules with timm's semantics
(``deltakd_tpu/train/optim.py``).

* weight decay is masked off for 1-D params and for the ViT no-decay set
  {pos_embed, cls_token, dist_token} (timm ``param_groups_weight_decay``);
* the schedules step per epoch: ``cosine`` (a linear warmup from
  ``warmup_lr`` that carves into the cycle, timm warmup_prefix=False, and
  ``min_lr`` beyond it), ``step`` (``lr * decay_rate ** (epoch //
  decay_epochs)`` after the warmup) and ``plateau`` (the warmup, then the
  base LR times a scale that :class:`PlateauController` lowers on the host
  when the validation accuracy stalls);
* the optimizers: ``adamw`` (clip, AdamW with masked decay), ``sgd`` /
  ``momentum`` (clip, masked decayed weights, nesterov momentum) and
  ``adam`` (clip, Adam, no decay), each as optax composes them in the JAX
  package;
* an LR scale (``sched='plateau'`` or ``lr_noise``): one host float on the
  optimizer state that multiplies the whole update, set between steps by
  :func:`set_lr_scale` (timm's LR noise, :func:`lr_noise_multiplier`, rides
  on it too).

Every optimizer runs over ONE flat fp32 vector holding every trainable
parameter (``train/state.py`` makes the parameters views into it), as a
handful of element passes instead of a few per tensor, and updates it in
place. Under tensor parallelism the vector holds this rank's shards and the
replicated tensors; the update is elementwise, so only the clip's global
norm reaches across the model group.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from deltakd_tpu_torch.parallel.tensor import FlatShards

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


def step_epoch_schedule(cfg) -> Callable[[float], float]:
    """timm StepLRScheduler: lr * decay_rate ** (epoch // decay_epochs) after
    the same linear warmup."""
    base, warm0 = cfg.lr, cfg.warmup_lr
    warmup_t, decay_t, decay_rate = cfg.warmup_epochs, cfg.decay_epochs, cfg.decay_rate

    def lr_at_epoch(epoch: float) -> float:
        if epoch < warmup_t:
            return warm0 + epoch * (base - warm0) / max(warmup_t, 1)
        return base * decay_rate ** math.floor(epoch / decay_t)

    return lr_at_epoch


def plateau_epoch_schedule(cfg) -> Callable[[float], float]:
    """timm PlateauLRScheduler's in-step part: the linear warmup, then the
    base LR. The decay on a stalled validation metric is the LR scale that
    :class:`PlateauController` computes on the host each epoch."""
    base, warm0, warmup_t = cfg.lr, cfg.warmup_lr, cfg.warmup_epochs

    def lr_at_epoch(epoch: float) -> float:
        if epoch < warmup_t:
            return warm0 + epoch * (base - warm0) / max(warmup_t, 1)
        return base

    return lr_at_epoch


SCHEDULES = {"cosine": cosine_epoch_schedule, "step": step_epoch_schedule,
             "plateau": plateau_epoch_schedule}
OPTIMIZERS = ("adamw", "sgd", "momentum", "adam")


def make_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """The LR at an update count: the epoch schedule of ``cfg.sched`` at
    ``count // steps_per_epoch``."""
    if cfg.sched not in SCHEDULES:
        raise NotImplementedError(f"scheduler '{cfg.sched}' not implemented "
                                  f"({', '.join(SCHEDULES)} are)")
    per_epoch = SCHEDULES[cfg.sched](cfg)
    return lambda step: per_epoch(step // steps_per_epoch)


def lr_noise_multiplier(cfg, epoch: int) -> float:
    """timm's LR noise: the multiplier in effect for ``epoch``.

    ``lr_noise`` holds epoch fractions, multiplied by ``epochs``: one value
    means "from that epoch on", two the range [lo, hi). Inside it the noise
    is ``torch.randn`` from a CPU generator seeded ``seed + epoch``, drawn
    again until ``|noise| < lr_noise_pct``, and the multiplier is
    ``1 + noise``. timm never multiplies by ``lr_noise_std`` on this path;
    the flag is accepted and ignored, as there."""
    if not cfg.lr_noise:
        return 1.0
    bounds = [float(v) * cfg.epochs for v in cfg.lr_noise]
    if len(bounds) >= 2:
        active = bounds[0] <= epoch < bounds[1]
    else:
        active = epoch >= bounds[0]
    if not active:
        return 1.0
    g = torch.Generator()
    g.manual_seed(cfg.seed + epoch)
    while True:
        noise = torch.randn(1, generator=g).item()
        if abs(noise) < cfg.lr_noise_pct:
            return 1.0 + noise


class PlateauController:
    """torch ``ReduceLROnPlateau``'s rule (what timm's PlateauLRScheduler
    wraps), on the host: when the validation metric has not improved for more
    than ``patience`` epochs, the scale is multiplied by ``decay_rate`` (not
    below ``min_lr / base_lr``), then ``cooldown`` epochs pass before the
    count starts again. Mode max (top-1 accuracy), relative threshold 1e-4.

    The scale rides on the (checkpointed) optimizer state, so a resumed run
    starts from its decayed LR (``initial_scale``); only the patience and
    cooldown counts start again."""

    def __init__(self, *, decay_rate: float, patience: int, cooldown: int,
                 min_lr: float, base_lr: float, threshold: float = 1e-4,
                 initial_scale: float = 1.0):
        self.decay_rate = decay_rate
        self.patience = patience
        self.cooldown = cooldown
        self.min_scale = min_lr / max(base_lr, 1e-12)
        self.threshold = threshold
        self.scale = initial_scale
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown_left = 0

    def epoch_end(self, metric: float) -> float:
        if self.best is None or metric > self.best * (1.0 + self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.decay_rate, self.min_scale)
            self.cooldown_left = self.cooldown
            self.num_bad = 0
        return self.scale


@dataclasses.dataclass
class FusedAdamWState:
    """Update count and the moments, each one flat fp32 vector (AdamW's and
    Adam's state), and the LR scale (None: the optimizer has none)."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor
    scale: Optional[float] = None
    kind: str = "adamw"      # or "adam"
    BUFFERS = ("mu", "nu")


@dataclasses.dataclass
class TraceState:
    """Update count and the momentum trace, one flat fp32 vector (SGD's
    state), and the LR scale (None: the optimizer has none)."""
    count: int
    trace: torch.Tensor
    scale: Optional[float] = None
    kind: str = "sgd"
    BUFFERS = ("trace",)


def set_lr_scale(opt_state, value: float):
    """Sets the LR scale of ``opt_state`` to ``value`` (a host float: no
    sync, nothing rebuilt) and returns it; a state without a scale passes
    through untouched, as in the JAX package."""
    if opt_state.scale is not None:
        opt_state.scale = float(value)
    return opt_state


def get_lr_scale(opt_state) -> Optional[float]:
    return opt_state.scale


def _scaled(lr: float, state) -> float:
    return lr if state.scale is None else lr * state.scale


def _decay_mask(named_params) -> torch.Tensor:
    """1.0 where weight decay applies, over the flat vector."""
    mask = wd_mask(named_params)
    return torch.cat([torch.full((p.numel(),), 1.0 if mask[n] else 0.0, device=p.device)
                      for n, p in named_params])


def global_norm(g: torch.Tensor, shards: Optional[FlatShards] = None) -> torch.Tensor:
    """The global norm of the flat vector as an fp32 scalar, summed in fp64:
    PyTorch's fp32 norm on the CPU drifts with the length (1.4e-4 relative
    over 5.6M values) where the card's does not, and the clip scales every
    value by it. With ``shards`` (a vector that holds this rank's shards over
    a model axis) the norm of the full vector: the shards' squares summed
    over the model group, the replicated tensors' counted once."""
    if shards is None:
        return torch.linalg.vector_norm(g, dtype=torch.float64).float()
    return shards.square_sum(g).sqrt().float()


def _clip(g: torch.Tensor, clip_norm: Optional[float],
          shards: Optional[FlatShards] = None) -> torch.Tensor:
    """Clipping by the global norm of the flat vector."""
    if clip_norm is None:
        return g
    gnorm = global_norm(g, shards)
    return g * (clip_norm / torch.clamp(gnorm, min=clip_norm))


class FusedClippedAdamW:
    """Global-norm clip + AdamW with masked decay over one flat vector (the
    JAX package's ``fused_clipped_adamw``; in fp32 the same update as its
    optax chain). With ``weight_decay`` 0 it is optax's chain of the clip
    and ``adam`` (``kind`` 'adam': eps outside the square root, no decay)."""

    def __init__(self, learning_rate: Callable[[int], float], b1: float, b2: float,
                 eps: float, weight_decay: float,
                 named_params: Sequence[Tuple[str, torch.Tensor]],
                 clip_norm: Optional[float] = None, lr_scale: bool = False,
                 kind: str = "adamw"):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.lr_scale = lr_scale
        self.kind = kind
        self.mask = _decay_mask(named_params)
        self.shards = FlatShards.of(named_params)

    def init(self, flat_params: torch.Tensor) -> FusedAdamWState:
        return FusedAdamWState(0, torch.zeros_like(flat_params),
                               torch.zeros_like(flat_params),
                               1.0 if self.lr_scale else None, self.kind)

    def update(self, grads: torch.Tensor, state: FusedAdamWState,
               params: torch.Tensor) -> None:
        """Applies one step IN PLACE: ``params`` and the moments in ``state``
        are overwritten (the JAX version returns new arrays instead)."""
        g = _clip(grads.float(), self.clip_norm, self.shards)
        lr = _scaled(self.learning_rate(state.count), state)
        state.count += 1
        state.mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        state.nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        mu_hat = state.mu / (1.0 - self.b1 ** state.count)
        nu_hat = state.nu / (1.0 - self.b2 ** state.count)
        upd = mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.weight_decay * self.mask * params
        params.sub_(lr * upd)


def fused_clipped_adamw(learning_rate, b1, b2, eps, weight_decay, named_params,
                        clip_norm=None, lr_scale=False, kind="adamw") -> FusedClippedAdamW:
    return FusedClippedAdamW(learning_rate, b1, b2, eps, weight_decay,
                             named_params, clip_norm, lr_scale, kind)


class Sgd:
    """optax's chain(clip_by_global_norm, add_decayed_weights(wd, mask),
    sgd(lr, momentum, nesterov=True)) over one flat vector: g + wd * p where
    decay applies, then the trace t = g + momentum * t and the nesterov
    update g + momentum * t."""

    def __init__(self, learning_rate: Callable[[int], float], momentum: float,
                 weight_decay: float, named_params: Sequence[Tuple[str, torch.Tensor]],
                 clip_norm: Optional[float] = None, lr_scale: bool = False):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.lr_scale = lr_scale
        self.mask = _decay_mask(named_params)
        self.shards = FlatShards.of(named_params)

    def init(self, flat_params: torch.Tensor) -> TraceState:
        return TraceState(0, torch.zeros_like(flat_params), 1.0 if self.lr_scale else None)

    def update(self, grads: torch.Tensor, state: TraceState, params: torch.Tensor) -> None:
        """One step IN PLACE on ``params`` and the trace."""
        g = _clip(grads.float(), self.clip_norm, self.shards)
        g = g + self.weight_decay * self.mask * params
        step_lr = _scaled(self.learning_rate(state.count), state)
        state.count += 1
        state.trace.mul_(self.momentum).add_(g)
        direction = g + self.momentum * state.trace
        params.sub_(step_lr * direction)


def make_optimizer(cfg, named_params, steps_per_epoch: int):
    """The optimizer of ``cfg.opt`` with the schedule of ``cfg.sched`` over
    the flat vector of ``named_params``, with an LR scale when
    ``cfg.sched == 'plateau'`` or ``cfg.lr_noise`` is set. Every optimizer
    here runs over one flat vector; in fp32 that is the same update as the
    JAX package's per-tensor optax chain."""
    named_params = list(named_params)
    sched = make_schedule(cfg, steps_per_epoch)
    betas = cfg.opt_betas or (0.9, 0.999)
    lr_scale = cfg.sched == "plateau" or bool(cfg.lr_noise)
    if cfg.opt == "adamw":
        return fused_clipped_adamw(sched, betas[0], betas[1], cfg.opt_eps, cfg.weight_decay,
                                   named_params, cfg.clip_grad, lr_scale)
    if cfg.opt in ("sgd", "momentum"):
        return Sgd(sched, cfg.momentum, cfg.weight_decay, named_params, cfg.clip_grad,
                   lr_scale)
    if cfg.opt == "adam":
        return fused_clipped_adamw(sched, betas[0], betas[1], cfg.opt_eps, 0.0, named_params,
                                   cfg.clip_grad, lr_scale, kind="adam")
    raise NotImplementedError(f"optimizer '{cfg.opt}' not implemented "
                              f"({', '.join(OPTIMIZERS)} are)")
