"""Logit distillation objectives (``deltakd_tpu/kd/losses.py``, the ``none``,
``soft`` and ``hard`` branches).

Reduction semantics follow the JAX package: soft KD is KL with reduction
'sum' scaled by T^2 / numel, and the logit types combine as
``base * (1 - alpha) + distill * alpha``. The feature objectives arrive with a
later slice and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

FEATURE_TYPES = ("vitkd", "lrkd", "diffkd", "curkd", "saliency_mgd", "wasskd", "mgd")
LOGIT_TYPES = ("soft", "hard")


def feature_indices(distillation_type: str, depth: int):
    """Which per-block features a KD objective reads (True = all, frozenset =
    those block indices, False = none), so the fused block skips the feature
    write for blocks no loss consumes."""
    t = distillation_type.lower()
    if t in ("vitkd", "lrkd", "diffkd"):
        return frozenset({0, 1, depth - 1})
    if t == "curkd":
        return frozenset(set(range(7)) | {depth - 1})
    if t == "wasskd":
        return frozenset({0, 1, 2})
    if t in ("mgd", "saliency_mgd"):
        return frozenset({depth - 1})
    return t in FEATURE_TYPES


@dataclasses.dataclass(frozen=True)
class KDSettings:
    """Static hyperparameters the loss needs (subset of TrainConfig)."""

    distillation_type: str = "none"
    alpha: float = 0.1
    tau: float = 3.0
    smoothing: float = 0.1
    mixup_active: bool = True

    @classmethod
    def from_config(cls, cfg) -> "KDSettings":
        return cls(distillation_type=cfg.distillation_type, alpha=cfg.alpha,
                   tau=cfg.tau, smoothing=cfg.smoothing,
                   mixup_active=cfg.mixup_active)


def soft_target_cross_entropy(logits, soft_targets):
    """timm SoftTargetCrossEntropy: mean over batch of -<target, log_softmax>."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.sum(-soft_targets * logp, dim=-1).mean()


def label_smoothing_cross_entropy(logits, labels, smoothing: float = 0.1):
    """timm LabelSmoothingCrossEntropy on integer labels."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    smooth = -logp.mean(-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def cross_entropy(logits, labels):
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


def base_criterion(kd: KDSettings, logits, targets):
    """Mixup on: soft-target CE; else label-smoothing CE."""
    if kd.mixup_active:
        return soft_target_cross_entropy(logits, targets)
    return label_smoothing_cross_entropy(logits, targets, kd.smoothing)


def soft_kd_loss(dist_logits, teacher_logits, tau: float):
    """DeiT soft KD: KL(log_softmax(t/T) || log_softmax(s/T)) summed, x T^2/numel."""
    T = tau
    ls = F.log_softmax(dist_logits.float() / T, dim=1)
    lt = F.log_softmax(teacher_logits.float() / T, dim=1)
    kl = torch.sum(torch.exp(lt) * (lt - ls))
    return kl * (T * T) / dist_logits.numel()


def hard_kd_loss(dist_logits, teacher_logits):
    """CE against the teacher argmax."""
    return cross_entropy(dist_logits, teacher_logits.argmax(dim=1))


def total_loss(kd: KDSettings, *, student_logits, student_dist_logits: Optional[torch.Tensor],
               teacher_logits: Optional[torch.Tensor], targets
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combine base and distillation losses for one batch."""
    t = kd.distillation_type.lower()
    base = base_criterion(kd, student_logits, targets)
    metrics = {"base_loss": base}
    if t == "none":
        metrics["distill_loss"] = torch.zeros((), device=base.device)
        return base, metrics
    if t in LOGIT_TYPES:
        if student_dist_logits is None:
            raise ValueError(
                "soft/hard distillation expects a distilled student returning "
                "(class_token, dist_token) logits; use a deit_*_distilled_* student")
        if t == "soft":
            distill = soft_kd_loss(student_dist_logits, teacher_logits, kd.tau)
        else:
            distill = hard_kd_loss(student_dist_logits, teacher_logits)
        metrics["distill_loss"] = distill
        return base * (1.0 - kd.alpha) + distill * kd.alpha, metrics
    if t in FEATURE_TYPES:
        raise NotImplementedError(f"feature distillation '{t}' is not ported yet; "
                                  f"it arrives with a later slice of the port")
    raise ValueError(f"Invalid distillation type: {kd.distillation_type}")
