"""Distillation objectives (``deltakd_tpu/kd/losses.py``): the ``none``,
``soft`` and ``hard`` branches and the feature objectives ``wasskd`` (l1),
``mgd`` and ``vitkd``.

Reduction semantics follow the JAX package: soft KD is KL with reduction
'sum' scaled by T^2 / numel; ViTKD is sum-MSE over the batch size, MGD
mean-MSE; the logit types combine as ``base * (1 - alpha) + distill * alpha``,
``mgd`` and ``vitkd`` as ``base + distill`` and ``wasskd`` as
``base + 5 * distill``. ``lrkd``, ``diffkd``, ``curkd``, ``saliency_mgd`` and
the sinkhorn variant of ``wasskd`` are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deltakd_tpu_torch.kd import aux as aux_ops
from deltakd_tpu_torch.kd.masking import (fill_and_restore, grid_to_tokens,
                                          random_masking, tokens_to_grid)
from deltakd_tpu_torch.ops.sort import sorted_l1

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
    lrkd_rank: int = 32
    lrkd_alpha: float = 0.1
    lrkd_beta: float = 0.1
    lrkd_gamma: float = 0.1
    saliency_method: int = 1
    saliency_mask_ratio: float = 0.5
    wasskd_type: str = "l1"
    mgd_alpha: float = 7e-5
    mgd_mask_ratio: float = 0.5
    student_prefix: int = 1   # prefix tokens sliced off the student's features
    teacher_prefix: int = 2   # and off the teacher's (CLS + DIST)
    sinkhorn_iters: int = 20

    @classmethod
    def from_config(cls, cfg, *, student_prefix: int = 1,
                    teacher_prefix: int = 2) -> "KDSettings":
        return cls(
            distillation_type=cfg.distillation_type, alpha=cfg.alpha, tau=cfg.tau,
            smoothing=cfg.smoothing, mixup_active=cfg.mixup_active,
            lrkd_rank=cfg.lrkd_rank, lrkd_alpha=cfg.lrkd_alpha,
            lrkd_beta=cfg.lrkd_beta, lrkd_gamma=cfg.lrkd_gamma,
            saliency_method=cfg.saliency_method,
            saliency_mask_ratio=cfg.saliency_mask_ratio,
            wasskd_type=cfg.wasskd_type, mgd_alpha=cfg.mgd_alpha,
            mgd_mask_ratio=cfg.mgd_mask_ratio,
            student_prefix=student_prefix, teacher_prefix=teacher_prefix,
            sinkhorn_iters=cfg.sinkhorn_iters)


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


# ----------------------------------------------------------------------------
# Feature objectives
# ----------------------------------------------------------------------------

def _sum_sq(x):
    x = x.float()
    return torch.sum(x * x)


def _mean_sq(x):
    x = x.float()
    return torch.mean(x * x)


def _masked_generation(aux, x_keep, ids_restore):
    """fill -> restore order -> grid -> conv generation -> tokens."""
    x = fill_and_restore(x_keep, ids_restore, aux.mask_token)
    x = aux_ops.generation_apply(aux.generation, tokens_to_grid(x))
    return grid_to_tokens(x)


def _slice_feats(feats: Sequence[torch.Tensor], idx: Sequence[int], prefix: int):
    return tuple(feats[i][:, prefix:] for i in idx)


def vitkd_loss(kd: KDSettings, aux, s_feats, t_feats, generator=None, *, noise=None,
               alpha_vitkd: float = 3e-5, beta_vitkd: float = 3e-6,
               lambda_vitkd: float = 0.5):
    """ViTKD: blocks 0, 1 linear mimicking + last-block masked generation,
    both sum-MSE / B."""
    s0, s1, s_last = _slice_feats(s_feats, (0, 1, -1), kd.student_prefix)
    t0, t1, t_last = _slice_feats(t_feats, (0, 1, -1), kd.teacher_prefix)
    B = s0.shape[0]

    xc0 = aux_ops.dense(aux.align2[0], s0)
    xc1 = aux_ops.dense(aux.align2[1], s1)
    loss_lr = (_sum_sq(xc0 - t0) + _sum_sq(xc1 - t1)) / B * alpha_vitkd

    x = aux_ops.dense(aux.align, s_last)
    x_keep, mask, ids_restore, _ = random_masking(generator, x, lambda_vitkd, noise=noise)
    x = _masked_generation(aux, x_keep, ids_restore)
    m = mask[..., None].float()
    loss_gen = _sum_sq((x.float() - t_last.float()) * m)
    return loss_lr + loss_gen / B * beta_vitkd / lambda_vitkd


def wasskd_loss(kd: KDSettings, aux, s_feats, t_feats):
    """WassKD-l1 on layers 0-2: one sorted_l1 along the token axis per layer
    (sliced 1-D Wasserstein), in the compute dtype, mean of the three."""
    if kd.wasskd_type == "sinkhorn":
        raise NotImplementedError("wasskd_type 'sinkhorn' is not ported yet ('l1' is)")
    if kd.wasskd_type != "l1":
        raise ValueError(f"Invalid wasskd type: {kd.wasskd_type}")
    loss = 0.0
    for i in range(3):
        s = aux_ops.dense(aux.align_wasskd[i], s_feats[i][:, kd.student_prefix:])
        t = t_feats[i][:, kd.teacher_prefix:]
        loss = loss + sorted_l1(s, t.to(s.dtype), axis=1)
    return loss / 3.0


def mgd_loss(kd: KDSettings, aux, s_feats, t_feats, generator=None, *, noise=None):
    """MGD: random masking + generation on the last block, mean-MSE x mgd_alpha."""
    s = aux_ops.dense(aux.align, s_feats[-1][:, kd.student_prefix:])
    tea = t_feats[-1][:, kd.teacher_prefix:].float()
    x_keep, mask, ids_restore, _ = random_masking(generator, s, kd.mgd_mask_ratio,
                                                  noise=noise)
    x = _masked_generation(aux, x_keep, ids_restore)
    m = mask[..., None].float()
    return _mean_sq((x.float() - tea) * m) * kd.mgd_alpha


# ----------------------------------------------------------------------------
# Dispatcher
# ----------------------------------------------------------------------------

def total_loss(kd: KDSettings, *, student_logits, student_dist_logits: Optional[torch.Tensor],
               teacher_logits: Optional[torch.Tensor], targets,
               student_feats: Optional[Sequence[torch.Tensor]] = None,
               teacher_feats: Optional[Sequence[torch.Tensor]] = None,
               aux=None, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, epoch=None, train: bool = True
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combine base and distillation losses for one batch.

    ``aux`` is the ``AuxHeads`` module of the distillation type; the masked
    objectives draw their noise from ``generator`` unless ``noise`` [B, L] is
    given. ``epoch`` and ``train`` are read by objectives that are not ported
    yet (curkd, diffkd)."""
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
    if t not in FEATURE_TYPES:
        raise ValueError(f"Invalid distillation type: {kd.distillation_type}")
    if t not in aux_ops.PORTED_TYPES:
        raise NotImplementedError(f"feature distillation '{t}' is not ported yet "
                                  f"(wasskd-l1, mgd and vitkd are)")
    if student_feats is None or teacher_feats is None:
        raise ValueError(f"{t} requires student and teacher features")
    if t == "vitkd":
        distill = vitkd_loss(kd, aux, student_feats, teacher_feats, generator, noise=noise)
        combined = base + distill
    elif t == "wasskd":
        distill = wasskd_loss(kd, aux, student_feats, teacher_feats)
        combined = base + distill * 5.0
    else:
        distill = mgd_loss(kd, aux, student_feats, teacher_feats, generator, noise=noise)
        combined = base + distill
    metrics["distill_loss"] = distill
    return combined, metrics
