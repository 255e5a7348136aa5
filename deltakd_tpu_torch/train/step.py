"""The train and eval steps (``deltakd_tpu/train/step.py``).

One train step: on-device augmentation and mixup, the frozen teacher forward
under ``torch.no_grad()``, the student forward and backward, the KD loss (for
a feature objective on both models' per-block features and the aux heads),
the clipped AdamW update over the flat parameter vector of student and aux
heads, the EMA update and the metrics, optionally over several accumulated
micro-batches. Randomness comes from one explicit ``torch.Generator``; tests
may instead pin the post-transform images, the soft targets, the drop-path
scales and the masking noise.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from deltakd_tpu_torch.data.augment import AugmentConfig, eval_transform, train_transform
from deltakd_tpu_torch.data.mixup import MixupConfig, apply_mixup
from deltakd_tpu_torch.kd.losses import FEATURE_TYPES, KDSettings, total_loss
from deltakd_tpu_torch.train.state import TrainState


def topk_correct(logits, labels, k: int):
    """Per-sample bool: label within the top-k logits (k clamped to the class
    count)."""
    topk = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    return (topk == labels[:, None]).any(-1)


def build_train_step(*, cfg, kd: KDSettings, student, teacher,
                     aug: AugmentConfig, mixup: Optional[MixupConfig], tx,
                     aux=None) -> Callable:
    """Returns ``step(state, images_u8, labels, generator, *, images=None,
    targets=None, drop_scales=None, epoch=0, mask_noise=None) -> metrics``.

    ``state`` must hold ``student``'s parameters and, for a feature objective,
    those of its aux heads ``aux`` (TrainState(student, aux=aux, ...)).
    ``images`` (post-transform, post-mixup, [B, S, S, 3]) and ``targets``
    replace the drawn augmentation; ``drop_scales`` (per block an
    (s_attn, s_mlp) pair or None) replaces the drawn stochastic depth and
    ``mask_noise`` ([B, L]) the drawn masking noise, and both need
    ``grad_accum_steps == 1``. Metrics are 0-d tensors on the device.
    """
    needs_teacher = kd.distillation_type != "none"
    needs_features = kd.distillation_type.lower() in FEATURE_TYPES
    if needs_features and aux is None:
        raise ValueError(f"{kd.distillation_type} needs its aux heads: pass aux=")
    accum = max(1, cfg.grad_accum_steps)
    ema_decay = cfg.ema_decay
    if teacher is not None:
        teacher.requires_grad_(False)

    def micro_grads(params, generator, images_u8, labels, images, targets,
                    drop_scales, epoch, mask_noise):
        if images is None:
            # named ranges, so that a profile of the step can tell them apart
            with torch.profiler.record_function("train_transform"):
                images = train_transform(generator, images_u8, aug)
            if mixup is not None:
                with torch.profiler.record_function("mixup"):
                    images, targets = apply_mixup(generator, images, labels, mixup)
            else:
                targets = labels
        elif targets is None:
            targets = labels
        images = images.to(student.dtype)

        teacher_logits = teacher_feats = None
        if needs_teacher:
            with torch.no_grad():
                t_out = teacher(images, train=False)
            teacher_logits = t_out.logits
            teacher_feats = t_out.features if needs_features else None
        s_out = student(images, train=True, drop_scales=drop_scales,
                        generator=generator)
        loss, loss_metrics = total_loss(
            kd, student_logits=s_out.logits, student_dist_logits=s_out.logits_dist,
            student_feats=s_out.features if needs_features else None,
            teacher_logits=teacher_logits, teacher_feats=teacher_feats, aux=aux,
            targets=targets, generator=generator, noise=mask_noise, epoch=epoch,
            train=True)
        # a parameter the loss does not reach (the dist head under a feature
        # objective) has a zero gradient
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
        logits = s_out.logits.detach()
        metrics = {
            "train_loss": loss.detach(),
            # accuracy against the un-mixed labels
            "train_acc1": topk_correct(logits, labels, 1).float().mean() * 100.0,
            "train_acc5": topk_correct(logits, labels, 5).float().mean() * 100.0,
            **{k: v.detach() for k, v in loss_metrics.items()},
        }
        return torch.cat([g.reshape(-1) for g in grads]), metrics

    def step(state: TrainState, images_u8, labels, generator: torch.Generator, *,
             images=None, targets=None, drop_scales: Optional[Sequence] = None,
             epoch: int = 0, mask_noise: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        if (drop_scales is not None or mask_noise is not None) and accum > 1:
            raise ValueError("pinned drop_scales or mask_noise need "
                             "grad_accum_steps == 1")
        params = state.parameters()
        mb = labels.shape[0] // accum
        g_sum, m_sum = None, None
        for i in range(accum):
            part = slice(i * mb, (i + 1) * mb)
            g, m = micro_grads(
                params, generator,
                None if images_u8 is None else images_u8[part], labels[part],
                None if images is None else images[part],
                None if targets is None else targets[part], drop_scales,
                epoch, mask_noise)
            g_sum = g if g_sum is None else g_sum + g
            m_sum = m if m_sum is None else {k: m_sum[k] + m[k] for k in m}
        grads = g_sum / accum
        metrics = {k: v / accum for k, v in m_sum.items()}
        metrics["grad_norm"] = torch.linalg.vector_norm(grads)
        state.apply_gradients(grads=grads, tx=tx, ema_decay=ema_decay)
        return metrics

    return step


def build_eval_step(*, student, aug: AugmentConfig) -> Callable:
    """Returns ``eval_step(images_u8, labels, valid) -> sums``: masked sums,
    so padded tail batches do not skew the metrics. ``valid`` is a per-sample
    mask, or a scalar meaning "the first n rows"."""

    @torch.no_grad()
    def step(images_u8, labels, valid):
        images = eval_transform(images_u8, aug).to(student.dtype)
        logits = student(images, train=False, collect_features=False).logits
        valid = torch.as_tensor(valid, device=labels.device)
        if valid.dim() == 0:
            valid = torch.arange(labels.shape[0], device=labels.device) < valid
        valid = valid.float()
        nll = torch.nn.functional.cross_entropy(logits.float(), labels.long(),
                                                reduction="none")
        return {
            "loss_sum": (nll * valid).sum(),
            "correct1": (topk_correct(logits, labels, 1) * valid).sum(),
            "correct5": (topk_correct(logits, labels, 5) * valid).sum(),
            "count": valid.sum(),
        }

    return step
