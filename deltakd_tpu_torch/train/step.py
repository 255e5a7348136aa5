"""The train and eval steps (``deltakd_tpu/train/step.py``).

One train step: on-device augmentation and mixup, the frozen teacher forward
under ``torch.no_grad()``, the student forward and backward, the KD loss (for
a feature objective on both models' per-block features and the aux heads),
the optimizer's update over the flat parameter vector of student and aux
heads, the EMA update and the metrics, optionally over several accumulated
micro-batches. Randomness comes from explicit ``torch.Generator``s; tests
may instead pin the post-transform images, the soft targets, the drop-path
scales, the token dropout mask, the masking noise and DiffKD's draws.

Under data parallelism (``dp``, one process per card) each rank runs the
step on its rows of the global batch: the per-image draws come from the
rank's own generator, the draws that the JAX package makes once for the
global batch (mixup's, colour jitter's order) from ``batch_generator``,
which is equal on every rank; mixup pairs rows across ranks, LRKD's and
DiffKD's batch-coupled terms are all-reduced, and after the micro-batches
one all-reduce of the flat gradient vector divided by the world size makes
every rank's update the global batch's (the psum of the JAX kernels'
partitioning rules). The teacher stays a replica on each rank; the metrics
stay per rank and are reduced where they are read. Under tensor
parallelism ``dp`` is the data axis, the ranks of this rank's model column:
the model ranks of one data row hold the same rows and draw the same
numbers, the models' shards reduce over the model group inside the
forward and backward (``parallel/tensor.py``), and the flat gradient holds
this rank's shards.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from deltakd_tpu_torch.data.augment import AugmentConfig, eval_transform, train_transform
from deltakd_tpu_torch.data.mixup import MixupConfig, apply_mixup
from deltakd_tpu_torch.kd.losses import FEATURE_TYPES, DiffKDDraws, KDSettings, total_loss
from deltakd_tpu_torch.parallel.mesh import DataParallel, current
from deltakd_tpu_torch.train.optim import global_norm
from deltakd_tpu_torch.train.state import TrainState


def topk_correct(logits, labels, k: int):
    """Per-sample bool: label within the top-k logits (k clamped to the class
    count)."""
    topk = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
    return (topk == labels[:, None]).any(-1)


def build_train_step(*, cfg, kd: KDSettings, student, teacher,
                     aug: AugmentConfig, mixup: Optional[MixupConfig], tx,
                     aux=None, dp: Optional[DataParallel] = None) -> Callable:
    """Returns ``step(state, images_u8, labels, generator, *,
    batch_generator=None, images=None, targets=None, drop_scales=None,
    token_keep=None, epoch=0, mask_noise=None, diffkd_draws=None) ->
    metrics``.

    ``state`` must hold ``student``'s parameters and, for a feature objective,
    those of its aux heads ``aux`` (TrainState(student, aux=aux, ...)).
    ``images`` (post-transform, post-mixup, [B, S, S, 3]) and ``targets``
    replace the drawn augmentation; ``drop_scales`` (per block an
    (s_attn, s_mlp) pair or None) replaces the drawn stochastic depth,
    ``token_keep`` (bool [B, N, D]) the student's drawn token dropout mask
    (a student with ``drop_rate`` > 0; the teacher never drops) and
    ``mask_noise`` ([B, L]) the drawn masking noise, ``diffkd_draws``
    (``kd.losses.DiffKDDraws``) DiffKD's timesteps, noise and dropout masks;
    each pinned draw needs ``grad_accum_steps == 1``. ``epoch`` (a Python
    int) picks CurKD's phase. Metrics are 0-d tensors on the device.
    ``dp`` is the data axis (default: the current process group, see
    ``parallel.current``; under a model axis ``make_mesh(...).data``);
    ``batch_generator`` defaults to ``generator``.
    """
    dp = dp or current()
    needs_teacher = kd.distillation_type != "none"
    needs_features = kd.distillation_type.lower() in FEATURE_TYPES
    if needs_features and aux is None:
        raise ValueError(f"{kd.distillation_type} needs its aux heads: pass aux=")
    accum = max(1, cfg.grad_accum_steps)
    ema_decay = cfg.ema_decay
    if teacher is not None:
        teacher.requires_grad_(False)

    def micro_grads(params, generator, batch_generator, images_u8, labels, images,
                    targets, drop_scales, token_keep, epoch, mask_noise, diffkd_draws):
        if images is None:
            # named ranges, so that a profile of the step can tell them apart
            with torch.profiler.record_function("train_transform"):
                images = train_transform(generator, images_u8, aug, batch_generator)
            if mixup is not None:
                with torch.profiler.record_function("mixup"):
                    images, targets = apply_mixup(batch_generator, images, labels, mixup,
                                                  dp)
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
                        generator=generator, token_keep=token_keep)
        loss, loss_metrics = total_loss(
            kd, student_logits=s_out.logits, student_dist_logits=s_out.logits_dist,
            student_feats=s_out.features if needs_features else None,
            teacher_logits=teacher_logits, teacher_feats=teacher_feats, aux=aux,
            targets=targets, generator=generator, noise=mask_noise,
            diffkd_draws=diffkd_draws, epoch=epoch, train=True, dp=dp)
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
             batch_generator: Optional[torch.Generator] = None,
             images=None, targets=None, drop_scales: Optional[Sequence] = None,
             token_keep: Optional[torch.Tensor] = None,
             epoch: int = 0, mask_noise: Optional[torch.Tensor] = None,
             diffkd_draws: Optional[DiffKDDraws] = None) -> Dict[str, torch.Tensor]:
        pinned = (drop_scales, token_keep, mask_noise, diffkd_draws)
        if any(p is not None for p in pinned) and accum > 1:
            raise ValueError("pinned drop_scales, token_keep, mask_noise or diffkd_draws "
                             "need grad_accum_steps == 1")
        params = state.parameters()
        batch_generator = batch_generator or generator
        mb = labels.shape[0] // accum
        g_sum, m_sum = None, None
        for i in range(accum):
            part = slice(i * mb, (i + 1) * mb)
            g, m = micro_grads(
                params, generator, batch_generator,
                None if images_u8 is None else images_u8[part], labels[part],
                None if images is None else images[part],
                None if targets is None else targets[part], drop_scales, token_keep,
                epoch, mask_noise, diffkd_draws)
            g_sum = g if g_sum is None else g_sum + g
            m_sum = m if m_sum is None else {k: m_sum[k] + m[k] for k in m}
        grads = g_sum / accum
        if dp.active:   # the global batch's gradient
            with torch.profiler.record_function("gradient all-reduce"):
                grads = dp.all_reduce(grads) / dp.world
        metrics = {k: v / accum for k, v in m_sum.items()}
        metrics["grad_norm"] = global_norm(grads, state.shards)
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
