"""Distillation objectives (``deltakd_tpu/kd/losses.py``): the ``none``,
``soft`` and ``hard`` branches and the seven feature objectives ``vitkd``,
``lrkd``, ``diffkd``, ``curkd``, ``saliency_mgd``, ``wasskd`` (l1 and
sinkhorn) and ``mgd``.

Reduction semantics follow the JAX package: soft KD is KL with reduction
'sum' scaled by T^2 / numel; ViTKD and CurKD are sum-MSE over the batch
size, LRKD, MGD and Saliency-MGD mean-MSE; the logit types, ``lrkd`` and
``diffkd`` combine as ``base * (1 - alpha) + distill * alpha``, ``vitkd``,
``curkd``, ``saliency_mgd`` and ``mgd`` as ``base + distill`` and ``wasskd``
as ``base + 5 * distill``. CurKD's epoch schedule is a Python branch on the
epoch the step passes in.

Every random draw (masking noise, DiffKD's timesteps, noise and dropout
masks) comes from an explicit ``torch.Generator`` unless the caller pins it.

Under data parallelism (``dp``) each rank holds its rows of the global batch.
Every objective is a mean over equal local batches, so the ranks' mean of
the local losses is the global one, except for two terms that couple the
batch: LRKD's Gram matrices and DiffKD's mean weight, which are all-reduced
over ``dp``'s group. Under tensor parallelism ``dp`` is the data axis (the
ranks of one model column): the features are replicated over the model
group, so each model rank computes the same loss.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deltakd_tpu_torch.kd import aux as aux_ops
from deltakd_tpu_torch.kd.masking import (fill_and_restore, grid_to_tokens,
                                          random_masking, saliency_masking,
                                          tokens_to_grid)
from deltakd_tpu_torch.kd.sinkhorn import batched_sinkhorn_divergence
from deltakd_tpu_torch.ops.sort import sorted_l1
from deltakd_tpu_torch.parallel.mesh import LOCAL, DataParallel

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


def _canon_sign(v: torch.Tensor) -> torch.Tensor:
    """Flips eigenvector columns [..., D, k] to a deterministic sign: the
    largest-|.| entry of each column is made positive. eigh and the subspace
    solver leave column signs arbitrary; this makes the LRKD targets the same
    across solvers and platforms."""
    mag = v.abs()
    is_max = (mag == mag.amax(dim=-2, keepdim=True)).to(v.dtype)
    s = torch.sum(torch.sign(v) * is_max, dim=-2, keepdim=True)
    return v * torch.where(s == 0, 1.0, torch.sign(s))


def topk_eigvecs_subspace(gram: torch.Tensor, rank: int, *, iters: int = 12,
                          oversample: int = 8) -> torch.Tensor:
    """Top-``rank`` eigenvectors [..., D, rank] of the SPD ``gram`` [..., D, D]
    by subspace iteration: products and Cholesky QR, no eigh of the D x D
    matrix; a Rayleigh-Ritz step rotates the converged subspace onto
    eigenvector directions. Deterministic: the start block comes from a
    generator seeded 0 (another draw than the JAX package's, so the two
    agree where the spectrum separates the top ``rank`` from the rest)."""
    d = gram.shape[-1]
    p = min(rank + oversample, d)
    v = torch.randn(gram.shape[:-2] + (d, p),
                    generator=torch.Generator().manual_seed(0)).to(gram.device)
    eye = torch.eye(p, device=gram.device)

    def orthonormalize(v):
        # Cholesky QR: V <- V R^-T with R R^T = V^T V. The regulariser scales
        # with the Gram diagonal: after a few iterations trailing columns
        # collapse toward the dominant subspace and an absolute one underflows.
        v = v / torch.linalg.vector_norm(v, dim=-2, keepdim=True)
        vv = v.mT @ v
        eps = 1e-5 * torch.diagonal(vv, dim1=-2, dim2=-1).mean(-1)[..., None, None]
        r = torch.linalg.cholesky_ex(vv + eps * eye).L
        return torch.linalg.solve_triangular(r.mT, v, upper=True, left=False)

    for _ in range(iters):
        v = orthonormalize(gram @ v)
    _, u = torch.linalg.eigh(v.mT @ gram @ v)
    return _canon_sign((v @ u).flip(-1)[..., :rank])


def rank_k_targets(t_feat_2d: torch.Tensor, rank: int, solver: str = "eigh") -> torch.Tensor:
    """The top-``rank`` spectral projection U_k diag(S_k) = A V_k of a
    [M, D] feature matrix A, from the eigenvectors of the D x D Gram matrix
    (column signs by ``_canon_sign``); ``solver='subspace'`` takes them from
    ``topk_eigvecs_subspace`` instead of ``torch.linalg.eigh``."""
    a = t_feat_2d.float()
    gram = a.T @ a
    if solver == "subspace":
        v_k = topk_eigvecs_subspace(gram, rank)
    else:
        v_k = _canon_sign(torch.linalg.eigh(gram)[1].flip(-1)[:, :rank])
    return a @ v_k


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


def lrkd_targets(kd: KDSettings, t_feats, dp: DataParallel = LOCAL) -> torch.Tensor:
    """LRKD's targets [3, M, rank]: the teacher's top-``lrkd_rank`` spectral
    coordinates of blocks 0, 1 and the last, M = B x patch tokens. The three
    eigendecompositions are one batched ``torch.linalg.eigh`` of the
    [3, D, D] Gram matrices, as the JAX package computes them on every
    backend but the TPU. The Gram matrices are the global batch's (summed
    over the ranks), so every rank projects its rows on the same vectors."""
    t_sel = _slice_feats(t_feats, (0, 1, -1), kd.teacher_prefix)
    t2 = torch.stack([t.reshape(-1, t.shape[-1]) for t in t_sel]).float()
    gram = dp.all_reduce(torch.bmm(t2.mT, t2))
    _, vecs = torch.linalg.eigh(gram)     # ascending eigenvalues
    return torch.bmm(t2, _canon_sign(vecs.flip(-1)[..., :kd.lrkd_rank]))


def lrkd_loss(kd: KDSettings, aux, s_feats, t_feats, *,
              targets: Optional[torch.Tensor] = None, dp: DataParallel = LOCAL):
    """LRKD: the student's blocks 0, 1 and last projected to rank k by the
    align layers, mean-MSE against the teacher's spectral coordinates,
    weighted by lrkd_alpha, lrkd_beta, lrkd_gamma. ``targets`` [3, M, k]
    replaces ``lrkd_targets``."""
    if targets is None:
        targets = lrkd_targets(kd, t_feats, dp)
    s_sel = _slice_feats(s_feats, (0, 1, -1), kd.student_prefix)
    losses = [_mean_sq(targets[i] - aux_ops.dense(layer, s).reshape(-1, kd.lrkd_rank).float())
              for i, (layer, s) in enumerate(zip(aux.align, s_sel))]
    return (losses[0] * kd.lrkd_alpha + losses[1] * kd.lrkd_beta
            + losses[2] * kd.lrkd_gamma)


DIFFKD_STEPS = 8


class DiffKDDraws(NamedTuple):
    """DiffKD's random draws: each sample's timestep ``t_step`` [B] in
    [0, DIFFKD_STEPS), and for each of blocks 0, 1 and the last the standard
    normal ``noise`` [B, L, D] (before it is scaled by sigma_t) and the
    denoiser's dropout ``keep`` mask [B, L, D] (True = kept)."""

    t_step: torch.Tensor
    noise: List[torch.Tensor]
    keep: List[torch.Tensor]

    @classmethod
    def draw(cls, generator: Optional[torch.Generator], shape, device) -> "DiffKDDraws":
        """The draws for teacher features of ``shape`` [B, L, D]."""
        t_step = torch.randint(0, DIFFKD_STEPS, shape[:1], generator=generator, device=device)
        noise = [torch.randn(shape, generator=generator, device=device) for _ in range(3)]
        keep = [torch.rand(shape, generator=generator, device=device) < 0.9
                for _ in range(3)]
        return cls(t_step, noise, keep)


def diffkd_loss(kd: KDSettings, aux, s_feats, t_feats, generator=None, train: bool = True,
                *, draws: Optional[DiffKDDraws] = None, dp: DataParallel = LOCAL):
    """DiffKD on blocks 0, 1 and the last: a cosine noise schedule over 8
    steps with sigma_max 0.3 for the first half and 0.7 for the second; the
    denoiser predicts the noise injected into the normalised teacher feature,
    plus 1/sigma^2-weighted matching of the normalised aligned student
    feature; the total x 5e-5. ``draws`` replaces the draws from
    ``generator``; with ``train`` False the denoiser drops nothing. The
    matching weight is the mean of 1/sigma^2 over the global batch."""
    s_sel = _slice_feats(s_feats, (0, 1, -1), kd.student_prefix)
    t_sel = _slice_feats(t_feats, (0, 1, -1), kd.teacher_prefix)
    if draws is None:
        draws = DiffKDDraws.draw(generator, t_sel[0].shape, t_sel[0].device)
    T = DIFFKD_STEPS
    t_step = draws.t_step
    sigma_max = torch.where(t_step < T // 2, 0.3, 0.7)
    sigma_t = (1.0 - torch.cos(math.pi * t_step.float() / T)) * sigma_max
    w_t = 1.0 / (sigma_t ** 2 + 1e-8)
    w_mean = dp.mean(w_t.mean())

    feat_loss = 0.0
    for i, (layer, s, t) in enumerate(zip(aux.align, s_sel, t_sel)):
        t_n = t.float()
        t_n = t_n / torch.linalg.vector_norm(t_n, dim=-1, keepdim=True)
        s_n = aux_ops.dense(layer, s).float()
        s_n = s_n / torch.linalg.vector_norm(s_n, dim=-1, keepdim=True)
        noise = draws.noise[i] * sigma_t[:, None, None]
        pred = aux_ops.denoise_apply(aux.denoise, t_n + noise, t_step, train=train,
                                     keep=draws.keep[i] if train else None)
        feat_loss = feat_loss + _mean_sq(pred - noise)
        feat_loss = feat_loss + w_mean * _mean_sq(s_n - t_n)
    return feat_loss / 3.0 * 5e-5


def curkd_loss(kd: KDSettings, aux, s_feats, t_feats, generator=None, epoch=0, *,
               noise=None):
    """CurKD, a curriculum on the epoch: before epoch 100 sum-MSE of blocks
    0-2 through ``curkd_align_early``, before 151 of blocks 3-6 through
    ``curkd_align_mid`` (each the mean over its blocks, / B x 4e-5), then
    the last block's masked generation at ratio 0.5 (/ B x 5e-5; ``noise``
    [B, L] replaces the masking draw). The JAX package switches inside its
    compiled step; here the epoch is a Python int and the branch is
    Python's."""
    B = s_feats[0].shape[0]
    sp, tp = kd.student_prefix, kd.teacher_prefix
    epoch = int(epoch)
    if epoch < 151:
        layers, blocks = ((aux.curkd_align_early, range(3)) if epoch < 100
                          else (aux.curkd_align_mid, range(3, 7)))
        loss = 0.0
        for layer, i in zip(layers, blocks):
            x = aux_ops.dense(layer, s_feats[i][:, sp:])
            loss = loss + _sum_sq(x.float() - t_feats[i][:, tp:].float())
        return loss / float(len(blocks)) / B * 4e-5
    stu = aux_ops.dense(aux.curkd_align_last, s_feats[-1][:, sp:])
    tea = t_feats[-1][:, tp:].float()
    x_keep, mask, ids_restore, _ = random_masking(generator, stu, 0.5, noise=noise)
    x = _masked_generation(aux, x_keep, ids_restore)
    m = mask[..., None].float()
    return _sum_sq((x.float() - tea) * m) / B * 5e-5


def saliency_mgd_loss(kd: KDSettings, aux, s_feats, t_feats, *, scores=None):
    """Saliency-MGD: mask the most salient of the last block's tokens (keep
    the lowest attention scores of ``saliency_masking``), regenerate them,
    mean-MSE x 4. ``scores`` [B, L] replaces the attention scores."""
    s = aux_ops.dense(aux.align, s_feats[-1][:, kd.student_prefix:])
    t_full = t_feats[-1]
    x_keep, mask, ids_restore = saliency_masking(
        aux.saliency_attn, t_full, s, kd.saliency_mask_ratio, kd.saliency_method,
        kd.teacher_prefix, scores=scores)
    x = _masked_generation(aux, x_keep, ids_restore)
    tea = t_full[:, kd.teacher_prefix:].float()
    m = mask[..., None].float()
    return _mean_sq((x.float() - tea) * m) * 4.0


def wasskd_loss(kd: KDSettings, aux, s_feats, t_feats):
    """WassKD on layers 0-2. 'l1': one sorted_l1 along the token axis per
    layer (sliced 1-D Wasserstein), in the compute dtype, mean of the three.
    'sinkhorn': the debiased entropic-OT divergence of each sample's token
    clouds, the three layers' [B, N, D] clouds in one batched solve, summed
    and divided by B x N, mean of the three."""
    if kd.wasskd_type == "sinkhorn":
        s_all = torch.stack([aux_ops.dense(aux.align_wasskd[i], s_feats[i][:, kd.student_prefix:])
                             for i in range(3)])                  # [3, B, N, D]
        t_all = torch.stack([t_feats[i][:, kd.teacher_prefix:] for i in range(3)])
        L, B, N, _ = s_all.shape
        div = batched_sinkhorn_divergence(s_all.reshape(L * B, N, -1),
                                          t_all.reshape(L * B, N, -1),
                                          n_iters=kd.sinkhorn_iters)
        return div.sum() / (B * N) / 3.0
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
               noise: Optional[torch.Tensor] = None,
               diffkd_draws: Optional[DiffKDDraws] = None, epoch=0, train: bool = True,
               dp: DataParallel = LOCAL) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combine base and distillation losses for one batch.

    ``aux`` is the ``AuxHeads`` module of the distillation type. The
    objectives draw from ``generator`` unless the draws are given: ``noise``
    [B, L] is the masking noise (vitkd, mgd, curkd's last phase) and
    ``diffkd_draws`` DiffKD's. ``epoch`` (a Python int) picks curkd's phase;
    ``train`` False turns DiffKD's dropout off; ``dp`` holds the ranks over
    which LRKD's and DiffKD's batch-coupled terms are reduced."""
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
    if student_feats is None or teacher_feats is None:
        raise ValueError(f"{t} requires student and teacher features")
    feats = (kd, aux, student_feats, teacher_feats)
    if t == "vitkd":
        distill = vitkd_loss(*feats, generator, noise=noise)
    elif t == "lrkd":
        distill = lrkd_loss(*feats, dp=dp)
    elif t == "diffkd":
        distill = diffkd_loss(*feats, generator, train=train, draws=diffkd_draws, dp=dp)
    elif t == "curkd":
        distill = curkd_loss(*feats, generator, epoch, noise=noise)
    elif t == "saliency_mgd":
        distill = saliency_mgd_loss(*feats)
    elif t == "wasskd":
        distill = wasskd_loss(*feats)
    else:
        distill = mgd_loss(*feats, generator, noise=noise)
    if t in ("lrkd", "diffkd"):
        combined = base * (1.0 - kd.alpha) + distill * kd.alpha
    elif t == "wasskd":
        combined = base + distill * 5.0
    else:
        combined = base + distill
    metrics["distill_loss"] = distill
    return combined, metrics
