"""Test helper: the random values that the JAX package's train transform,
mixup and DiffKD loss draw from their keys, rebuilt as the port's draws
(``deltakd_tpu_torch.data.augment.TrainDraws``, ``data.mixup.MixupDraws``,
``kd.losses.DiffKDDraws``), so that both packages' deterministic halves see
the same draws. Every key split and fold follows
``deltakd_tpu/data/augment.py`` ``train_transform``,
``deltakd_tpu/data/mixup.py`` ``apply_mixup`` and
``deltakd_tpu/kd/losses.py`` ``diffkd_loss``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deltakd_tpu.data import augment as ja
from deltakd_tpu_torch.data import augment as ta
from deltakd_tpu_torch.data import mixup as tm
from deltakd_tpu_torch.kd import losses as tl


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def sign(key, n):
    """The +-1 of ``jnp.where(jax.random.bernoulli(key, 0.5, (n,)), 1, -1)``."""
    return np.where(np.asarray(jax.random.bernoulli(key, 0.5, (n,))), 1.0,
                    -1.0).astype(np.float32)


def rrc_draws(keys):
    def one(k):
        k_area, k_ratio, k_top, k_left = jax.random.split(k, 4)
        return (jax.random.uniform(k_area, (10,), minval=0.08, maxval=1.0),
                jax.random.uniform(k_ratio, (10,), minval=math.log(3 / 4),
                                   maxval=math.log(4 / 3)),
                jax.random.uniform(k_top, (10,)), jax.random.uniform(k_left, (10,)))
    return [t(v) for v in jax.vmap(one)(keys)]


def erase_draws(key, shape, prob):
    """timm RandomErasing, mode 'pixel', one box."""
    B, H, W, C = shape
    k_do, _, k_area, k_ratio, k_top, k_left, k_noise = jax.random.split(key, 7)
    u = lambda k, lo=0.0, hi=1.0: t(jax.random.uniform(k, (B, 1), minval=lo, maxval=hi))  # noqa
    return ta.ErasingDraws(
        t(jax.random.bernoulli(k_do, prob, (B,))), torch.ones(B, dtype=torch.long),
        u(k_area, 0.02, 1 / 3), u(k_ratio, math.log(0.3), math.log(10 / 3)), u(k_top),
        u(k_left), t(jax.random.normal(k_noise, shape, jnp.float32)))


def jitter_draws(key, B, strength):
    kb, kc, ks, ko = jax.random.split(key, 4)
    lo, hi = max(0.0, 1 - strength), 1 + strength
    f = [t(jax.random.uniform(k, (B,), minval=lo, maxval=hi)) for k in (kb, kc, ks)]
    return ta.JitterDraws(*f, t(jax.random.permutation(ko, 3)).long())


def _op_draws(op_idx, apply, m, signs):
    return ta.OpDraws(t(op_idx).long(), t(apply), t(m).float(), t(signs))


def train_draws(key, shape, jac):
    """What ``ja.train_transform(key, images, jac)`` draws, as TrainDraws."""
    B, H, W, C = shape
    S = jac.input_size
    k_crop, k_flip, k_aug, k_geo, k_erase, _ = jax.random.split(key, 6)
    if jac.small_input_crop or jac.src:
        scale = min(H, W) / S
        k_t, k_l = jax.random.split(k_crop)
        top, left = ((t(jax.random.randint(k, (B,), 0, 9)).float() - 4.0) * scale
                     for k in (k_t, k_l))
        ch = cw = torch.full((B,), S * scale)
    else:
        top, left, ch, cw = ta.rrc_from_draws(*rrc_draws(jax.random.split(k_crop, B)), H, W)
    d = ta.TrainDraws(top, left, ch, cw, t(jax.random.bernoulli(k_flip, 0.5, (B,))), None,
                      erase_draws(k_erase, (B, S, S, C), jac.reprob)
                      if jac.reprob > 0 else None)

    def geo_signs(signs, k_g):
        for i in ja._GEO_BUILDERS:
            signs[i] = sign(jax.random.fold_in(k_g, i), B)

    if jac.three_augment:
        k_choice, k_blur, k_cj = jax.random.split(k_aug, 3)
        d.three = ta.ThreeAugDraws(
            t(jax.random.randint(k_choice, (B,), 0, 3)).long(),
            t(jax.random.uniform(k_blur, (B,), minval=0.1, maxval=2.0)),
            jitter_draws(k_cj, B, jac.color_jitter) if jac.color_jitter > 0 else None)
    elif jac.rand_augment is not None:
        d.ra = []
        for layer in range(jac.rand_augment.num_layers):
            k_l = jax.random.fold_in(k_aug, layer)
            op_idx, apply, m = ja._sample_ra_layer(k_l, B, jac.rand_augment)
            signs = np.ones((ta.NUM_RAND_OPS, B), np.float32)
            geo_signs(signs, jax.random.fold_in(k_geo, layer))
            k_px = jax.random.fold_in(k_l, 999)
            for i in (7, 8, 9):
                signs[i] = sign(jax.random.fold_in(k_px, i), B)
            # sharpness draws its sign over the subset's rows
            n = min(max(8, B // 8), B) if jac.subset_ops else B
            signs[10, :n] = sign(jax.random.fold_in(k_px, 10), n)
            d.ra.append(_op_draws(op_idx, apply, m, signs))
    elif jac.auto_augment is not None:
        sp = jax.random.randint(jax.random.fold_in(k_aug, 0x5F), (B,), 0, 25)
        d.aa = []
        for slot in range(2):
            op_idx, apply, level = ja._sample_aa_slot(jax.random.fold_in(k_aug, slot), sp,
                                                      slot, jac.auto_augment)
            signs = np.ones((ta.NUM_RAND_OPS, B), np.float32)
            geo_signs(signs, jax.random.fold_in(k_geo, slot))
            d.aa.append(_op_draws(op_idx, apply, level, signs))
    elif jac.color_jitter > 0:
        d.jitter = jitter_draws(k_aug, B, jac.color_jitter)
    return d


def mixup_draws(key, B, H, W, mc):
    """What ``jm.apply_mixup(key, ...)`` draws: 0-d in 'batch' mode, one per
    image (before pairing) in 'elem' and 'pair'."""
    k_do, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    shape = () if mc.mode == "batch" else (B,)

    def box(k):
        k_y, k_x = jax.random.split(k)
        return jax.random.randint(k_y, (), 0, H), jax.random.randint(k_x, (), 0, W)

    cy, cx = box(k_box) if mc.mode == "batch" else jax.vmap(box)(jax.random.split(k_box, B))
    f = lambda v: t(v).float()  # noqa: E731
    return tm.MixupDraws(
        t(jax.random.bernoulli(k_do, mc.prob, shape)),
        t(jax.random.bernoulli(k_switch, mc.switch_prob, shape)),
        f(jax.random.beta(k_lam_m, mc.mixup_alpha, mc.mixup_alpha, shape)),
        f(jax.random.beta(k_lam_c, mc.cutmix_alpha, mc.cutmix_alpha, shape)), f(cy), f(cx))


def diffkd_draws(key, shape):
    """What ``diffkd_loss(..., rng=key)`` draws for teacher features of
    ``shape`` [B, L, D]: the timesteps, and per layer i the noise and the
    denoiser's dropout keep mask from ``fold_in(k_rest, i)``."""
    k_t, k_rest = jax.random.split(key)
    t_step = t(jax.random.randint(k_t, shape[:1], 0, tl.DIFFKD_STEPS)).long()
    noise, keep = [], []
    for i in range(3):
        k_noise, k_drop = jax.random.split(jax.random.fold_in(k_rest, i))
        noise.append(t(jax.random.normal(k_noise, shape)))
        keep.append(t(jax.random.bernoulli(k_drop, 0.9, shape)))
    return tl.DiffKDDraws(t_step, noise, keep)
