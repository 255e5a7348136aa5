"""The port's augmentation and mixup against the JAX package's, with the
random draws reproduced from the JAX keys and fed to the port's
deterministic halves.

Resampling differs only in summation order, but both sides round pixels to
integers, so a value at a .5 boundary may round the other way: such a pixel
is one grey level (1/255/std after normalisation) apart, and the tests allow
that on under 1% of values. Everything else is compared to 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.data import augment as ja
from deltakd_tpu.data import mixup as jm
from deltakd_tpu_torch.data import augment as ta
from deltakd_tpu_torch.data import mixup as tm

torch.set_num_threads(1)

MEAN, STD = (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)
LEVEL = 1.0 / (255.0 * min(STD))   # one grey level after normalisation


def _u8(seed, B=4, H=32, W=32):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 3)).astype(np.uint8)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close_pixels(a, b, tol=1e-5, level=LEVEL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(jnp.asarray(b, jnp.float32))
    assert a.shape == b.shape
    diff = np.abs(a - b)
    assert diff.max() <= level + tol, diff.max()
    assert np.mean(diff > tol) < 0.01, np.mean(diff > tol)


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "random"])
@pytest.mark.parametrize("out", [48, 20])
def test_resample_separable_matches_jax(method, out):
    rng = np.random.RandomState(1)
    imgs = _u8(1).astype(np.float32)
    B = imgs.shape[0]
    top, left = rng.uniform(-3, 10, B), rng.uniform(-3, 10, B)
    ch, cw = rng.uniform(8, 30, B), rng.uniform(8, 30, B)
    mats = np.asarray(ja.crop_matrix(top, left, ch, cw, out, out), np.float32)
    pick = np.array([True, False, True, False])
    fill = np.zeros(3, np.float32)
    jout = ja.resample_separable(jnp.asarray(imgs), jnp.asarray(mats), out, out,
                                 fill=jnp.asarray(fill), method=method,
                                 pick=jnp.asarray(pick))
    tout = ta.resample_separable(_t(imgs), _t(mats), out, out, fill=_t(fill),
                                 method=method, pick=_t(pick))
    # bicubic rounds between passes: allow one grey level of rounding flips
    _close_pixels(tout, jout, tol=1e-3, level=1.0)


def _jax_rrc_draws(keys):
    def one(k):
        k_area, k_ratio, k_top, k_left = jax.random.split(k, 4)
        return (jax.random.uniform(k_area, (10,), minval=0.08, maxval=1.0),
                jax.random.uniform(k_ratio, (10,), minval=math.log(3 / 4),
                                   maxval=math.log(4 / 3)),
                jax.random.uniform(k_top, (10,)), jax.random.uniform(k_left, (10,)))
    return [_t(v) for v in jax.vmap(one)(keys)]


@pytest.mark.parametrize("hw", [(32, 32), (8, 64)])
def test_random_resized_crop_matches_jax(hw):
    """Same uniforms -> same boxes, including the centre-crop fallback that the
    8x64 canvas forces on some samples."""
    h, w = hw
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    jbox = jax.vmap(lambda k: ja.random_resized_crop_params(k, h, w))(keys)
    tbox = ta.rrc_from_draws(*_jax_rrc_draws(keys), h, w)
    for a, b in zip(tbox, jbox):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _jax_erase_draws(key, shape, prob, mode, K):
    B, H, W, C = shape
    k_do, k_cnt, k_area, k_ratio, k_top, k_left, k_noise = jax.random.split(key, 7)
    count = (jax.random.randint(k_cnt, (B,), 1, K + 1) if K > 1
             else jnp.ones((B,), jnp.int32))
    u = lambda k, lo=0.0, hi=1.0: jax.random.uniform(k, (B, K), minval=lo, maxval=hi)  # noqa
    noise = {"pixel": lambda: jax.random.normal(k_noise, shape, jnp.float32),
             "rand": lambda: jax.random.normal(k_noise, (B, K, C), jnp.float32),
             "const": lambda: None}[mode]()
    return ta.ErasingDraws(
        _t(jax.random.bernoulli(k_do, prob, (B,))), _t(count).long(),
        _t(u(k_area, 0.02, 1 / 3)), _t(u(k_ratio, math.log(0.3), math.log(10 / 3))),
        _t(u(k_top)), _t(u(k_left)), None if noise is None else _t(noise))


@pytest.mark.parametrize("mode", ["pixel", "const", "rand"])
def test_random_erasing_matches_jax(mode):
    key = jax.random.PRNGKey(5)
    imgs = np.random.RandomState(5).randn(6, 24, 24, 3).astype(np.float32)
    jout = ja.random_erasing_batch(key, jnp.asarray(imgs), 0.7, mode=mode, max_count=2)
    d = _jax_erase_draws(key, imgs.shape, 0.7, mode, 2)
    tout = ta.apply_random_erasing(_t(imgs), d, mode)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6)
    assert not np.allclose(np.asarray(jout), imgs)   # something was erased


def _jax_config(S, bf16, reprob):
    return ja.AugmentConfig(input_size=S, mean=MEAN, std=STD, reprob=reprob,
                            small_input_crop=S <= 32, pixel_bf16=bf16)


@pytest.mark.parametrize("S,bf16", [(48, False), (48, True), (32, False)])
def test_train_transform_matches_jax(S, bf16):
    """The whole train transform (crop, flip, resample, rounding, bf16 cast,
    normalise, erasing) from the draws JAX makes for the same key."""
    B = 4
    u8 = _u8(7, B)
    key = jax.random.PRNGKey(11)
    jout = ja.train_transform(key, jnp.asarray(u8), _jax_config(S, bf16, 0.5))

    k_crop, k_flip, _, _, k_erase, _ = jax.random.split(key, 6)
    if S <= 32:
        k_t, k_l = jax.random.split(k_crop)
        top, left = (_t(jax.random.randint(k, (B,), 0, 9)).float() - 4.0 for k in (k_t, k_l))
        ch = cw = torch.full((B,), float(S))
    else:
        keys = jax.random.split(k_crop, B)
        top, left, ch, cw = ta.rrc_from_draws(*_jax_rrc_draws(keys), 32, 32)
    flip = _t(jax.random.bernoulli(k_flip, 0.5, (B,)))
    d = ta.TrainDraws(top, left, ch, cw, flip, None,
                      _jax_erase_draws(k_erase, (B, S, S, 3), 0.5, "pixel", 1))
    ac = ta.AugmentConfig(input_size=S, mean=MEAN, std=STD, reprob=0.5,
                          small_input_crop=S <= 32, pixel_bf16=bf16)
    tout = ta.apply_train_transform(_t(u8), ac, d)
    assert tout.dtype == (torch.bfloat16 if bf16 else torch.float32)
    # bf16: one bf16 ulp at the normalised range (|x| < 4) on top
    _close_pixels(tout, jout, tol=1.6e-2 if bf16 else 1e-5)


@pytest.mark.parametrize("S", [48, 32])
def test_eval_transform_matches_jax(S):
    u8 = _u8(9)
    jout = ja.eval_transform(jnp.asarray(u8), _jax_config(S, False, 0.0))
    tout = ta.eval_transform(_t(u8), ta.AugmentConfig(input_size=S, mean=MEAN, std=STD))
    _close_pixels(tout, jout, tol=1e-4)


def _jax_mixup_draws(key, H, W, mc):
    k_do, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    k_y, k_x = jax.random.split(k_box)
    f = lambda v: _t(v).float()  # noqa: E731
    return tm.MixupDraws(
        _t(jax.random.bernoulli(k_do, mc.prob, ())),
        _t(jax.random.bernoulli(k_switch, mc.switch_prob, ())),
        f(jax.random.beta(k_lam_m, mc.mixup_alpha, mc.mixup_alpha, ())),
        f(jax.random.beta(k_lam_c, mc.cutmix_alpha, mc.cutmix_alpha, ())),
        f(jax.random.randint(k_y, (), 0, H)), f(jax.random.randint(k_x, (), 0, W)))


@pytest.mark.parametrize("seed", range(6))
def test_mixup_and_cutmix_match_jax(seed):
    imgs = np.random.RandomState(seed).randn(4, 16, 16, 3).astype(np.float32)
    labels = np.array([1, 3, 3, 7])
    jmc = jm.MixupConfig(prob=0.8, num_classes=10)
    key = jax.random.PRNGKey(seed)
    jimg, jtgt = jm.apply_mixup(key, jnp.asarray(imgs), jnp.asarray(labels), jmc)
    tmc = tm.MixupConfig(prob=0.8, num_classes=10)
    timg, ttgt = tm.mix_batch(_t(imgs), _t(labels), tmc, _jax_mixup_draws(key, 16, 16, jmc))
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-6)
    np.testing.assert_allclose(ttgt.numpy(), np.asarray(jtgt), atol=1e-6)


def test_beta_sampler_moments():
    """The on-device Beta(a, a) draw has the right mean and variance."""
    g = torch.Generator().manual_seed(0)
    for a in (0.8, 1.0):
        s = torch.stack([tm._beta(g, a, "cpu") for _ in range(3000)])
        assert abs(float(s.mean()) - 0.5) < 0.02
        assert abs(float(s.var()) - 1 / (4 * (2 * a + 1))) < 0.01
        assert float(s.min()) >= 0.0 and float(s.max()) <= 1.0


def test_draws_come_from_the_generator():
    u8 = torch.from_numpy(_u8(2))
    ac = ta.AugmentConfig(input_size=48, mean=MEAN, std=STD, reprob=0.5)
    a = ta.train_transform(torch.Generator().manual_seed(1), u8, ac)
    b = ta.train_transform(torch.Generator().manual_seed(1), u8, ac)
    c = ta.train_transform(torch.Generator().manual_seed(2), u8, ac)
    assert torch.equal(a, b) and not torch.equal(a, c)
