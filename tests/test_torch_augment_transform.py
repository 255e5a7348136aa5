"""The port's whole train transform against the JAX package's
``train_transform``, on the draws the JAX function makes from its key
(rebuilt by ``tests/jax_draws.py``): RandAugment ``rand-m9-mstd0.5-inc1`` and
AutoAugment ``original-mstd0.5`` with their geometric ops as a dense warp at
source resolution (S = 48 from 32 px), as a gather warp at output resolution
(S = 48 from 64 px) and under RandomCrop (S = 32), 3-Augment, ``--src`` and
colour jitter without aa, at fp32 and bf16; then one soft-KD train step of
the port on the port's RA-augmented batch against the JAX step on JAX's.

The transform is held in its two stages with ``_close_pixels`` at the
tolerances of ``test_torch_augment.py::test_train_transform_matches_jax``
(at most one grey level anywhere, and under 1% of the values beyond 1e-5 at
fp32 or one bf16 ulp at bf16): the geometric stage, whose integer pixels
differ only by a rounding flip where the two packages' resample sums differ
in their last bit; then the pixel stage from JAX's integers against JAX's
whole transform. Each test prints the share it saw, and that of the whole
port transform against JAX's, which is not held to one grey level: a blend
with a factor above 1 (up to 1.9 a layer) stretches a first-stage flip, and
equalize moves a channel's LUT for one flipped pixel. The JAX transform runs
compiled, as the JAX train step runs it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.data import augment as ja
from deltakd_tpu_torch.data import augment as ta
from tests import jax_draws as jd

torch.set_num_threads(1)

MEAN, STD = (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)
LEVEL = 1.0 / (255.0 * min(STD))   # one grey level after normalisation
RA_SPEC, AA_SPEC = "rand-m9-mstd0.5-inc1", "original-mstd0.5"


def _u8(seed, B, H, W):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 3)).astype(np.uint8)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_pixels(a, b, tol, level=LEVEL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    diff = np.abs(a - b)
    share = float(np.mean(diff > tol))
    print(f"share of values beyond {tol}: {share:.5f}; max diff {diff.max():.3e}")
    assert diff.max() <= level + tol, diff.max()
    assert share < 0.01, share


def _configs(S, bf16, subset=True, **kw):
    common = dict(input_size=S, mean=MEAN, std=STD, reprob=0.5, small_input_crop=S <= 32,
                  pixel_bf16=bf16, subset_ops=subset)
    aa = kw.pop("aa", None)
    jac = ja.AugmentConfig(**common, **kw, **_policy(ja, aa))
    tac = ta.AugmentConfig(**common, **kw, **_policy(ta, aa))
    return jac, tac


def _policy(mod, spec):
    p = mod.parse_aa_spec(spec) if spec else None
    return dict(rand_augment=p if isinstance(p, mod.RandAugmentConfig) else None,
                auto_augment=p if isinstance(p, mod.AutoAugmentConfig) else None)


JAX_TRANSFORM = jax.jit(ja.train_transform, static_argnums=2)


def _jax_geometric_stage(key, u8, jac, monkeypatch):
    """JAX's train_transform up to its rounding and bf16 cast: a fresh trace
    with its pixel ops, normalisation and erasing switched off (the draws of
    the crop, the flip and the geometric ops do not change)."""
    geo_only = dataclasses.replace(jac, three_augment=False, color_jitter=0.0, reprob=0.0)
    with monkeypatch.context() as mp:
        mp.setattr(ja, "_PIXEL_OPS", {})
        mp.setattr(ja, "_AA_PIXEL_OPS", {})
        mp.setattr(ja, "_normalize", lambda img, ac: img)
        return jax.jit(ja.train_transform, static_argnums=2)(key, jnp.asarray(u8), geo_only)


def _hold_transform(u8, jac, tac, key, bf16, monkeypatch):
    """The two stages of the port's transform against JAX's, each with
    ``_close_pixels``: the geometric stage (integer pixels, so a difference is
    a rounding flip of one level), then the pixel stage from JAX's integers
    against JAX's whole transform. The whole port transform against JAX's is
    printed and held to the same share; its largest difference is not
    bounded by one level, because a blend with a factor above 1 (up to 1.9 a
    layer) stretches a one-level flip of the first stage."""
    d = jd.train_draws(key, u8.shape, jac)
    jgeo = _jax_geometric_stage(key, u8, jac, monkeypatch)
    tgeo = ta.geometric_stage(jd.t(u8), tac, d)
    assert tgeo.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close_pixels(tgeo, jgeo, tol=1e-3, level=1.0)
    jout = JAX_TRANSFORM(key, jnp.asarray(u8), jac)
    tout = ta.pixel_stage(jd.t(_np(jgeo)).to(tgeo.dtype), tac, d)
    assert tout.dtype == tgeo.dtype
    # bf16: one bf16 ulp at the normalised range (|x| < 4) on top
    tol = 1.6e-2 if bf16 else 1e-5
    _close_pixels(tout, jout, tol=tol)
    whole = np.abs(_np(ta.apply_train_transform(jd.t(u8), tac, d)) - _np(jout))
    print(f"whole transform: share beyond {tol}: {np.mean(whole > tol):.5f}; "
          f"max diff {whole.max():.3e}")
    return d


def _geo_drawn(ops):
    geo = torch.tensor(list(ta._GEO_BUILDERS))
    return any(bool((op.apply & torch.isin(op.op_idx, geo)).any()) for op in ops)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("S,H", [(48, 32), (48, 64), (32, 32)])
@pytest.mark.parametrize("spec", [RA_SPEC, AA_SPEC])
def test_train_transform_with_aa_matches_jax(spec, S, H, bf16, monkeypatch):
    """RA and AA through the whole transform: S = 48 from 32 px (the
    geometric ops as a dense warp at source resolution before the resample),
    S = 48 from 64 px (a gather warp after it) and S = 32 (RandomCrop with
    zero padding). The key is the first whose draws hold a geometric op, so
    that the warp runs."""
    B = 8
    u8 = _u8(40, B, H, H)
    jac, tac = _configs(S, bf16, aa=spec)
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if _geo_drawn((lambda d: d.ra or d.aa)(jd.train_draws(k, u8.shape, jac))))
    d = _hold_transform(u8, jac, tac, key, bf16, monkeypatch)
    assert len(d.ra or d.aa) == 2


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("variant", ["three", "src", "jitter"])
def test_three_augment_src_and_jitter_match_jax(variant, bf16, monkeypatch):
    """3-Augment with colour jitter; --src (RandomCrop with reflect padding)
    under RandAugment; colour jitter without aa (its order drawn per batch)."""
    kw = {"three": dict(three_augment=True, color_jitter=0.3),
          "src": dict(src=True, aa=RA_SPEC),
          "jitter": dict(color_jitter=0.4)}[variant]
    u8 = _u8(50, 8, 32, 32)
    jac, tac = _configs(48, bf16, **kw)
    if variant == "three":
        jac = dataclasses.replace(jac, reprob=0.0)
        tac = dataclasses.replace(tac, reprob=0.0)
    _hold_transform(u8, jac, tac, jax.random.PRNGKey(5), bf16, monkeypatch)


