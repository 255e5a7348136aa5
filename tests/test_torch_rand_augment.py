"""The port's RandAugment and AutoAugment ops, their matrix builders, the
oblique warps, the policy parsing, the batch-subset path and the mixup modes
against the JAX package's, on the same integer images and the same draws
(every random value the JAX functions draw from their keys is rebuilt, see
``tests/jax_draws.py``, and handed to the port's deterministic halves). The
JAX functions run compiled (``jax.jit``), as the JAX train step runs them.

Tolerances: invert, solarize, solarize_add, posterize and equalize exactly
(and equalize, posterize and solarize against PIL exactly); the blends
(color, contrast, brightness, sharpness) and autocontrast to 1e-3 in pixel
units at fp32 and to one bf16 ulp of the larger value at bf16; the matrix
builders to 1e-5 and the warps to 1e-3 pixel units; mixup to 1e-6. The whole
train transform is in ``test_torch_augment_transform.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.data import augment as ja
from deltakd_tpu.data import mixup as jm
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data import augment as ta
from deltakd_tpu_torch.data import mixup as tm
from tests import jax_draws as jd

torch.set_num_threads(1)

MEAN, STD = (0.5071, 0.4867, 0.4408), (0.2675, 0.2565, 0.2761)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _u8(seed, B=4, H=24, W=24):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 3)).astype(np.uint8)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _assert_op_close(tout, jout, dtype, exact):
    a, b = _np(tout), _np(jout)
    assert a.shape == b.shape
    if exact:
        np.testing.assert_array_equal(a, b)
    elif dtype == "fp32":
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    else:
        assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(np.abs(a), np.abs(b))))


# -----------------------------------------------------------------------------
# Pixel ops
# -----------------------------------------------------------------------------

EXACT_OPS = (1, 2, 4, 5, 6)   # equalize, invert, posterize, solarize, solarize_add


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("op", sorted(ta._PIXEL_OPS))
def test_ra_pixel_ops_match_jax(op, dtype):
    B = 4
    jdt, tdt = DTYPES[dtype]
    u8 = _u8(op)
    m = np.random.RandomState(100 + op).uniform(0, 10, B).astype(np.float32)
    m[0] = 10.0
    key = jax.random.PRNGKey(op)
    jout = jax.jit(lambda x, m: ja._PIXEL_OPS[op](x, m, key, None))(jnp.asarray(u8, jdt),
                                                                    jnp.asarray(m))
    tout = ta._PIXEL_OPS[op](jd.t(u8).to(tdt), jd.t(m), jd.t(jd.sign(key, B)))
    assert tout.dtype == tdt
    _assert_op_close(tout, jout, dtype, exact=op in EXACT_OPS)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("op", [4, 5, 7, 8, 10])
def test_aa_pixel_ops_match_jax(op, dtype):
    """AutoAugment's own appliers (timm's non-increasing maps)."""
    jdt, tdt = DTYPES[dtype]
    u8 = _u8(20 + op)
    level = np.array([0.0, 3.3, 7.0, 10.0], np.float32)
    jout = jax.jit(lambda x, v: ja._AA_PIXEL_OPS[op](x, v, None, None))(jnp.asarray(u8, jdt),
                                                                        jnp.asarray(level))
    tout = ta._AA_PIXEL_OPS[op](jd.t(u8).to(tdt), jd.t(level))
    _assert_op_close(tout, jout, dtype, exact=op in (4, 5))


def test_ops_match_pil():
    """Equalize, posterize and solarize, RandAugment's and AutoAugment's, are
    PIL's exactly (as tests/test_data.py holds the JAX ops)."""
    img = np.random.RandomState(0).randint(0, 256, (32, 32, 3)).astype(np.uint8)
    pil = Image.fromarray(img)
    x = jd.t(img).float()[None]
    np.testing.assert_array_equal(ta.op_equalize(x)[0].numpy(),
                                  np.asarray(ImageOps.equalize(pil), np.float32))
    five = torch.tensor([5.0])
    np.testing.assert_array_equal(ta.op_solarize(x, five)[0].numpy(),
                                  np.asarray(ImageOps.solarize(pil, 128), np.float32))
    np.testing.assert_array_equal(ta.op_posterize(x, five)[0].numpy(),
                                  np.asarray(ImageOps.posterize(pil, 2), np.float32))
    ref = np.asarray(pil, np.int32)
    for level in (0.0, 2.5, 5.0, 8.0, 10.0):
        lv = torch.tensor([level])
        np.testing.assert_array_equal(
            ta._aa_posterize_original(x, lv)[0].numpy(),
            np.asarray(ImageOps.posterize(pil, int(level / 10 * 4) + 4), np.float32))
        thresh = int(level / 10 * 256)
        np.testing.assert_array_equal(ta._aa_solarize(x, lv)[0].numpy(),
                                      np.where(ref < thresh, ref, 255 - ref))
    # a flat channel has step 0 and passes through
    flat = torch.full((1, 8, 8, 3), 77.0)
    assert torch.equal(ta.op_equalize(flat), flat)


# -----------------------------------------------------------------------------
# Geometry
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("op", sorted(ta._GEO_BUILDERS))
def test_geometric_matrices_match_jax(op):
    B, size = 6, 40
    m = np.random.RandomState(op).uniform(0, 10, B).astype(np.float32)
    key = jax.random.PRNGKey(op)
    jmat = ja._GEO_BUILDERS[op](jnp.asarray(m), key, size)
    tmat = ta._GEO_BUILDERS[op](jd.t(m), jd.t(jd.sign(key, B)), size)
    np.testing.assert_allclose(tmat.numpy(), np.asarray(jmat), rtol=0, atol=1e-5)


def _oblique(B, size, seed):
    """Rotations, shears and translations at large magnitudes, composed: many
    output pixels fall outside the source."""
    rng = np.random.RandomState(seed)
    mats = ja._eye23()
    mats = jnp.broadcast_to(mats, (B, 2, 3))
    for i, builder in ja._GEO_BUILDERS.items():
        mats = ja.compose(mats, builder(jnp.asarray(rng.uniform(3, 10, B), jnp.float32),
                                        jax.random.PRNGKey(seed + i), size))
    return np.asarray(mats)


@pytest.mark.parametrize("warp", ["gather", "dense"])
@pytest.mark.parametrize("fill", [False, True])
def test_warps_match_jax(warp, fill):
    u8 = _u8(3, B=4, H=20, W=28).astype(np.float32)
    mats = _oblique(4, 20, 7)
    f = np.array([124.0, 116.0, 104.0], np.float32)
    jfn, tfn = {"gather": (ja.warp_bilinear_batch, ta.warp_bilinear_batch),
                "dense": (ja.warp_dense_matmul, ta.warp_dense_matmul)}[warp]
    jout = jfn(jnp.asarray(u8), jnp.asarray(mats), 18, 22, jnp.asarray(f) if fill else None)
    tout = tfn(jd.t(u8), jd.t(mats), 18, 22, jd.t(f) if fill else None)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-3)
    if fill:   # the matrices do reach outside the image
        assert np.mean(np.all(tout.numpy() == f, axis=-1)) > 0.05


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resample_reflect_matches_jax(method):
    """The --src crop: RandomCrop with reflect padding, coordinates mirrored."""
    u8 = _u8(4, H=32, W=32).astype(np.float32)
    shift = np.array([-4.0, -2.0, 3.0, 4.0], np.float32)
    mats = np.asarray(ja.crop_matrix(shift, shift[::-1].copy(), np.full(4, 32.0),
                                     np.full(4, 32.0), 32, 32), np.float32)
    jout = ja.resample_separable(jnp.asarray(u8), jnp.asarray(mats), 32, 32,
                                 method=method, reflect=True)
    tout = ta.resample_separable(jd.t(u8), jd.t(mats), 32, 32, method=method, reflect=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-3)
    with pytest.raises(ValueError):
        ta.resample_separable(jd.t(u8), jd.t(mats), 32, 32, fill=torch.zeros(3), reflect=True)


# -----------------------------------------------------------------------------
# Policies
# -----------------------------------------------------------------------------

GOOD_SPECS = ("rand-m9-mstd0.5-inc1", "rand-m7-n3-p0.3-mstd1-inc1", "original",
              "original-mstd0.5", "")
BAD_SPECS = ("rand-m9", "originalr", "v0", "augmix-m5", "rand-m9-w0-inc1", "3a",
             "rand-m9-inc0", "original-n2", "bogus")


@pytest.mark.parametrize("spec", GOOD_SPECS + BAD_SPECS)
def test_parse_aa_spec_matches_jax(spec):
    """The same specs parse to the same values, and the same specs raise the
    same exception type, both from parse_aa_spec and from TrainConfig."""
    try:
        jres = ja.parse_aa_spec(spec)
    except Exception as e:   # noqa: BLE001 - the type is what is compared
        with pytest.raises(type(e)):
            ta.parse_aa_spec(spec)
        with pytest.raises(type(e)):
            TrainConfig(aa=spec)
        assert spec in BAD_SPECS
        return
    assert spec in GOOD_SPECS
    tres = ta.parse_aa_spec(spec)
    if jres is None:
        assert tres is None
    else:
        assert type(tres).__name__ == type(jres).__name__
        assert dataclasses.asdict(tres) == dataclasses.asdict(jres)
    TrainConfig(aa=spec)


def test_aa_tables_match_jax():
    jop, jprob, jlvl = ja.AutoAugmentConfig().tables()
    top, tprob, tlvl = ta.AutoAugmentConfig.tables()
    np.testing.assert_array_equal(np.array(top), jop)
    np.testing.assert_array_equal(np.array(tprob, np.float32), jprob)
    np.testing.assert_array_equal(np.array(tlvl, np.float32), jlvl)
    assert ta._AA_POLICY_ORIGINAL == ja._AA_POLICY_ORIGINAL


@pytest.mark.parametrize("op", [1, 10])
def test_apply_on_subset_matches_jax(op):
    """More rows select the op than the subset holds (5 > k = 3): the first
    three selected rows run it, the other two skip it, as in JAX. Sharpness
    draws its sign over the k subset rows."""
    B, k = 8, 3
    u8 = _u8(30 + op, B=B, H=16, W=16).astype(np.float32)
    sel = np.array([False, True, True, False, True, True, False, True])
    m = np.random.RandomState(op).uniform(0, 10, B).astype(np.float32)
    key = jax.random.PRNGKey(op)
    jop, top = ja._PIXEL_OPS[op], ta._PIXEL_OPS[op]
    jout = ja._apply_on_subset(lambda sub, idx: jop(sub, jnp.take(jnp.asarray(m), idx), key,
                                                    None),
                               jnp.asarray(u8), jnp.asarray(sel), k)
    sign = jd.t(jd.sign(key, k))
    tout = ta._apply_on_subset(lambda sub, idx: top(sub, jd.t(m)[idx], sign[:sub.shape[0]]),
                               jd.t(u8), jd.t(sel), k)
    _assert_op_close(tout, jout, "fp32", exact=op == 1)
    changed = np.any(tout.numpy() != u8, axis=(1, 2, 3))
    np.testing.assert_array_equal(changed, [False, True, True, False, True, False, False,
                                            False])


@pytest.mark.parametrize("kw", [
    dict(), dict(aa="original-mstd0.5"), dict(ThreeAugment=True), dict(src=True),
    dict(aa="", color_jitter=0.3), dict(aug_pixel_bf16=False, mesh_shape=(2, 1)),
    dict(input_size=32, interpolation="random", mesh_shape=(1, 2))])
def test_augment_config_from_config_matches_jax(kw):
    """Same TrainConfig values, same AugmentConfig fields. mesh_shape is given
    where the JAX package would count this process's devices: in the port
    None means one card, so the heavy ops run on a subset."""
    shared = dict(dict(dataset="cifar-100", mesh_shape=(1,)), **kw)
    jac = ja.AugmentConfig.from_config(JTrainConfig(**shared).validate())
    tac = ta.AugmentConfig.from_config(TrainConfig(**shared))
    for f in dataclasses.fields(jac):
        a, b = getattr(jac, f.name), getattr(tac, f.name)
        if dataclasses.is_dataclass(a):
            assert type(a).__name__ == type(b).__name__ and dataclasses.asdict(a) == \
                dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert ta.AugmentConfig.from_config(TrainConfig(dataset="cifar-100")).subset_ops


def test_train_config_constructs_with_its_defaults():
    cfg = TrainConfig()
    assert (cfg.aa, cfg.color_jitter, cfg.mixup_mode) == ("rand-m9-mstd0.5-inc1", 0.3, "batch")
    ac = ta.AugmentConfig.from_config(cfg)
    assert ac.rand_augment == ta.RandAugmentConfig(9.0, 0.5, 2, 0.5)
    assert ac.color_jitter == 0.0 and ac.pixel_bf16 and ac.reprob == 0.25
    TrainConfig(mixup_mode="elem", ThreeAugment=True, src=True, color_jitter=0.4, aa="")
    with pytest.raises(ValueError):
        TrainConfig(mixup_mode="pairs")


# -----------------------------------------------------------------------------
# Mixup modes
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("B", [6, 5])
@pytest.mark.parametrize("mode", ["elem", "pair"])
def test_mixup_modes_match_jax(mode, B):
    """Per-image decisions ('elem'), and mirrored between partners i, B-1-i
    ('pair'; B = 5 leaves the middle image its own)."""
    imgs = np.random.RandomState(B).randn(B, 16, 16, 3).astype(np.float32)
    labels = np.arange(B) % 4
    jmc = jm.MixupConfig(prob=0.8, num_classes=10, mode=mode)
    tmc = tm.MixupConfig(prob=0.8, num_classes=10, mode=mode)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jimg, jtgt = jm.apply_mixup(key, jnp.asarray(imgs), jnp.asarray(labels), jmc)
        timg, ttgt = tm.mix_batch(jd.t(imgs), jd.t(labels), tmc,
                                  jd.mixup_draws(key, B, 16, 16, jmc))
        np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=1e-6)
        np.testing.assert_allclose(ttgt.numpy(), np.asarray(jtgt), atol=1e-6)
    # the port's own draws: one per image, and pairs that mirror
    g = torch.Generator().manual_seed(0)
    d = tm.draw_mixup(g, tmc, B, 16, 16)
    assert d.lam_mix.shape == (B,) and d.cy.shape == (B,)
    timg, ttgt = tm.apply_mixup(g, jd.t(imgs), jd.t(labels), tmc)
    np.testing.assert_allclose(ttgt.sum(1).numpy(), 1.0, rtol=1e-6)
    if mode == "pair":   # partners mix with one lam and one box: their sum stays
        np.testing.assert_allclose((timg + timg.flip(0)).numpy(), imgs + imgs[::-1],
                                   atol=1e-5)
