"""The port at the sequence lengths of inputs of 448 px and up, against the
JAX package: the plain block forward and backward (dx and the 12 weight
gradients) against the JAX reference and ``jax.vjp`` of it at N = 786 (448
px: 28 x 28 patches and two prefix tokens) and 1026 (512 px); the plain
flash backward against the JAX flash backward's Pallas body run by the
Pallas interpreter at the same lengths; the plain ``sorted_l1`` and its
gradient against ``deltakd_tpu.ops.sort.sorted_l1`` (the XLA network) at
1296 patch rows (576 px) and at 4225 (1040 px, the sort kernels' long
route); the long route's merge schedule (``ops.sort.long_schedule``)
emulated with numpy against np.sort; a model at 448 px, logits and
gradients; and the factory, which builds every size the JAX package takes,
1040 px WassKD-l1 and 3488 px soft KD among them.

Narrow widths (D = 128, 2 heads, depth 2, B = 1), fp32 on the CPU: the
differences are summation order only, so the tolerance is 1e-4 of the
largest reference value (1e-5 for the flash backward and sorted_l1, as in
tests/test_torch_attention.py and tests/test_torch_sort.py). The kernels
run only on a card (tests/test_torch_cuda.py, chip_smoke.py phase 18).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deltakd_tpu.models import registry as jregistry
from deltakd_tpu.models.vit import Block
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.ops import attention as jat
from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu.ops import sort as jsort
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.models import factory
from deltakd_tpu_torch.models import registry
from deltakd_tpu_torch.models.convert import flax_block_to_torch, flax_to_torch
from deltakd_tpu_torch.models.vit import ViTConfig
from deltakd_tpu_torch.ops import attention as tat
from deltakd_tpu_torch.ops import fused_block as tfb
from deltakd_tpu_torch.ops import sort as tsort

torch.set_num_threads(1)

TOL = 1e-4
LONG_N = [786, 1026]          # 448 px and 512 px, distilled (two prefix tokens)
WIDTH, HEADS, KEEP = 128, 2, 0.9


def _np(a):
    return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol=TOL):
    a, b = _np(a).astype(np.float32), _np(b).astype(np.float32)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def _block(n, seed):
    blk = Block(num_heads=HEADS, mlp_ratio=4.0, qkv_bias=True, drop_path_rate=0.0,
                ln_eps=1e-6)
    params = blk.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, n, WIDTH)),
                      True)["params"]
    rng = np.random.RandomState(seed)
    # every parameter off its init, so that the LayerNorm and bias gradients
    # are not trivial
    params = jax.tree.map(lambda p: p + 0.05 * rng.randn(*p.shape).astype(np.float32), params)
    x = rng.randn(1, n, WIDTH).astype(np.float32)
    g_out, g_feat = (rng.randn(1, n, WIDTH).astype(np.float32) for _ in range(2))
    return params, x, g_out, g_feat


@pytest.mark.parametrize("n", LONG_N)
def test_plain_block_forward_and_backward_match_jax_at_long_n(n):
    """The plain block (what the card's rows 1 and 2, and the pair's 7 and
    8, are held to): out, feat, dx and the 12 weight gradients with a
    cotangent on both outputs, against the JAX reference and jax.vjp of it."""
    params, x, g_out, g_feat = _block(n, n)
    sa, sm = np.array([1 / KEEP], np.float32), np.array([1.0], np.float32)
    kw = dict(num_heads=HEADS)

    def jfwd(p, x):
        return jfb.reference_vit_block(x, p, scale_attn=jnp.asarray(sa),
                                       scale_mlp=jnp.asarray(sm), **kw)

    (j_out, j_feat), vjp = jax.vjp(jfwd, params, jnp.asarray(x))
    j_dp, j_dx = vjp((jnp.asarray(g_out), jnp.asarray(g_feat)))
    tp = flax_block_to_torch(params)
    tkw = dict(scale_attn=torch.from_numpy(sa), scale_mlp=torch.from_numpy(sm), **kw)
    t_out, t_feat = tfb.reference_vit_block(torch.from_numpy(x), tp, **tkw)
    tfb.reset_launches()
    t_dx, t_dws = tfb.reference_vit_block_bwd(torch.from_numpy(x), tp, torch.from_numpy(g_out),
                                              torch.from_numpy(g_feat), **tkw)
    assert not tfb.LAUNCHES
    assert t_out.shape == (1, n, WIDTH)
    _close(t_out - torch.from_numpy(x), np.asarray(j_out) - x)
    _close(t_feat, j_feat)
    _close(t_dx, j_dx)
    j_dws = flax_block_to_torch(j_dp)
    assert set(j_dws) == set(tfb.PARAM_NAMES)
    for name in tfb.PARAM_NAMES:
        _close(t_dws[name], j_dws[name])


def _pallas_fwd(q3, k3, v3):
    BH, N, D = q3.shape
    spec = pl.BlockSpec((1, N, D), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jat._fwd_kernel, scale=D ** -0.5), grid=(BH,),
        in_specs=[spec] * 3,
        out_specs=(spec, pl.BlockSpec((1, N, 1), lambda i: (i, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((BH, N, D), q3.dtype),
                   jax.ShapeDtypeStruct((BH, N, 1), jnp.float32)),
        interpret=True)(q3, k3, v3)


def _pallas_bwd(q3, k3, v3, o3, lse, do3):
    BH, N, D = q3.shape
    spec = pl.BlockSpec((1, N, D), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jat._bwd_kernel, scale=D ** -0.5), grid=(BH,),
        in_specs=[spec] * 4 + [pl.BlockSpec((1, N, 1), lambda i: (i, 0, 0)), spec],
        out_specs=(spec,) * 3,
        out_shape=tuple(jax.ShapeDtypeStruct((BH, N, D), q3.dtype) for _ in range(3)),
        interpret=True)(q3, k3, v3, o3, lse, do3)


@pytest.mark.parametrize("n", LONG_N)
def test_plain_flash_backward_matches_jax_flash_backward_at_long_n(n):
    """The plain flash backward (row 4's reference on the card) against the
    JAX flash kernels' bodies (`_fwd_kernel`, `_bwd_kernel`) in the Pallas
    interpreter: one head at head dim 64, q and k of std 2; tolerance 1e-5."""
    rng = np.random.RandomState(n)
    q, k = (2.0 * rng.randn(1, 1, n, 64).astype(np.float32) for _ in range(2))
    v, do = (rng.randn(1, 1, n, 64).astype(np.float32) for _ in range(2))
    q3, k3, v3, do3 = (jnp.asarray(a.reshape(1, n, 64)) for a in (q, k, v, do))
    o3, lse = _pallas_fwd(q3, k3, v3)
    j_grads = _pallas_bwd(q3, k3, v3, o3, lse, do3)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    t_o, t_lse = tat._plain_fwd(tq, tk, tv)
    _close(t_o.reshape(1, n, 64), o3, 1e-5)
    _close(t_lse.reshape(1, n, 1), lse, 1e-5)
    for a, b in zip(tat._plain_bwd(tq, tk, tv, t_o, t_lse, tdo), j_grads):
        _close(a.reshape(1, n, 64), b, 1e-5)


def test_plain_sorted_l1_matches_jax_at_1296_rows():
    """sorted_l1 (its plain autograd Function on the CPU, row 10 and 11's
    reference) and its gradient against the JAX package's sorted_l1 (the XLA
    network, which takes any n) at WassKD-l1's 1,296 patch rows of a 576-px
    input: tie-free fp32 draws, so the value and the gradient hold to rtol
    1e-5; t's gradient is zero."""
    rng = np.random.RandomState(12)
    s, t = (rng.randn(2, 1296, 24).astype(np.float32) for _ in range(2))
    v, g = jax.value_and_grad(lambda x: jsort.sorted_l1(x, jnp.asarray(t), axis=1))(
        jnp.asarray(s))
    ts, tt = (torch.from_numpy(a).requires_grad_(True) for a in (s, t))
    tsort.reset_launches()
    loss = tsort.sorted_l1(ts, tt, 1)
    gs, gt = torch.autograd.grad(loss, [ts, tt], allow_unused=True)
    assert not tsort.LAUNCHES
    np.testing.assert_allclose(loss.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(g), rtol=1e-5, atol=1e-12)
    assert gt is None or float(gt.abs().max()) == 0.0


LONG_MODEL = dict(embed_dim=WIDTH, depth=2, num_heads=HEADS, distilled=True)


@pytest.fixture
def long_model(monkeypatch):
    """A narrow distilled model of the zoo's patch-16 family in both
    registries, as the factories build it."""
    name = "long_test_distilled_patch16_224"
    monkeypatch.setitem(jregistry.MODEL_REGISTRY, name, JViTConfig(**LONG_MODEL))
    monkeypatch.setitem(registry.MODEL_REGISTRY, name, ViTConfig(**LONG_MODEL))
    return name


def test_model_at_448_px_matches_jax(long_model):
    """create_model at img_size=448 (N = 786; the fused block, its plain
    version on the CPU) on the JAX model's weights (interpolation-free: both
    built at 448 px): the class and distillation logits, and the gradient of
    every parameter of a loss on both heads."""
    cfg = JViTConfig(img_size=448, num_classes=10, **LONG_MODEL)
    j = JViT(cfg, dtype=jnp.float32)
    params = j.init({"params": jax.random.PRNGKey(3)}, jnp.zeros((1, 448, 448, 3)))["params"]
    t = factory.create_model(long_model, num_classes=10, img_size=448, dtype=torch.float32,
                             device="cpu")
    assert t.cfg.num_patches + t.cfg.num_prefix_tokens == 786
    t.load_state_dict(flax_to_torch(params))
    rng = np.random.RandomState(3)
    x = rng.randn(1, 448, 448, 3).astype(np.float32)
    c, c_dist = (rng.randn(1, 10).astype(np.float32) for _ in range(2))

    def jloss(p):
        out = j.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.sum(out.logits * c) + jnp.sum(out.logits_dist * c_dist), out

    (_, jo), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    out = t(torch.from_numpy(x), train=True)
    _close(out.logits, jo.logits)
    _close(out.logits_dist, jo.logits_dist)
    loss = (out.logits * torch.from_numpy(c)).sum() + (out.logits_dist
                                                       * torch.from_numpy(c_dist)).sum()
    names, leaves = zip(*t.named_parameters())
    tg = dict(zip(names, torch.autograd.grad(loss, list(leaves))))
    jgrads = flax_to_torch(jg)
    assert set(jgrads) == set(tg)
    for name, g in tg.items():
        _close(g, jgrads[name])


def _config(size, kd="soft", dtype="float32", **extra):
    return TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                       student_model="deit_tiny_distilled_patch16_224", distillation_type=kd,
                       input_size=size, allow_random_teacher=True, dtype=dtype, **extra)


@pytest.mark.parametrize("size,kd", [(448, "soft"), (576, "wasskd")])
def test_factory_builds_long_inputs(size, kd):
    """load_teacher_student at 448 px (soft KD) and at 576 px (WassKD-l1,
    1,296 patch rows) builds both models at that size, the bf16 and fp32
    routes past every kernel's length check."""
    for dtype in ("bfloat16", "float32"):
        factory.check_sequence_lengths(_config(size, kd, dtype), 100, True)
    teacher, student, aux = factory.load_teacher_student(_config(size, kd), device="cpu")
    grid = size // 16
    assert teacher.cfg.img_size == student.cfg.img_size == size
    assert student.cfg.num_patches == grid * grid
    assert student.pos_embed.shape[1] == grid * grid + 2
    assert (aux is not None) == (kd == "wasskd")


@pytest.mark.parametrize("size,kd,dtypes", [
    (1040, "wasskd", ("bfloat16", "float32")),   # 65 x 65 = 4,225 patch rows > 4,096
    (3488, "soft", ("bfloat16",)),               # 218 x 218 + 2 = 47,526 tokens > 47,104
])
def test_factory_refuses_sizes_above_a_kernel_limit(size, kd, dtypes):
    """The sizes past the old kernel limits (the sort's 4,096 rows a column,
    the bf16 attention's 47,104 tokens) are no longer refused: the sort
    kernels take columns up to 2**30 rows (their long route past 4,096) and
    the attention kernels any length, so load_teacher_student builds both
    models at these sizes on the kernel routes, as the JAX package does."""
    grid = size // 16
    for dtype in dtypes:
        teacher, student, aux = factory.load_teacher_student(_config(size, kd, dtype),
                                                             device="cpu")
        assert teacher.cfg.img_size == student.cfg.img_size == size
        assert student.cfg.num_patches == grid * grid
        assert student.pos_embed.shape[1] == grid * grid + 2
        assert (aux is not None) == (kd == "wasskd")
        del teacher, student, aux
    assert tsort.KERNEL_MAX_N == 1 << 30
    assert not hasattr(tat, "KERNEL_MAX_N") and not hasattr(tfb, "KERNEL_BWD_MAX_N")


def test_plain_sorted_l1_matches_jax_at_4225_rows():
    """The plain sorted_l1 and its gradient against the JAX package's
    sorted_l1 at WassKD-l1's 4,225 patch rows of a 1040-px input, the sort
    kernels' long route on the card: tie-free fp32 draws, rtol 1e-5."""
    rng = np.random.RandomState(26)
    s, t = (rng.randn(1, 4225, 8).astype(np.float32) for _ in range(2))
    v, g = jax.value_and_grad(lambda x: jsort.sorted_l1(x, jnp.asarray(t), axis=1))(
        jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_(True)
    loss = tsort.sorted_l1(ts, torch.from_numpy(t), 1)
    (gs,) = torch.autograd.grad(loss, [ts])
    np.testing.assert_allclose(loss.item(), float(v), rtol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(g), rtol=1e-5, atol=1e-12)


def _compare_exchange(keys, half, mirror):
    """One stage of the network on [cols, n_pad] keys: position p (bit
    ``half`` clear) against p | half, or p ^ (2 half - 1), the smaller key
    to p, as sort.cu's long_stage_kernel and group_exchange do."""
    p = np.arange(keys.shape[1])
    p = p[(p & half) == 0]
    o = p ^ (2 * half - 1) if mirror else p | half
    a, b = keys[:, p], keys[:, o]
    keys[:, p], keys[:, o] = np.minimum(a, b), np.maximum(a, b)


@pytest.mark.parametrize("n", [4097, 8192, 16641, 65536])
def test_long_sort_schedule_sorts(n):
    """The long route's passes as the wrapper drives them: runs of 4096
    sorted (np.sort for the in-block network), then long_schedule's stages
    and, at each finish, the strides 2048 .. 1 in each 4096-key chunk, on
    keys with ties and the largest key (a NaN's image, and the padding's)
    among the real ones: the first n positions equal np.sort's; and the
    kernel launches of one call that ``launches_per_call`` counts."""
    rng = np.random.RandomState(n)
    cols, pad = 3, np.iinfo(np.int32).max
    keys = rng.randint(0, 50, size=(cols, n)).astype(np.int64)
    keys[rng.rand(cols, n) < 0.01] = pad
    n_pad = 1 << (n - 1).bit_length()
    work = np.full((cols, n_pad), pad, dtype=np.int64)
    work[:, :n] = keys
    work = np.sort(work.reshape(cols, -1, 4096), axis=2).reshape(cols, n_pad)
    steps = tsort.long_schedule(n)
    for step in steps:
        if step[0] == "stage":
            _compare_exchange(work, step[1], step[2])
        else:
            half = 2048
            while half:
                _compare_exchange(work, half, False)
                half //= 2
    np.testing.assert_array_equal(work[:, :n], np.sort(keys, axis=1))
    phases = (n_pad // 4096).bit_length() - 1
    assert [s[1] for s in steps if s[0] == "finish"] == [False] * (phases - 1) + [True]
    stages = phases * (phases + 1) // 2
    assert sum(s[0] == "stage" for s in steps) == stages
    # the launches of one call: the runs, each stage once a key array, each finish
    assert tsort.launches_per_call(n) == 1 + stages + phases
    assert tsort.launches_per_call(n, 2) == 1 + 2 * stages + phases
    assert tsort.launches_per_call(4096, 2) == 1


@pytest.mark.parametrize("rows", [16, 64])
def test_plain_attention_in_row_chunks_matches_plain(rows):
    """The plain attention forward and backward in query-row chunks (what
    the kernels are held to past N = 47,104 on the card, where one head's
    [N, N] fp32 scores take 8.9 GB) against the unchunked plain versions at
    a ragged N, fp32: the same formulas, summed in another order (dk, dv
    over the chunks): 1e-5 of the largest value."""
    rng = np.random.RandomState(rows)
    q, k = (torch.from_numpy(2.0 * rng.randn(2, 3, 150, 64).astype(np.float32)) for _ in range(2))
    v, do = (torch.from_numpy(rng.randn(2, 3, 150, 64).astype(np.float32)) for _ in range(2))
    o, lse = tat._plain_fwd(q, k, v)
    o_c, lse_c = tat._plain_fwd_rows(q, k, v, rows)
    _close(o_c, o, 1e-5)
    _close(lse_c, lse, 1e-5)
    for a, b in zip(tat._plain_bwd_rows(q, k, v, o, lse, do, rows),
                    tat._plain_bwd(q, k, v, o, lse, do)):
        _close(a, b, 1e-5)
