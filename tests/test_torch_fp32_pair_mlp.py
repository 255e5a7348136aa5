"""The fp32 forms of the fused MLP backward (row 6) and the block pair (rows 7
and 8) on the CPU, against the JAX package.

- The fp32 ``fused_mlp_train`` backward's plain version (the CPU path, and
  the yardstick of the card's ``dk_fused_mlp_bwd_f32``) against the JAX
  package's ``fused_mlp_train`` VJP, whose ``_fused_mlp_bwd_call`` runs the
  Pallas backward kernel in interpret mode (``pl.pallas_call`` given
  ``interpret=True`` for the test), at fp32 with row counts that no 256-row
  tile divides: every gradient to 1e-5 of its largest value.
- The pair's and the MLP's kernel wrappers refuse a mix of dtypes with
  ValueError before a launch (no library is built or loaded here: a check
  that let one through would fail on the missing nvcc instead).
- The slice as a whole: one paired fp32 soft-KD step built by both
  factories (the JAX one with ``DELTAKD_PAIR=1``, ``dtype="float32"`` and
  its Pallas block and pair kernels in interpret mode; the port's with
  ``block_pair=True``, whose pair runs its plain fp32 version on the CPU),
  the same weights, post-transform images, soft targets and drop-path masks
  (the JAX step's bernoulli draws replaced by the pinned masks, handed to the
  port as ``drop_scales``): the loss terms to rtol 1e-4, the student's
  gradients (read from AdamW's first moment) to 1e-4 of each tensor's
  largest value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.data.augment import AugmentConfig as JAugmentConfig
from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.kd.losses import KDSettings as JKDSettings
from deltakd_tpu.models import factory as jfactory
from deltakd_tpu.models import registry as jregistry
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu.ops import fused_mlp as jfm
from deltakd_tpu.ops.attention import flash_attention as j_flash_attention
from deltakd_tpu.train import step as jstep
from deltakd_tpu.train.optim import make_optimizer as j_make_optimizer
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.data.mixup import MixupConfig
from deltakd_tpu_torch.kd.losses import KDSettings
from deltakd_tpu_torch.models import registry
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.factory import load_teacher_student
from deltakd_tpu_torch.models.vit import ViTConfig
from deltakd_tpu_torch.ops import fused_block as fb
from deltakd_tpu_torch.ops import fused_mlp as fm
from deltakd_tpu_torch.ops import kernel_entry
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_train_step
from tests.test_torch_fp32_route import _adam_mu

torch.set_num_threads(1)

MLP_D, MLP_F = 16, 64


def _mlp(M, seed):
    """x and dy [M, MLP_D], the weights (the port's nn.Linear layout) of std
    1/sqrt(fan-in) and biases, fp32, from a numpy seed."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (f32(rng.randn(M, MLP_D)), f32(rng.randn(MLP_F, MLP_D) / np.sqrt(MLP_D)),
            f32(0.1 * rng.randn(MLP_F)), f32(rng.randn(MLP_D, MLP_F) / np.sqrt(MLP_F)),
            f32(0.1 * rng.randn(MLP_D)), f32(rng.randn(M, MLP_D)))


@pytest.mark.parametrize("M", [300, 37])
def test_fp32_mlp_backward_matches_interpreted_jax_kernel(M, monkeypatch):
    """M = 300 and 37: one and two partial 256-row tiles, the padded rows
    zero in x and dy, as the JAX wrapper pads them."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    x, w1, b1, w2, b2, dy = _mlp(M, M)
    ops = (jnp.asarray(x), jnp.asarray(w1.T), jnp.asarray(b1), jnp.asarray(w2.T),
           jnp.asarray(b2))
    _, vjp = jax.vjp(jfm.fused_mlp_train, *ops)
    j_dx, j_dw1, j_db1, j_dw2, j_db2 = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    got = fm._plain_bwd(*map(torch.from_numpy, (x, w1, b1, w2, dy)))
    assert all(t.dtype == torch.float32 for t in got)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                          (j_dx, j_dw1.T, j_db1, j_dw2.T, j_db2)):
        assert a.shape == b.shape, name
        err, scale = float(np.abs(a.numpy() - b).max()), float(np.abs(b).max())
        assert err <= 1e-5 * scale, f"{name}: {err:.3e} of {scale:.3e}"


def test_fp32_fused_mlp_train_takes_the_fp32_backward_on_the_cpu():
    """fused_mlp_train at fp32 on the CPU: the plain backward, gradients of
    the operands' dtypes and no launch; on a card it would take the fp32
    entry points."""
    x, w1, b1, w2, b2, dy = _mlp(21, 5)
    ops = [torch.from_numpy(a).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    fm.reset_launches()
    grads = torch.autograd.grad(fm.fused_mlp_train(*ops), ops, torch.from_numpy(dy))
    want = fm._plain_bwd(*(t.detach() for t in ops[:4]), torch.from_numpy(dy))
    for g, w in zip(grads, want):
        assert g.dtype == torch.float32 and torch.equal(g, w)
    assert not fm.LAUNCHES
    assert kernel_entry("fused_mlp_bwd", ops[0]) == "fused_mlp_bwd_f32"


# -----------------------------------------------------------------------------
# The wrappers refuse a mix of dtypes before a launch
# -----------------------------------------------------------------------------

PD, PH, PN, PB = 64, 1, 10, 2


def _pair_operands(seed=0):
    rng = np.random.RandomState(seed)
    shapes = [(PD,), (PD,), (3 * PD, PD), (3 * PD,), (PD, PD), (PD,), (PD,), (PD,),
              (4 * PD, PD), (4 * PD,), (PD, 4 * PD), (PD,)]
    ws = [[torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1) for s in shapes]
          for _ in range(2)]
    x = torch.from_numpy(rng.randn(PB, PN, PD).astype(np.float32))
    return x, (torch.ones(PB),) * 4, ws


@pytest.mark.parametrize("block", [0, 1])
@pytest.mark.parametrize("weight", [2, 3, 8, 11])
@pytest.mark.parametrize("kernel", ["fused_pair_fwd_cuda", "fused_pair_bwd_cuda"])
def test_pair_refuses_a_dtype_mix_before_a_launch(kernel, weight, block):
    """fp32 x with one bf16 weight or bias of either block."""
    x, scales, ws = _pair_operands()
    ws[block][weight] = ws[block][weight].bfloat16()
    args = ((x, scales, *ws, PH, 1e-6, True, True) if kernel == "fused_pair_fwd_cuda"
            else (x, scales, *ws, x, None, None, PH, 1e-6))
    fb.reset_launches()
    with pytest.raises(ValueError, match="fp32 x takes fp32 weights"):
        getattr(fb, kernel)(*args)
    assert not fb.LAUNCHES


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_pair_refuses_dtypes_without_a_form(dtype):
    x, scales, ws = _pair_operands()
    with pytest.raises(ValueError, match="bf16 or fp32"):
        fb.fused_pair_fwd_cuda(x.to(dtype), scales, *ws, PH, 1e-6, True, True)


@pytest.mark.parametrize("case", ["bf16 w1", "bf16 b1", "bf16 w2", "fp16 x"])
def test_mlp_backward_refuses_a_dtype_mix_before_a_launch(case):
    x, w1, b1, w2, _, dy = map(torch.from_numpy, _mlp(21, 6))
    if case == "bf16 w1":
        w1 = w1.bfloat16()
    elif case == "bf16 b1":
        b1 = b1.bfloat16()
    elif case == "bf16 w2":
        w2 = w2.bfloat16()
    else:
        x, dy = x.half(), dy.half()
    fm.reset_launches()
    with pytest.raises(ValueError, match="fp32 weights|x must be"):
        fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy)
    assert not fm.LAUNCHES


# -----------------------------------------------------------------------------
# The slice: one paired fp32 soft-KD step from both factories
# -----------------------------------------------------------------------------

B, C = 4, 10
RATE = 0.2
TINY = {"fp32_pair_test_student": dict(embed_dim=64, depth=2, num_heads=1),
        "fp32_pair_test_teacher": dict(embed_dim=128, depth=2, num_heads=2)}
HP = dict(teacher_model="fp32_pair_test_teacher", student_model="fp32_pair_test_student",
          distillation_type="soft", alpha=0.5, tau=2.0, drop_path_rate=RATE, lr=1e-3,
          warmup_epochs=0, epochs=10, opt_eps=1e-4, clip_grad=None, weight_decay=0.0,
          ema_decay=0.9, dataset="cifar-10", input_size=32, dtype="float32",
          allow_random_teacher=True)
# block 1's attention and MLP branch masks (block 0's drop-path rate is 0)
MASKS = np.array([[1, 0, 1, 1], [1, 1, 0, 1]], bool)


def test_paired_fp32_train_step_from_both_factories_matches_jax(monkeypatch):
    for name, dims in TINY.items():
        monkeypatch.setitem(jregistry.MODEL_REGISTRY, name,
                            JViTConfig(distilled=True, patch_size=8, **dims))
        monkeypatch.setitem(registry.MODEL_REGISTRY, name,
                            ViTConfig(distilled=True, patch_size=8, **dims))
    monkeypatch.setenv("DELTAKD_FUSED_CP", "0")
    monkeypatch.setenv("DELTAKD_PAIR", "1")
    monkeypatch.delenv("DELTAKD_PAIR_HYBRID", raising=False)
    rng = np.random.RandomState(50)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, C, B)
    targets = rng.dirichlet(np.ones(C), B).astype(np.float32)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    draws = []

    def pinned_bernoulli(key, p, shape):
        assert shape == (B,)
        draws.append(float(p))
        return jnp.asarray(MASKS[len(draws) - 1])

    monkeypatch.setattr(jax.random, "bernoulli", pinned_bernoulli)
    monkeypatch.setattr(jstep, "train_transform", lambda k, x, ac: jnp.asarray(images))
    monkeypatch.setattr(jstep, "apply_mixup", lambda k, x, y, mc: (x, jnp.asarray(targets)))

    jcfg = JTrainConfig(**HP)
    jfb.set_interpret(True)
    try:
        j_teacher, j_student, _ = jfactory.load_teacher_student(
            jcfg, rng=jax.random.PRNGKey(51), attention_fn=j_flash_attention)
        assert j_student.module.block_pair_fn is jfb.fused_vit_block_pair
        assert j_teacher.module.block_pair_fn is None
        jtx = j_make_optimizer(jcfg, {"student": j_student.params, "aux": {}}, 5)
        jstate = JTrainState.create(student_params=j_student.params, aux_params={}, tx=jtx,
                                    ema_decay=jcfg.ema_decay)
        jfn = jstep.build_train_step(
            cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
            student_module=j_student.module, teacher_module=j_teacher.module,
            aug=JAugmentConfig(input_size=32), mixup=JMixupConfig(num_classes=C), tx=jtx,
            donate=False)
        jstate, jm = jfn(jstate, j_teacher.params, jnp.asarray(u8), jnp.asarray(labels),
                         jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32))
        jm = {k: float(v) for k, v in jm.items()}
    finally:
        jfb.set_interpret(False)
    np.testing.assert_allclose(draws, [1 - RATE] * 2, rtol=1e-6)

    cfg = TrainConfig(aa="", color_jitter=0.0, **HP)
    teacher, student, aux = load_teacher_student(cfg, block_pair=True, seed=0, device="cpu")
    assert student.block_pair_fn is fb.fused_vit_block_pair and teacher.block_pair_fn is None
    assert student.dtype == teacher.dtype == torch.float32 and aux is None
    student.load_state_dict(flax_to_torch(j_student.params))
    teacher.load_state_dict(flax_to_torch(j_teacher.params))
    tx = make_optimizer(cfg, trainable_parameters(student), 5)
    state = TrainState(student, tx=tx, ema_decay=cfg.ema_decay)
    fn = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2,
                                                             teacher_prefix=2),
                          student=student, teacher=teacher, aug=AugmentConfig.from_config(cfg),
                          mixup=MixupConfig.from_config(cfg, C), tx=tx)
    scales = [None, tuple(torch.from_numpy(m.astype(np.float32) / (1 - RATE)) for m in MASKS)]
    fb.reset_launches()
    m = fn(state, torch.from_numpy(u8), torch.from_numpy(labels),
           torch.Generator().manual_seed(0), images=torch.from_numpy(images),
           targets=torch.from_numpy(targets), drop_scales=scales)
    assert not fb.LAUNCHES   # the plain fp32 pair on the CPU

    for k in ("train_loss", "base_loss", "distill_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), jm[k], rtol=1e-4, err_msg=k)
    b1 = cfg.opt_betas[0] if cfg.opt_betas else 0.9
    want = flax_to_torch(_adam_mu(jstate.opt_state, {"student": j_student.params,
                                                     "aux": {}})["student"])
    offset = 0
    for name, p in state.named_params:
        got = state.opt_state.mu[offset:offset + p.numel()].view(p.shape) / (1 - b1)
        offset += p.numel()
        ref = want[name.removeprefix("student.")].float() / (1 - b1)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * float(ref.abs().max()) + 1e-12, err_msg=name)
