"""The fp32 route of the port on the CPU: what the kernel wrappers take at
fp32, and one fp32 soft-KD train step built by both packages' factories.

- `_kernel_operands` (the fused block's wrappers), the attention wrappers'
  and the fused MLP's operand checks take fp32 x with fp32 weights and keep
  them fp32, and refuse a mix of dtypes, or a dtype the kernels have no form
  for, with ValueError before any launch (here no library is built or
  loaded: a check that let them through would fail on the missing nvcc
  instead).
- The slice as a whole: an fp32 TrainConfig through the JAX factory (with
  `attention_fn` given and the Pallas kernels in interpret mode, so that its
  student and teacher get the Pallas fused block as on a TPU) and through
  the port's (whose fused block runs its plain fp32 version on the CPU), the
  same weights, the same post-transform images and soft targets, on the
  fused route and on the unfused one (a model axis of 2: the JAX side with
  `attention_fn=reference_attention`, the math its Pallas attention and MLP
  kernels compute, which its factory does not pick on the CPU; the port's
  flash_attention and, for the teacher, fused_mlp on their plain fp32
  versions): one train step's loss terms at rtol 1e-4 and the student's gradients, read from
  AdamW's first moment (mu / (1 - b1)), to 1e-4 of each tensor's largest
  value (fp32 sums in another order on the two sides). The models are two
  registered test configurations of 2 blocks at widths 64 and 128 (one head
  of 64 each), added to both registries for the test.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.data.augment import AugmentConfig as JAugmentConfig
from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.kd.losses import KDSettings as JKDSettings
from deltakd_tpu.models import factory as jfactory
from deltakd_tpu.models import registry as jregistry
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu.ops.attention import flash_attention as j_flash_attention
from deltakd_tpu.ops.attention import reference_attention as j_reference_attention
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
from deltakd_tpu_torch.ops import attention as at
from deltakd_tpu_torch.ops import fused_block as fb
from deltakd_tpu_torch.ops import fused_mlp as fm
from deltakd_tpu_torch.ops import kernel_entry
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_train_step

torch.set_num_threads(1)

D, H, N_TOK, BATCH = 128, 2, 18, 2


def _block(dtype, matmul_dtype=None, seed=0):
    """x [BATCH, N_TOK, D] and a block's 12 weights from a numpy seed: x and
    the LayerNorm parameters and biases in ``dtype``, the matmul weights in
    ``matmul_dtype`` (default ``dtype``)."""
    rng = np.random.RandomState(seed)
    shapes = [(D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,), (4 * D, D),
              (4 * D,), (D, 4 * D), (D,)]
    w = [torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1).to(
        (matmul_dtype or dtype) if len(s) == 2 else dtype) for s in shapes]
    x = torch.from_numpy(rng.randn(BATCH, N_TOK, D).astype(np.float32)).to(dtype)
    ones = torch.ones(BATCH)
    return x, ones, ones, w


def test_kernel_operands_keep_fp32():
    x, sa, sm, w = _block(torch.float32)
    x2, sa2, sm2, ws = fb._kernel_operands(x, sa, sm, w, H, "fused_block_fwd")
    assert x2.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in ws)
    for t, given in zip(ws, w):
        assert torch.equal(t, given)   # kept, not rounded
    assert kernel_entry("fused_block_fwd", x2) == "fused_block_fwd_f32"


def test_kernel_operands_round_bf16_weights_as_before():
    x, sa, sm, w = _block(torch.float32)
    _, _, _, ws = fb._kernel_operands(x.bfloat16(), sa, sm, w, H, "fused_block_fwd")
    assert [t.dtype for t in ws] == [torch.bfloat16 if i in fb._MATMUL_WEIGHTS
                                     else torch.float32 for i in range(12)]
    assert kernel_entry("fused_block_fwd", x.bfloat16()) == "fused_block_fwd"


@pytest.mark.parametrize("kernel", [fb.fused_block_fwd_cuda, fb.fused_block_bwd_cuda,
                                    fb._kernel_operands])
@pytest.mark.parametrize("case", ["fp32 x, bf16 matmul weights", "fp32 x, bf16 bias",
                                  "fp16 x", "fp64 x"])
def test_fused_block_refuses_other_dtypes_before_a_launch(kernel, case):
    x, sa, sm, w = _block(torch.float32)
    if case == "fp32 x, bf16 matmul weights":
        w[8] = w[8].bfloat16()
    elif case == "fp32 x, bf16 bias":
        w[3] = w[3].bfloat16()
    else:
        x = x.to(torch.float16 if case == "fp16 x" else torch.float64)
    args = {fb.fused_block_fwd_cuda: (x, sa, sm, w, H, 1e-6, True),
            fb.fused_block_bwd_cuda: (x, sa, sm, w, x, None, H, 1e-6),
            fb._kernel_operands: (x, sa, sm, w, H, "fused_block_fwd")}[kernel]
    with pytest.raises(ValueError, match="fp32 weights|bf16 or fp32"):
        kernel(*args)


def test_pair_kernels_refuse_fp32():
    """The name is from before the pair's fp32 form: fp32 x with fp32 weights
    passes the pair's dtype checks (at one head of 128 the head dim is then
    what refuses it), and fp32 x with a bf16 weight of either block is
    refused before a launch."""
    x, sa, sm, w = _block(torch.float32)
    scales = (sa, sm, sa, sm)
    x2, _, ws1, ws2 = fb._pair_operands(x, scales, w, w, D // 64, "fused_pair_fwd")
    assert x2.dtype == torch.float32 and all(t.dtype == torch.float32 for t in ws1 + ws2)
    assert kernel_entry("fused_pair_fwd", x2) == "fused_pair_fwd_f32"
    with pytest.raises(ValueError, match="head dim 128"):
        fb.fused_pair_fwd_cuda(x, scales, w, w, 1, 1e-6, True, True)
    mixed = list(w)
    mixed[10] = mixed[10].bfloat16()
    for w1, w2 in ((mixed, w), (w, mixed)):
        with pytest.raises(ValueError, match="fp32 x takes fp32 weights"):
            fb.fused_pair_fwd_cuda(x, scales, w1, w2, D // 64, 1e-6, True, True)
    assert not fb.LAUNCHES


def _qkv(dtypes):
    rng = np.random.RandomState(1)
    return [torch.from_numpy(rng.randn(BATCH, H, N_TOK, 64).astype(np.float32)).to(d)
            for d in dtypes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_operands_take_fp32_and_bf16(dtype):
    """All of one dtype passes the dtype check: on CPU tensors the check that
    follows it, the device's, is the one that raises."""
    with pytest.raises(ValueError, match="takes CUDA bf16 or fp32 tensors"):
        at._operands("flash_fwd", *_qkv([dtype] * 3))
    assert kernel_entry("flash_fwd", _qkv([dtype])[0]) == (
        "flash_fwd_f32" if dtype == torch.float32 else "flash_fwd")


@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32,
                                                     torch.float32),
    (torch.float16,) * 3, (torch.float64,) * 3])
def test_attention_refuses_mixed_and_other_dtypes_before_a_launch(dtypes):
    q, k, v = _qkv(dtypes)
    for fn, args in ((at.kernel_flash_fwd, (q, k, v)),
                     (at.kernel_flash_bwd, (q, k, v, q, torch.zeros(BATCH, H, N_TOK), v))):
        with pytest.raises(ValueError, match="all bf16 or all fp32"):
            fn(*args)


def _mlp(dtype, seed=2, width=192):
    """x [37, width] and the MLP's weights and biases (nn.Linear layout,
    hidden 4 width; a width the bf16 kernel takes) in ``dtype``, from a numpy
    seed."""
    rng = np.random.RandomState(seed)
    W = width
    arrays = [rng.randn(37, W), rng.randn(4 * W, W) / np.sqrt(W), 0.1 * rng.randn(4 * W),
              rng.randn(W, 4 * W) / np.sqrt(4 * W), 0.1 * rng.randn(W)]
    return [torch.from_numpy(a.astype(np.float32)).to(dtype) for a in arrays]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_operands_take_fp32_and_bf16(dtype):
    """fp32 x with fp32 weights, or bf16 x, passes the dtype checks: on CPU
    tensors the check that follows them, the device's, is the one that
    raises. fp32 takes the forward's fp32 form."""
    ops = _mlp(dtype)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fm._operands("fused_mlp", *ops)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fm.kernel_fused_mlp(*ops)
    assert kernel_entry("fused_mlp_fwd", ops[0]) == (
        "fused_mlp_fwd_f32" if dtype == torch.float32 else "fused_mlp_fwd")


@pytest.mark.parametrize("case", ["fp32 x, bf16 w1", "fp32 x, bf16 b2", "fp16 x", "fp64 x"])
def test_fused_mlp_refuses_mixed_and_other_dtypes_before_a_launch(case):
    x, w1, b1, w2, b2 = _mlp(torch.float32)
    if case == "fp32 x, bf16 w1":
        w1 = w1.bfloat16()
    elif case == "fp32 x, bf16 b2":
        b2 = b2.bfloat16()
    else:
        x = x.to(torch.float16 if case == "fp16 x" else torch.float64)
    with pytest.raises(ValueError, match="fp32 weights|x must be"):
        fm.kernel_fused_mlp(x, w1, b1, w2, b2)


def test_fused_mlp_backward_refuses_fp32():
    """The name is from before the backward's fp32 form: fp32 x with fp32
    weights passes its dtype checks (on CPU tensors the device's check is the
    one that raises); a mix of dtypes is refused before a launch."""
    x, w1, b1, w2, _ = _mlp(torch.float32)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        fm.kernel_fused_mlp_bwd(x, w1, b1, w2, x)
    assert kernel_entry("fused_mlp_bwd", x) == "fused_mlp_bwd_f32"
    for bad in ({"w1": w1.bfloat16()}, {"b1": b1.bfloat16()}, {"w2": w2.bfloat16()}):
        ops = dict(dict(w1=w1, b1=b1, w2=w2), **bad)
        with pytest.raises(ValueError, match="fp32 weights"):
            fm.kernel_fused_mlp_bwd(x, ops["w1"], ops["b1"], ops["w2"], x)


# -----------------------------------------------------------------------------
# The slice: one fp32 soft-KD step from both factories
# -----------------------------------------------------------------------------

B, C = 4, 10
TINY = {"fp32_route_test_student": dict(embed_dim=64, depth=2, num_heads=1),
        "fp32_route_test_teacher": dict(embed_dim=128, depth=2, num_heads=2)}
HP = dict(teacher_model="fp32_route_test_teacher", student_model="fp32_route_test_student",
          distillation_type="soft", alpha=0.5, tau=2.0, drop_path_rate=0.0, lr=1e-3,
          warmup_epochs=0, epochs=10, opt_eps=1e-4, clip_grad=None, weight_decay=0.0,
          ema_decay=0.9, dataset="cifar-10", input_size=32, dtype="float32",
          allow_random_teacher=True)


def _adam_mu(opt_state, params):
    """The first moment of the JAX step's AdamW state as a tree like
    ``params``: one flat vector over the raveled {"student", "aux"}
    parameters, or (with a model axis, where the state keeps the tree for
    its sharding) that tree itself."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
        if hasattr(s, "mu")]
    assert len(found) == 1
    mu = found[0].mu
    return mu if isinstance(mu, dict) else jax.flatten_util.ravel_pytree(params)[1](mu)


@pytest.mark.parametrize("mesh_shape", [None, (1, 2)])
def test_fp32_train_step_from_both_factories_matches_jax(mesh_shape, monkeypatch):
    for name, dims in TINY.items():
        monkeypatch.setitem(jregistry.MODEL_REGISTRY, name,
                            JViTConfig(distilled=True, patch_size=8, **dims))
        monkeypatch.setitem(registry.MODEL_REGISTRY, name,
                            ViTConfig(distilled=True, patch_size=8, **dims))
    monkeypatch.setenv("DELTAKD_FUSED_CP", "0")
    monkeypatch.delenv("DELTAKD_PAIR", raising=False)
    rng = np.random.RandomState(40)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, C, B)
    targets = rng.dirichlet(np.ones(C), B).astype(np.float32)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    monkeypatch.setattr(jstep, "train_transform", lambda k, x, ac: jnp.asarray(images))
    monkeypatch.setattr(jstep, "apply_mixup", lambda k, x, y, mc: (x, jnp.asarray(targets)))

    unfused = mesh_shape is not None
    jcfg = JTrainConfig(**HP, mesh_shape=mesh_shape)
    jfb.set_interpret(True)
    try:
        j_teacher, j_student, _ = jfactory.load_teacher_student(
            jcfg, rng=jax.random.PRNGKey(41),
            attention_fn=j_reference_attention if unfused else j_flash_attention)
        assert j_student.module.block_fn is j_teacher.module.block_fn is (
            None if unfused else jfb.fused_vit_block)
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

    cfg = TrainConfig(aa="", color_jitter=0.0, mesh_shape=mesh_shape, **HP)
    teacher, student, aux = load_teacher_student(cfg, seed=0, device="cpu")
    assert student.block_fn is teacher.block_fn is (None if unfused else fb.fused_vit_block)
    assert teacher.mlp_fn is fm.fused_mlp and student.mlp_fn is None
    assert student.dtype == teacher.dtype == torch.float32 and aux is None
    student.load_state_dict(flax_to_torch(j_student.params))
    teacher.load_state_dict(flax_to_torch(j_teacher.params))
    tx = make_optimizer(cfg, trainable_parameters(student), 5)
    state = TrainState(student, tx=tx, ema_decay=cfg.ema_decay)
    fn = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2,
                                                             teacher_prefix=2),
                          student=student, teacher=teacher, aug=AugmentConfig.from_config(cfg),
                          mixup=MixupConfig.from_config(cfg, C), tx=tx)
    for mod in (fb, at, fm):
        mod.reset_launches()
    m = fn(state, torch.from_numpy(u8), torch.from_numpy(labels),
           torch.Generator().manual_seed(0), images=torch.from_numpy(images),
           targets=torch.from_numpy(targets))
    assert not (fb.LAUNCHES or at.LAUNCHES or fm.LAUNCHES)   # the plain versions on the CPU

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
