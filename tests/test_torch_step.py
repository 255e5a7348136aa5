"""One whole soft-KD train step of the port against the JAX package's
``build_train_step``, from the same weights, the same post-transform images
and soft targets (the JAX step's transform and mixup are replaced by
functions returning them) and drop-path rate 0: loss terms, grad norm and
the updated parameters. The same for one wasskd-l1, one mgd, one lrkd and one
diffkd step, with the same aux-head weights and, for mgd and diffkd, the
draws the JAX step makes from its key (masking noise; timesteps, noise and
dropout masks) handed to the port; the updated aux parameters are compared
too.
The same soft-KD step on the unfused path (the student through
``flash_attention``, the frozen teacher through ``flash_attention`` and
``fused_mlp``) with drop-path masks shared by both sides. The same soft-KD
and wasskd-l1 steps with the student on block pairs, against the JAX step
whose student runs the Pallas pair kernels in interpret mode, again with
shared drop-path masks. Then ``build_eval_step``'s masked sums, also through
the eval view with ``fused_mlp`` and the single-block view of a paired
student.

fp32 on the CPU. Losses and grad norm to rtol 1e-4; parameters after the
AdamW step to 1e-6 absolute (lr 1e-3 and eps 1e-4, so grads that differ in
their last bits cannot flip an update's sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.data.augment import AugmentConfig as JAugmentConfig
from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.kd.aux import init_aux_params
from deltakd_tpu.kd.losses import KDSettings as JKDSettings
from deltakd_tpu.models import vit as jvit
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu.ops.attention import reference_attention as j_reference_attention
from deltakd_tpu.ops.fused_mlp import reference_mlp as j_reference_mlp
from deltakd_tpu.train import step as jstep
from deltakd_tpu.train.optim import make_optimizer as j_make_optimizer
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.data.mixup import MixupConfig
from deltakd_tpu_torch.kd.aux import AuxHeads
from deltakd_tpu_torch.kd.losses import KDSettings
from deltakd_tpu_torch.models.convert import aux_flax_to_torch, flax_to_torch
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.ops.attention import flash_attention
from deltakd_tpu_torch.ops.fused_block import fused_vit_block, fused_vit_block_pair
from deltakd_tpu_torch.ops.fused_mlp import fused_mlp
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_eval_step, build_train_step
from tests import jax_draws

torch.set_num_threads(1)

B, C = 4, 10
STUDENT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
               num_classes=C, distilled=True)
TEACHER = dict(STUDENT, embed_dim=96)
HP = dict(distillation_type="soft", alpha=0.5, tau=2.0, drop_path_rate=0.0, lr=1e-3,
          warmup_epochs=0, epochs=10, opt_eps=1e-4, clip_grad=1.0, ema_decay=0.9,
          dataset="cifar-10", input_size=32, dtype="float32")


def _pair(kw, seed):
    j = JViT(JViTConfig(**kw), dtype=jnp.float32)
    params = j.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)))["params"]
    t = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block)
    t.load_state_dict(flax_to_torch(params))
    return j, params, t


def _close(a, b, rtol=1e-4):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol)


def test_train_step_matches_jax(monkeypatch):
    rng = np.random.RandomState(0)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, C, B)
    targets = rng.dirichlet(np.ones(C), B).astype(np.float32)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)

    j_student, s_params, t_student = _pair(STUDENT, 1)
    j_teacher, t_params, t_teacher = _pair(TEACHER, 2)

    # JAX step: the real build_train_step with its transform and mixup
    # returning the pinned batch
    monkeypatch.setattr(jstep, "train_transform", lambda k, x, ac: jnp.asarray(images))
    monkeypatch.setattr(jstep, "apply_mixup",
                        lambda k, x, y, mc: (x, jnp.asarray(targets)))
    jcfg = JTrainConfig(**HP)
    jtx = j_make_optimizer(jcfg, {"student": s_params, "aux": {}}, 5)
    jstate = JTrainState.create(student_params=s_params, aux_params={}, tx=jtx,
                                ema_decay=jcfg.ema_decay)
    jfn = jstep.build_train_step(
        cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
        student_module=j_student, teacher_module=j_teacher,
        aug=JAugmentConfig(input_size=32), mixup=JMixupConfig(num_classes=C), tx=jtx,
        donate=False)
    jstate, jm = jfn(jstate, t_params, jnp.asarray(u8), jnp.asarray(labels),
                     jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32))

    cfg = TrainConfig(aa="", color_jitter=0.0, **HP)
    tx = make_optimizer(cfg, trainable_parameters(t_student), 5)
    state = TrainState(t_student, tx=tx, ema_decay=cfg.ema_decay)
    fn = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg), student=t_student,
                          teacher=t_teacher, aug=AugmentConfig.from_config(cfg),
                          mixup=MixupConfig.from_config(cfg, C), tx=tx)
    m = fn(state, torch.from_numpy(u8), torch.from_numpy(labels),
           torch.Generator().manual_seed(0), images=torch.from_numpy(images),
           targets=torch.from_numpy(targets))

    for k in ("train_loss", "base_loss", "distill_loss", "grad_norm", "train_acc1",
              "train_acc5"):
        _close(m[k], jm[k])
    expect = flax_to_torch(jstate.params["student"])
    for name, p in t_student.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expect[name].numpy(), atol=1e-6,
                                   err_msg=name)
    # the teacher is frozen and unchanged
    for name, p in t_teacher.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), flax_to_torch(t_params)[name].numpy())


@pytest.mark.parametrize("kd_type", ["wasskd", "mgd", "lrkd", "diffkd"])
def test_feature_kd_train_step_matches_jax(kd_type, monkeypatch):
    """The whole slice at 2 layers and narrow widths: teacher and student
    features through the fused block's plain version, the aux heads, the
    objective, and the AdamW update of student and aux parameters. LRKD at
    rank 8 of the teacher's 96 columns (its batched eigh on 64 token rows);
    DiffKD with the draws of the JAX step's loss key pinned."""
    rng = np.random.RandomState(10)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, C, B)
    targets = rng.dirichlet(np.ones(C), B).astype(np.float32)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    hp = dict(HP, distillation_type=kd_type, mgd_alpha=0.5, lrkd_rank=8)

    kw_s = dict(STUDENT, depth=3) if kd_type == "wasskd" else STUDENT
    kw_t = dict(TEACHER, depth=3) if kd_type == "wasskd" else TEACHER
    j_student, s_params, t_student = _pair(kw_s, 11)
    j_teacher, t_params, t_teacher = _pair(kw_t, 12)
    aux_tree = init_aux_params(jax.random.PRNGKey(13), kd_type, STUDENT["embed_dim"],
                               TEACHER["embed_dim"], lrkd_rank=8)
    if "mask_token" in aux_tree:
        aux_tree["mask_token"] = aux_tree["mask_token"] + 0.1

    monkeypatch.setattr(jstep, "train_transform", lambda k, x, ac: jnp.asarray(images))
    monkeypatch.setattr(jstep, "apply_mixup",
                        lambda k, x, y, mc: (x, jnp.asarray(targets)))
    jcfg = JTrainConfig(**hp)
    jtx = j_make_optimizer(jcfg, {"student": s_params, "aux": aux_tree}, 5)
    jstate = JTrainState.create(student_params=s_params, aux_params=aux_tree, tx=jtx,
                                ema_decay=jcfg.ema_decay)
    jfn = jstep.build_train_step(
        cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
        student_module=j_student, teacher_module=j_teacher,
        aug=JAugmentConfig(input_size=32), mixup=JMixupConfig(num_classes=C), tx=jtx,
        donate=False)
    key = jax.random.PRNGKey(0)
    jstate, jm = jfn(jstate, t_params, jnp.asarray(u8), jnp.asarray(labels), key,
                     jnp.asarray(0, jnp.int32))
    # the masking noise of the JAX step: its loss key is the third of five
    # split off the step key folded with the step count
    k_loss = jax.random.split(jax.random.fold_in(key, 0), 5)[2]
    n_patches = (32 // 8) ** 2
    noise = torch.from_numpy(np.array(jax.random.uniform(k_loss, (B, n_patches))))

    cfg = TrainConfig(aa="", color_jitter=0.0, **hp)
    aux = AuxHeads(kd_type, STUDENT["embed_dim"], TEACHER["embed_dim"],
                   torch.Generator().manual_seed(0), lrkd_rank=8)
    aux.load_state_dict(aux_flax_to_torch(aux_tree))
    feats = {"wasskd": {0, 1, 2}, "mgd": {1}, "lrkd": {0, 1}, "diffkd": {0, 1}}[kd_type]
    t_student.collect_features = t_teacher.collect_features = feats
    tx = make_optimizer(cfg, trainable_parameters(t_student, aux), 5)
    state = TrainState(t_student, tx=tx, aux=aux, ema_decay=cfg.ema_decay)
    fn = build_train_step(
        cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2, teacher_prefix=2),
        student=t_student, teacher=t_teacher, aux=aux, aug=AugmentConfig.from_config(cfg),
        mixup=MixupConfig.from_config(cfg, C), tx=tx)
    m = fn(state, torch.from_numpy(u8), torch.from_numpy(labels),
           torch.Generator().manual_seed(0), images=torch.from_numpy(images),
           targets=torch.from_numpy(targets),
           mask_noise=noise if kd_type == "mgd" else None,
           diffkd_draws=(jax_draws.diffkd_draws(k_loss, (B, n_patches, TEACHER["embed_dim"]))
                         if kd_type == "diffkd" else None))

    assert float(m["distill_loss"]) > 0
    for k in ("train_loss", "base_loss", "distill_loss", "grad_norm", "train_acc1",
              "train_acc5"):
        _close(m[k], jm[k])
    expect = flax_to_torch(jstate.params["student"])
    for name, p in t_student.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expect[name].numpy(), atol=1e-6,
                                   err_msg=name)
    before = aux_flax_to_torch(aux_tree)
    expect = aux_flax_to_torch(jstate.params["aux"])
    assert set(expect) == set(aux.state_dict())
    for name, p in aux.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expect[name].numpy(), atol=1e-6,
                                   err_msg=name)
        assert not np.array_equal(p.numpy(), before[name].numpy()), name


def test_unfused_train_step_matches_jax(monkeypatch):
    """The slice as a whole at 2 layers and narrow widths: one soft-KD step on
    the unfused path with stochastic depth. The JAX student runs
    reference_attention, its teacher reference_attention and reference_mlp;
    the port runs flash_attention / fused_mlp (their plain versions here).
    Both sides drop the same samples: the JAX model's drop_path is replaced by
    one that reads the pinned masks in call order (block 0 has rate 0, so
    block 1's attention branch, then its MLP branch)."""
    rng = np.random.RandomState(20)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, C, B)
    targets = rng.dirichlet(np.ones(C), B).astype(np.float32)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    keep = 0.9
    masks = np.array([[1, 0, 1, 1], [1, 1, 0, 1]], np.float32)   # attention, MLP
    hp = dict(HP, drop_path_rate=1 - keep)
    kw_s = dict(STUDENT, drop_path_rate=1 - keep)

    def build(kw, seed, **fns):
        j = JViT(JViTConfig(**kw), dtype=jnp.float32, **fns["jax"])
        params = j.init({"params": jax.random.PRNGKey(seed)},
                        jnp.zeros((1, 32, 32, 3)))["params"]
        t = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, **fns["torch"])
        t.load_state_dict(flax_to_torch(params))
        return j, params, t

    j_student, s_params, t_student = build(
        kw_s, 21, jax=dict(attention_fn=j_reference_attention),
        torch=dict(attention_fn=flash_attention))
    j_teacher, t_params, t_teacher = build(
        TEACHER, 22, jax=dict(attention_fn=j_reference_attention, mlp_fn=j_reference_mlp),
        torch=dict(attention_fn=flash_attention, mlp_fn=fused_mlp))
    assert t_student.block_fn is None and t_teacher.block_fn is None

    calls = []

    def pinned_drop_path(x, rate, rng, deterministic):
        assert not deterministic and abs(rate - (1 - keep)) < 1e-6
        mask = jnp.asarray(masks[len(calls) % 2]).reshape(-1, 1, 1)
        calls.append(rate)
        return x * mask / keep

    monkeypatch.setattr(jvit, "drop_path", pinned_drop_path)
    monkeypatch.setattr(jstep, "train_transform", lambda k, x, ac: jnp.asarray(images))
    monkeypatch.setattr(jstep, "apply_mixup",
                        lambda k, x, y, mc: (x, jnp.asarray(targets)))
    jcfg = JTrainConfig(**hp)
    jtx = j_make_optimizer(jcfg, {"student": s_params, "aux": {}}, 5)
    jstate = JTrainState.create(student_params=s_params, aux_params={}, tx=jtx,
                                ema_decay=jcfg.ema_decay)
    jfn = jstep.build_train_step(
        cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
        student_module=j_student, teacher_module=j_teacher,
        aug=JAugmentConfig(input_size=32), mixup=JMixupConfig(num_classes=C), tx=jtx,
        donate=False)
    jstate, jm = jfn(jstate, t_params, jnp.asarray(u8), jnp.asarray(labels),
                     jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32))
    assert calls and len(calls) % 2 == 0

    cfg = TrainConfig(aa="", color_jitter=0.0, **hp)
    tx = make_optimizer(cfg, trainable_parameters(t_student), 5)
    state = TrainState(t_student, tx=tx, ema_decay=cfg.ema_decay)
    fn = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2,
                                                            teacher_prefix=2),
                          student=t_student, teacher=t_teacher,
                          aug=AugmentConfig.from_config(cfg),
                          mixup=MixupConfig.from_config(cfg, C), tx=tx)
    scales = [None, tuple(torch.from_numpy(m / keep) for m in masks)]
    m = fn(state, torch.from_numpy(u8), torch.from_numpy(labels),
           torch.Generator().manual_seed(0), images=torch.from_numpy(images),
           targets=torch.from_numpy(targets), drop_scales=scales)

    for k in ("train_loss", "base_loss", "distill_loss", "grad_norm", "train_acc1",
              "train_acc5"):
        _close(m[k], jm[k])
    expect = flax_to_torch(jstate.params["student"])
    before = flax_to_torch(s_params)
    for name, p in t_student.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expect[name].numpy(), atol=1e-6,
                                   err_msg=name)
    assert not np.array_equal(t_student.blocks[1].attn.qkv.weight.detach().numpy(),
                              before["blocks.1.attn.qkv.weight"].numpy())


@pytest.mark.parametrize("kd_type", ["soft", "wasskd"])
def test_paired_train_step_matches_jax(kd_type, monkeypatch):
    """The slice as a whole at 3 layers and narrow widths: one train step with
    the student on block pairs (blocks 0-1 one pair call, block 2 the odd
    single block) and stochastic depth. The JAX student module has
    block_fn and block_pair_fn and runs the Pallas kernels in interpret mode;
    its bernoulli draws for the drop-path scales are replaced by the pinned
    masks in call order (block 0 has rate 0; then block 1's attention and MLP
    branch, then block 2's), which the port receives as drop_scales. wasskd
    reads the student features of blocks 0-2: the pair's (True, True)."""
    monkeypatch.setenv("DELTAKD_FUSED_CP", "0")
    monkeypatch.delenv("DELTAKD_PAIR_HYBRID", raising=False)
    rng = np.random.RandomState(30)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, C, B)
    targets = rng.dirichlet(np.ones(C), B).astype(np.float32)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    rate = 0.2
    masks = np.array([[1, 0, 1, 1], [1, 1, 0, 1], [0, 1, 1, 1], [1, 1, 1, 0]], bool)
    hp = dict(HP, distillation_type=kd_type, drop_path_rate=rate)
    kw_s = dict(STUDENT, depth=3, drop_path_rate=rate)
    kw_t = dict(TEACHER, depth=3)

    j_student = JViT(JViTConfig(**kw_s), dtype=jnp.float32, block_fn=jfb.fused_vit_block,
                     block_pair_fn=jfb.fused_vit_block_pair)
    j_teacher, t_params, t_teacher = _pair(kw_t, 32)
    aux_tree = (init_aux_params(jax.random.PRNGKey(33), kd_type, STUDENT["embed_dim"],
                                TEACHER["embed_dim"]) if kd_type == "wasskd" else {})
    draws = []

    def pinned_bernoulli(key, p, shape):
        assert shape == (B,)
        draws.append(float(p))
        return jnp.asarray(masks[len(draws) - 1])

    monkeypatch.setattr(jax.random, "bernoulli", pinned_bernoulli)
    monkeypatch.setattr(jstep, "train_transform", lambda k, x, ac: jnp.asarray(images))
    monkeypatch.setattr(jstep, "apply_mixup",
                        lambda k, x, y, mc: (x, jnp.asarray(targets)))
    jcfg = JTrainConfig(**hp)
    jfb.set_interpret(True)
    try:
        s_params = j_student.init({"params": jax.random.PRNGKey(31)},
                                  jnp.zeros((1, 32, 32, 3)))["params"]
        jtx = j_make_optimizer(jcfg, {"student": s_params, "aux": aux_tree}, 5)
        jstate = JTrainState.create(student_params=s_params, aux_params=aux_tree, tx=jtx,
                                    ema_decay=jcfg.ema_decay)
        jfn = jstep.build_train_step(
            cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
            student_module=j_student, teacher_module=j_teacher,
            aug=JAugmentConfig(input_size=32), mixup=JMixupConfig(num_classes=C), tx=jtx,
            donate=False)
        jstate, jm = jfn(jstate, t_params, jnp.asarray(u8), jnp.asarray(labels),
                         jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32))
        jm = {k: float(v) for k, v in jm.items()}
    finally:
        jfb.set_interpret(False)
    np.testing.assert_allclose(draws, [1 - rate / 2] * 2 + [1 - rate] * 2, rtol=1e-6)

    calls = []

    def counting_pair(*args, **kwargs):
        calls.append((kwargs["need_features1"], kwargs["need_features2"]))
        return fused_vit_block_pair(*args, **kwargs)

    t_student = VisionTransformer(ViTConfig(**kw_s), dtype=torch.float32,
                                  block_fn=fused_vit_block, block_pair_fn=counting_pair)
    t_student.load_state_dict(flax_to_torch(s_params))
    cfg = TrainConfig(aa="", color_jitter=0.0, **hp)
    aux = None
    if kd_type == "wasskd":
        aux = AuxHeads(kd_type, STUDENT["embed_dim"], TEACHER["embed_dim"],
                       torch.Generator().manual_seed(0))
        aux.load_state_dict(aux_flax_to_torch(aux_tree))
        t_student.collect_features = t_teacher.collect_features = {0, 1, 2}
    else:
        t_student.collect_features = False
    tx = make_optimizer(cfg, trainable_parameters(t_student, aux), 5)
    state = TrainState(t_student, tx=tx, aux=aux, ema_decay=cfg.ema_decay)
    fn = build_train_step(
        cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2, teacher_prefix=2),
        student=t_student, teacher=t_teacher, aux=aux, aug=AugmentConfig.from_config(cfg),
        mixup=MixupConfig.from_config(cfg, C), tx=tx)
    keeps = (1 - rate / 2, 1 - rate)
    scales = [None] + [tuple(torch.from_numpy(m.astype(np.float32) / keep) for m in pair)
                       for keep, pair in zip(keeps, (masks[:2], masks[2:]))]
    m = fn(state, torch.from_numpy(u8), torch.from_numpy(labels),
           torch.Generator().manual_seed(0), images=torch.from_numpy(images),
           targets=torch.from_numpy(targets), drop_scales=scales)

    assert calls == [(True, True) if kd_type == "wasskd" else (False, False)]
    for k in ("train_loss", "base_loss", "distill_loss", "grad_norm", "train_acc1",
              "train_acc5"):
        _close(m[k], jm[k])
    expect = flax_to_torch(jstate.params["student"])
    before = flax_to_torch(s_params)
    for name, p in t_student.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expect[name].numpy(), atol=1e-6,
                                   err_msg=name)
    for name in ("blocks.0.attn.qkv.weight", "blocks.1.mlp.fc2.weight", "blocks.2.norm1.bias"):
        assert not np.array_equal(t_student.state_dict()[name].numpy(), before[name].numpy())
    if aux is not None:
        expect = aux_flax_to_torch(jstate.params["aux"])
        for name, p in aux.state_dict().items():
            np.testing.assert_allclose(p.numpy(), expect[name].numpy(), atol=1e-6,
                                       err_msg=name)


def test_feature_kd_step_needs_aux_heads():
    _, _, student = _pair(STUDENT, 1)
    _, _, teacher = _pair(TEACHER, 2)
    cfg = TrainConfig(aa="", color_jitter=0.0, **dict(HP, distillation_type="mgd"))
    tx = make_optimizer(cfg, trainable_parameters(student), 5)
    with pytest.raises(ValueError):
        build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg), student=student,
                         teacher=teacher, aug=AugmentConfig.from_config(cfg),
                         mixup=None, tx=tx)


def test_eval_step_on_the_single_block_view_of_a_paired_student():
    """The eval model of a paired student is its single-block view; at fp32 on
    the CPU it gives the paired model's sums and the JAX eval step's."""
    rng = np.random.RandomState(2)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, C, B)
    j_student, s_params, t_student = _pair(STUDENT, 6)

    def no_pair(*args, **kwargs):
        raise AssertionError("the eval view ran a block pair")

    t_student.block_pair_fn = fused_vit_block_pair
    view = t_student.view(block_pair_fn=None, collect_features=False)
    args = (torch.from_numpy(u8), torch.from_numpy(labels), torch.as_tensor(3))
    jsums = jstep.build_eval_step(student_module=j_student, aug=JAugmentConfig(input_size=32))(
        s_params, jnp.asarray(u8), jnp.asarray(labels), jnp.asarray(3))
    paired_sums = build_eval_step(student=t_student, aug=AugmentConfig(input_size=32))(*args)
    t_student.block_pair_fn = no_pair
    view_sums = build_eval_step(student=view, aug=AugmentConfig(input_size=32))(*args)
    for k in jsums:
        _close(view_sums[k], jsums[k])
        _close(paired_sums[k], jsums[k])


@pytest.mark.parametrize("unfused", [False, True])
@pytest.mark.parametrize("valid", [3, np.array([1, 0, 1, 1], bool)])
def test_eval_step_matches_jax(valid, unfused):
    rng = np.random.RandomState(1)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, C, B)
    j_student, s_params, t_student = _pair(STUDENT, 3)
    t_student.collect_features = True     # the eval step turns collection off
    if unfused:     # the eval view of an unfused student: fused_mlp, shared parameters
        t_student = t_student.view(block_fn=None, attention_fn=flash_attention,
                                   mlp_fn=fused_mlp, collect_features=False)
    jsums = jstep.build_eval_step(student_module=j_student, aug=JAugmentConfig(input_size=32))(
        s_params, jnp.asarray(u8), jnp.asarray(labels), jnp.asarray(valid))
    tsums = build_eval_step(student=t_student, aug=AugmentConfig(input_size=32))(
        torch.from_numpy(u8), torch.from_numpy(labels), torch.as_tensor(valid))
    assert set(tsums) == set(jsums)
    for k in jsums:
        _close(tsums[k], jsums[k])


def test_train_step_draws_its_own_augmentation_and_accumulates():
    """Unpinned, with drop-path, mixup, erasing and two micro-batches: the
    step runs from the generator alone, changes the student only and is
    reproducible from the seed."""
    def run(seed):
        _, _, student = _pair(dict(STUDENT, drop_path_rate=0.1), 4)
        _, _, teacher = _pair(TEACHER, 5)
        cfg = TrainConfig(aa="", color_jitter=0.0, **dict(HP, drop_path_rate=0.1,
                                                          grad_accum_steps=2))
        tx = make_optimizer(cfg, trainable_parameters(student), 5)
        state = TrainState(student, tx=tx)
        fn = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg), student=student,
                              teacher=teacher, aug=AugmentConfig.from_config(cfg),
                              mixup=MixupConfig.from_config(cfg, C), tx=tx)
        rng = np.random.RandomState(6)
        u8 = torch.from_numpy(rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8))
        labels = torch.from_numpy(rng.randint(0, C, B))
        p0 = state.params.clone()
        m = fn(state, u8, labels, torch.Generator().manual_seed(seed))
        assert all(torch.isfinite(v) for v in m.values())
        assert state.step == 1 and not torch.equal(p0, state.params)
        return float(m["train_loss"])

    assert run(0) == run(0) != run(1)
