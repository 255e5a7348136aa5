"""Token dropout (``ViTConfig.drop_rate``, flax ``nn.Dropout`` after the
position embedding) in the port against the JAX package: one soft-KD train
step of a student with drop_rate 0.1 on the fused block path, the keep mask
pinned on both sides (the JAX model's ``nn.Dropout`` replaced for the test by
one that applies the pinned mask, the port given it as ``token_keep``), from
the same weights, post-transform images and soft targets: loss terms and
grad norm to rtol 1e-4, parameters after the AdamW step to 1e-6. The mask
drawn from the step's generator when none is pinned (a kept share near 1 - p,
kept values x / (1 - p)); eval, the eval view and the teacher never drop.
fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.data.augment import AugmentConfig as JAugmentConfig
from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.kd.losses import KDSettings as JKDSettings
from deltakd_tpu.models import vit as jvit
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.train import step as jstep
from deltakd_tpu.train.optim import make_optimizer as j_make_optimizer
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.data.mixup import MixupConfig
from deltakd_tpu_torch.kd.losses import KDSettings
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.ops.fused_block import fused_vit_block
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_train_step

torch.set_num_threads(1)

B, C, P = 4, 10, 0.1
STUDENT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
               num_classes=C, distilled=True, drop_rate=P)
TEACHER = dict(STUDENT, embed_dim=96, drop_rate=0.0)
N = (32 // 8) ** 2 + 2
HP = dict(distillation_type="soft", alpha=0.5, tau=2.0, drop_path_rate=0.0, lr=1e-3,
          warmup_epochs=0, epochs=10, opt_eps=1e-4, clip_grad=1.0, ema_decay=0.9,
          dataset="cifar-10", input_size=32, dtype="float32")


def _models(kw, seed):
    j = JViT(JViTConfig(**kw), dtype=jnp.float32)
    params = j.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)))["params"]
    t = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block)
    t.load_state_dict(flax_to_torch(params))
    return j, params, t


def test_train_step_with_token_dropout_matches_jax(monkeypatch):
    rng = np.random.RandomState(60)
    images = rng.randn(B, 32, 32, 3).astype(np.float32)
    labels = rng.randint(0, C, B)
    targets = rng.dirichlet(np.ones(C), B).astype(np.float32)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    keep = rng.rand(B, N, STUDENT["embed_dim"]) >= P
    calls = []

    class PinnedDropout:
        """flax nn.Dropout's contract with the pinned keep mask."""

        def __init__(self, rate):
            self.rate = rate

        def __call__(self, x, deterministic):
            calls.append(deterministic)
            if deterministic:
                return x
            return jnp.where(jnp.asarray(keep), x / (1.0 - self.rate), jnp.zeros_like(x))

    monkeypatch.setattr(jvit.nn, "Dropout", PinnedDropout)
    monkeypatch.setattr(jstep, "train_transform", lambda k, x, ac: jnp.asarray(images))
    monkeypatch.setattr(jstep, "apply_mixup", lambda k, x, y, mc: (x, jnp.asarray(targets)))

    j_student, s_params, t_student = _models(STUDENT, 61)
    j_teacher, t_params, t_teacher = _models(TEACHER, 62)
    jcfg = JTrainConfig(**HP)
    jtx = j_make_optimizer(jcfg, {"student": s_params, "aux": {}}, 5)
    jstate = JTrainState.create(student_params=s_params, aux_params={}, tx=jtx,
                                ema_decay=jcfg.ema_decay)
    jfn = jstep.build_train_step(
        cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
        student_module=j_student, teacher_module=j_teacher,
        aug=JAugmentConfig(input_size=32), mixup=JMixupConfig(num_classes=C), tx=jtx,
        donate=False)
    calls.clear()   # the student's init called it in eval mode
    jstate, jm = jfn(jstate, t_params, jnp.asarray(u8), jnp.asarray(labels),
                     jax.random.PRNGKey(0), jnp.asarray(0, jnp.int32))
    assert calls == [False]   # the student once, in train mode; the teacher never

    cfg = TrainConfig(aa="", color_jitter=0.0, **HP)
    t_student.collect_features = False
    tx = make_optimizer(cfg, trainable_parameters(t_student), 5)
    state = TrainState(t_student, tx=tx, ema_decay=cfg.ema_decay)
    fn = build_train_step(
        cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2, teacher_prefix=2),
        student=t_student, teacher=t_teacher, aug=AugmentConfig.from_config(cfg),
        mixup=MixupConfig.from_config(cfg, C), tx=tx)
    m = fn(state, torch.from_numpy(u8), torch.from_numpy(labels),
           torch.Generator().manual_seed(0), images=torch.from_numpy(images),
           targets=torch.from_numpy(targets), token_keep=torch.from_numpy(keep))
    for k in ("train_loss", "base_loss", "distill_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    expect = flax_to_torch(jstate.params["student"])
    for name, p in t_student.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expect[name].numpy(), atol=1e-6, err_msg=name)


def test_token_dropout_draws_from_the_generator_and_eval_never_drops():
    _, _, student = _models(STUDENT, 63)
    x = torch.randn(8, N, STUDENT["embed_dim"], generator=torch.Generator().manual_seed(1))
    out = student.token_dropout(x, torch.Generator().manual_seed(2))
    kept = out != 0
    share = kept.float().mean().item()
    sigma = (P * (1 - P) / x.numel()) ** 0.5
    assert abs(share - (1 - P)) < 6 * sigma
    assert torch.equal(out[kept], (x / (1 - P))[kept])
    again = student.token_dropout(x, torch.Generator().manual_seed(2))
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="drop_rate > 0 needs token_keep or a generator"):
        student.token_dropout(x, None)

    images = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(3))
    plain = VisionTransformer(ViTConfig(**dict(STUDENT, drop_rate=0.0)), dtype=torch.float32,
                              block_fn=fused_vit_block)
    plain.load_state_dict(student.state_dict())
    with torch.no_grad():
        want = plain(images, train=False).logits
        assert torch.equal(student(images, train=False).logits, want)
        assert torch.equal(student.view(collect_features=False)(images).logits, want)
        trained = student(images, train=True, generator=torch.Generator().manual_seed(4))
    assert not torch.equal(trained.logits, plain(images, train=True).logits)
