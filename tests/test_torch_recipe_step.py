"""The slice as a whole: one soft-KD train step with the recipe's data path
(TrainConfig's defaults: RandAugment ``rand-m9-mstd0.5-inc1`` with its bf16
pixel stage, random erasing 0.25, mixup 0.8 / cutmix 1.0). The JAX package's
``build_train_step`` runs as it is, its augmentation and mixup drawn from its
key; the port's step takes the batch that the port's transform and mixup make
from the same draws (``images=``, ``targets=``). Same weights, drop-path rate
0, fp32 models on the CPU: loss terms and grad norm to rtol 1e-4, as the
step tests of ``test_torch_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.data.augment import AugmentConfig as JAugmentConfig
from deltakd_tpu.data.mixup import MixupConfig as JMixupConfig
from deltakd_tpu.kd.losses import KDSettings as JKDSettings
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.train import step as jstep
from deltakd_tpu.train.optim import make_optimizer as j_make_optimizer
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data import augment as ta
from deltakd_tpu_torch.data import mixup as tm
from deltakd_tpu_torch.kd.losses import KDSettings
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.ops.fused_block import fused_vit_block
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_train_step
from tests import jax_draws as jd

torch.set_num_threads(1)

B, C = 8, 10
STUDENT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2,
               num_classes=C, distilled=True)
TEACHER = dict(STUDENT, embed_dim=96)
# the recipe's augmentation defaults; mesh_shape (1,) is one data shard in
# both packages (the batch-subset heavy ops)
HP = dict(distillation_type="soft", alpha=0.1, tau=3.0, weight_decay=1e-4,
          drop_path_rate=0.0, lr=1e-3, warmup_epochs=0, epochs=10, opt_eps=1e-4,
          clip_grad=1.0, dataset="cifar-10", input_size=32, dtype="float32",
          mesh_shape=(1,))


def _pair(kw, seed):
    j = JViT(JViTConfig(**kw), dtype=jnp.float32)
    params = j.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)))["params"]
    t = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block)
    t.load_state_dict(flax_to_torch(params))
    return j, params, t


def test_recipe_soft_step_matches_jax():
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (B, 32, 32, 3)).astype(np.uint8)
    labels = rng.randint(0, C, B)
    j_student, s_params, t_student = _pair(STUDENT, 1)
    j_teacher, t_params, t_teacher = _pair(TEACHER, 2)

    jcfg = JTrainConfig(**HP).validate()
    jac = JAugmentConfig.from_config(jcfg)
    jmc = JMixupConfig.from_config(jcfg, C)
    assert jac.rand_augment is not None and jac.pixel_bf16 and jac.reprob == 0.25
    jtx = j_make_optimizer(jcfg, {"student": s_params, "aux": {}}, 5)
    jstate = JTrainState.create(student_params=s_params, aux_params={}, tx=jtx,
                                ema_decay=jcfg.ema_decay)
    jfn = jstep.build_train_step(
        cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
        student_module=j_student, teacher_module=j_teacher, aug=jac, mixup=jmc, tx=jtx,
        donate=False)
    key = jax.random.PRNGKey(0)
    jstate, jm = jfn(jstate, t_params, jnp.asarray(u8), jnp.asarray(labels), key,
                     jnp.asarray(0, jnp.int32))

    # the JAX step's augmentation and mixup keys: the first two of five split
    # off the step key folded with the step count
    k_aug, k_mix = jax.random.split(jax.random.fold_in(key, 0), 5)[:2]
    cfg = TrainConfig(**HP)
    ac = ta.AugmentConfig.from_config(cfg)
    mc = tm.MixupConfig.from_config(cfg, C)
    d = jd.train_draws(k_aug, u8.shape, jac)
    assert any(bool(op.apply.any()) for op in d.ra)
    images = ta.apply_train_transform(torch.from_numpy(u8), ac, d)
    assert images.dtype == torch.bfloat16
    images, targets = tm.mix_batch(images, torch.from_numpy(labels), mc,
                                   jd.mixup_draws(k_mix, B, 32, 32, jmc))
    tx = make_optimizer(cfg, trainable_parameters(t_student), 5)
    state = TrainState(t_student, tx=tx, ema_decay=cfg.ema_decay)
    fn = build_train_step(cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2,
                                                             teacher_prefix=2),
                          student=t_student, teacher=t_teacher, aug=ac, mixup=mc, tx=tx)
    m = fn(state, torch.from_numpy(u8), torch.from_numpy(labels),
           torch.Generator().manual_seed(0), images=images, targets=targets)
    for k in ("train_loss", "base_loss", "distill_loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    for k in ("train_acc1", "train_acc5"):
        assert float(m[k]) == float(jm[k]), k
