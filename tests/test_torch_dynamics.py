"""The port's train step against the JAX package's ``build_train_step`` over
many steps: 32 steps at 4 steps an epoch, 2 warmup epochs and then the
per-epoch cosine to epoch 8, so the run crosses 7 epoch boundaries of the
schedule; clip 1.0, weight decay 0.05 (AdamW's decay mask) and the EMA on.
``tests/test_torch_step.py`` holds one step; a slip that shows only over
steps (the schedule's epoch, the decay mask, the EMA, a bias that compounds)
shows here.

Both sides start from the same weights (``flax_to_torch`` /
``aux_flax_to_torch``) and see the same post-transform images and soft
targets at every step: the JAX step's ``train_transform`` and
``apply_mixup`` are replaced by functions that unpack them from the array
passed as its uint8 batch (one trace for all steps), the port takes them
through ``images=`` / ``targets=``. Drop-path rate 0. For mgd the JAX step's
masking noise (drawn from its loss key, the step key folded with the step
count) is handed to the port's ``mask_noise=``. fp32 on the CPU, lr 1e-3 and
eps 1e-4, so that a last-bit difference in a gradient cannot flip an update.

At every step the loss terms, ``grad_norm`` and the schedule's LR at the
optimizer's count agree to rtol 1e-3; after the last step the student's
parameters, the aux parameters and the EMA agree to 1e-5 absolute.
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
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu.train import step as jstep
from deltakd_tpu.train.optim import make_optimizer as j_make_optimizer
from deltakd_tpu.train.optim import make_schedule as j_make_schedule
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.data.augment import AugmentConfig
from deltakd_tpu_torch.data.mixup import MixupConfig
from deltakd_tpu_torch.kd.aux import AuxHeads
from deltakd_tpu_torch.kd.losses import KDSettings
from deltakd_tpu_torch.models.convert import aux_flax_to_torch, flax_to_torch
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.ops.fused_block import fused_vit_block
from deltakd_tpu_torch.train.optim import make_optimizer
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
from deltakd_tpu_torch.train.step import build_train_step

torch.set_num_threads(1)

B, C, IMG, PATCH = 4, 10, 32, 8
STEPS, SPE = 32, 4            # 8 schedule epochs: 2 of warmup, then cosine
STUDENT = dict(img_size=IMG, patch_size=PATCH, embed_dim=64, depth=2, num_heads=2,
               num_classes=C, distilled=True)
TEACHER = dict(STUDENT, embed_dim=96)
HP = dict(alpha=0.5, tau=2.0, mgd_alpha=0.5, drop_path_rate=0.0, lr=1e-3,
          warmup_epochs=2, epochs=8, opt_eps=1e-4, clip_grad=1.0, weight_decay=0.05,
          ema_decay=0.9, dataset="cifar-10", input_size=IMG, dtype="float32")
STEP_RTOL = 1e-3              # loss terms, grad_norm and LR at every step
PARAM_ATOL = 1e-5             # student, aux and EMA after the last step
# the features each objective reads (kd.losses.feature_indices at depth 2)
FEATURES = {"soft": set(), "mgd": {1}}


def _pair(kw, seed):
    j = JViT(JViTConfig(**kw), dtype=jnp.float32)
    params = j.init({"params": jax.random.PRNGKey(seed)},
                    jnp.zeros((1, IMG, IMG, 3)))["params"]
    t = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block)
    t.load_state_dict(flax_to_torch(params))
    return j, params, t


def _batches(seed):
    """Per step: post-transform images, labels and soft targets."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, IMG, IMG, 3).astype(np.float32), rng.randint(0, C, B),
             rng.dirichlet(np.ones(C), B).astype(np.float32)) for _ in range(STEPS)]


def _pin_jax_batch(monkeypatch):
    """The JAX step takes [B, IMG*IMG*3 + C]: the pinned images, then the
    soft targets. Its transform unpacks the images and keeps the targets for
    its mixup, which runs next in the same trace."""
    kept = {}
    n = IMG * IMG * 3

    def transform(key, packed, aug):
        kept["targets"] = packed[:, n:]
        return packed[:, :n].reshape(-1, IMG, IMG, 3)

    monkeypatch.setattr(jstep, "train_transform", transform)
    monkeypatch.setattr(jstep, "apply_mixup", lambda k, x, y, mc: (x, kept["targets"]))


def _flat(student_tree, aux_tree, names):
    """A JAX student (and aux) tree as the port's flat vector over ``names``."""
    by_name = {f"student.{k}": v for k, v in flax_to_torch(student_tree).items()}
    by_name.update({f"aux.{k}": v for k, v in aux_flax_to_torch(aux_tree).items()})
    return torch.cat([by_name[n].reshape(-1) for n in names])


def _worst(errs, key, got, want, rtol):
    err = abs(float(got) - float(want)) / max(abs(float(want)), 1e-12)
    errs[key] = max(errs.get(key, 0.0), err)
    assert err <= rtol, f"{key}: port {float(got)!r}, JAX {float(want)!r}"


@pytest.mark.parametrize("kd_type", ["soft", "mgd"])
def test_trajectory_tracks_jax(kd_type, monkeypatch):
    hp = dict(HP, distillation_type=kd_type)
    j_student, s_params, t_student = _pair(STUDENT, 31)
    j_teacher, t_params, t_teacher = _pair(TEACHER, 32)
    aux_tree = {}
    aux = None
    if kd_type == "mgd":
        aux_tree = init_aux_params(jax.random.PRNGKey(33), kd_type, STUDENT["embed_dim"],
                                   TEACHER["embed_dim"])
        aux_tree["mask_token"] = aux_tree["mask_token"] + 0.1
        aux = AuxHeads(kd_type, STUDENT["embed_dim"], TEACHER["embed_dim"],
                       torch.Generator().manual_seed(0))
        aux.load_state_dict(aux_flax_to_torch(aux_tree))
    t_student.collect_features = t_teacher.collect_features = FEATURES[kd_type]

    _pin_jax_batch(monkeypatch)
    jcfg = JTrainConfig(**hp)
    jtx = j_make_optimizer(jcfg, {"student": s_params, "aux": aux_tree}, SPE)
    j_sched = j_make_schedule(jcfg, SPE)
    jstate = JTrainState.create(student_params=s_params, aux_params=aux_tree, tx=jtx,
                                ema_decay=jcfg.ema_decay)
    jfn = jstep.build_train_step(
        cfg=jcfg, kd=JKDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2),
        student_module=j_student, teacher_module=j_teacher,
        aug=JAugmentConfig(input_size=IMG), mixup=JMixupConfig(num_classes=C), tx=jtx,
        donate=False)

    cfg = TrainConfig(aa="", color_jitter=0.0, **hp)
    tx = make_optimizer(cfg, trainable_parameters(t_student, aux), SPE)
    state = TrainState(t_student, tx=tx, aux=aux, ema_decay=cfg.ema_decay)
    fn = build_train_step(
        cfg=cfg, kd=KDSettings.from_config(cfg, student_prefix=2, teacher_prefix=2),
        student=t_student, teacher=t_teacher, aux=aux, aug=AugmentConfig.from_config(cfg),
        mixup=MixupConfig.from_config(cfg, C), tx=tx)

    key = jax.random.PRNGKey(0)
    n_patches = (IMG // PATCH) ** 2
    u8 = torch.zeros(B, IMG, IMG, 3, dtype=torch.uint8)   # unused: the batch is pinned
    errs, lrs = {}, []
    for s, (images, labels, targets) in enumerate(_batches(30)):
        epoch = s // SPE
        j_lr = float(j_sched(int(jstate.opt_state.count)))
        lr = tx.learning_rate(state.opt_state.count)
        _worst(errs, "lr", lr, j_lr, STEP_RTOL)
        lrs.append(lr)
        packed = np.concatenate([images.reshape(B, -1), targets], axis=1)
        jstate, jm = jfn(jstate, t_params, jnp.asarray(packed), jnp.asarray(labels), key,
                         jnp.asarray(epoch, jnp.int32))
        noise = None
        if kd_type == "mgd":
            # the JAX step's loss key: the third of five split off the step key
            # folded with the step count
            k_loss = jax.random.split(jax.random.fold_in(key, s), 5)[2]
            noise = torch.from_numpy(np.array(jax.random.uniform(k_loss, (B, n_patches))))
        m = fn(state, u8, torch.from_numpy(labels), torch.Generator().manual_seed(s),
               images=torch.from_numpy(images), targets=torch.from_numpy(targets),
               epoch=epoch, mask_noise=noise)
        for k in ("train_loss", "base_loss", "distill_loss", "grad_norm"):
            _worst(errs, k, m[k], jm[k], STEP_RTOL)
    # 2 warmup epochs, then the cosine: one LR an epoch, 7 changes
    assert len({round(v, 12) for v in lrs}) == STEPS // SPE
    assert lrs[SPE] > lrs[0] and lrs[-1] < lrs[3 * SPE]

    names = [n for n, _ in state.named_params]
    n_student = sum(p.numel() for p in t_student.parameters())
    want = _flat(jstate.params["student"], jstate.params["aux"], names)
    want_ema = _flat(jstate.ema_params["student"], jstate.ema_params["aux"], names)
    parts = {"student": (state.params[:n_student], want[:n_student]),
             "aux": (state.params[n_student:], want[n_student:]),
             "ema": (state.ema_params, want_ema)}
    for what, (got, expect) in parts.items():
        if got.numel():
            errs[what] = float((got - expect).abs().max())
    print(f"[{kd_type}] largest error over {STEPS} steps: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for what in parts:
        assert errs.get(what, 0.0) <= PARAM_ATOL, (
            f"{what}: largest |port - JAX| {errs[what]:.3e} after {STEPS} steps")
    # the run moved the parameters far beyond the limit
    start = _flat(s_params, aux_tree, names)
    assert float((state.params - start).abs().max()) > 100 * PARAM_ATOL
