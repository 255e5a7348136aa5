"""The port's logit-KD losses, cosine schedule, flat-vector clipped AdamW,
TrainState (with EMA) and config checks against the JAX package's, on the
same numpy inputs. fp32 throughout: losses to rtol 1e-5, parameters after
several optimizer steps to 1e-6 absolute (pointwise math; only the clip's
norm reduction order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
from deltakd_tpu.kd import losses as jl
from deltakd_tpu.train import optim as jo
from deltakd_tpu.train.state import TrainState as JTrainState
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.kd import losses as tl
from deltakd_tpu_torch.train import optim as to
from deltakd_tpu_torch.train.state import TrainState, trainable_parameters

torch.set_num_threads(1)

B, C = 6, 10


def _logits(seed):
    rng = np.random.RandomState(seed)
    s, d, t = (rng.randn(B, C).astype(np.float32) * 2 for _ in range(3))
    labels = rng.randint(0, C, B)
    soft = rng.dirichlet(np.ones(C), B).astype(np.float32)
    return s, d, t, labels, soft


def test_base_criteria_and_kd_losses_match_jax():
    s, d, t, labels, soft = _logits(0)
    T = torch.from_numpy
    pairs = [
        (tl.soft_target_cross_entropy(T(s), T(soft)), jl.soft_target_cross_entropy(s, soft)),
        (tl.label_smoothing_cross_entropy(T(s), T(labels), 0.1),
         jl.label_smoothing_cross_entropy(s, jnp.asarray(labels), 0.1)),
        (tl.cross_entropy(T(s), T(labels)), jl.cross_entropy(s, jnp.asarray(labels))),
        (tl.soft_kd_loss(T(d), T(t), 3.0), jl.soft_kd_loss(d, t, 3.0)),
        (tl.hard_kd_loss(T(d), T(t)), jl.hard_kd_loss(d, t)),
    ]
    for a, b in pairs:
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


@pytest.mark.parametrize("kind,mixup", [("none", True), ("soft", True), ("hard", True),
                                        ("soft", False)])
def test_total_loss_matches_jax(kind, mixup):
    s, d, t, labels, soft = _logits(1)
    targets = soft if mixup else labels
    jkd = jl.KDSettings(distillation_type=kind, alpha=0.3, tau=2.0, mixup_active=mixup)
    tkd = tl.KDSettings(distillation_type=kind, alpha=0.3, tau=2.0, mixup_active=mixup)
    jloss, jm = jl.total_loss(jkd, student_logits=s, student_dist_logits=d, student_feats=None,
                              teacher_logits=t, teacher_feats=None, aux_params={},
                              targets=jnp.asarray(targets))
    T = torch.from_numpy
    tloss, tm = tl.total_loss(tkd, student_logits=T(s), student_dist_logits=T(d),
                              teacher_logits=T(t), targets=T(targets))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("base_loss", "distill_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7)


def test_feature_objectives_raise_until_ported():
    """Every objective is ported: none raises NotImplementedError, a feature
    objective without its features raises ValueError, and each reads the
    blocks the JAX package's reads."""
    for t in tl.FEATURE_TYPES:
        with pytest.raises(ValueError, match="requires student and teacher features"):
            tl.total_loss(tl.KDSettings(distillation_type=t), student_logits=torch.zeros(2, 3),
                          student_dist_logits=None, teacher_logits=None,
                          targets=torch.zeros(2, 3))
        assert tl.feature_indices(t, 12) == jl.feature_indices(t, 12)
    assert tl.FEATURE_TYPES == jl.FEATURE_TYPES
    assert tl.feature_indices("soft", 12) is False


SCHED = dict(lr=1e-2, warmup_lr=1e-4, min_lr=1e-3, warmup_epochs=1, epochs=3,
             weight_decay=0.05, clip_grad=1.0)


def test_cosine_schedule_matches_jax():
    jsched = jo.make_schedule(JTrainConfig(**SCHED), 2)
    tsched = to.make_schedule(TrainConfig(aa="", color_jitter=0.0, **SCHED), 2)
    for step in range(9):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6)


def _param_arrays(rng):
    return {"w": rng.randn(4, 6).astype(np.float32),
            "bias": rng.randn(6).astype(np.float32),
            "pos_embed": rng.randn(1, 3, 4).astype(np.float32),
            "m2": rng.randn(3, 3).astype(np.float32)}


def test_fused_clipped_adamw_and_ema_match_jax():
    rng = np.random.RandomState(0)
    init = _param_arrays(rng)
    grads = [_param_arrays(rng) for _ in range(7)]

    jcfg = JTrainConfig(**SCHED)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jtx = jo.make_optimizer(jcfg, {"student": jparams, "aux": {}}, 2)
    jstate = JTrainState.create(student_params=jparams, aux_params={}, tx=jtx, ema_decay=0.9)

    module = torch.nn.Module()
    for k, v in init.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    tcfg = TrainConfig(aa="", color_jitter=0.0, **SCHED)
    ttx = to.make_optimizer(tcfg, trainable_parameters(module), 2)
    tstate = TrainState(module, tx=ttx, ema_decay=0.9)
    mask = to.wd_mask(trainable_parameters(module))
    assert mask == {"student.w": True, "student.bias": False, "student.pos_embed": False,
                    "student.m2": True}

    for g in grads:
        jstate = jstate.apply_gradients(
            grads={"student": {k: jnp.asarray(v) for k, v in g.items()}, "aux": {}},
            tx=jtx, ema_decay=0.9)
        flat = torch.cat([torch.from_numpy(g[n.split(".", 1)[1]]).reshape(-1)
                          for n, _ in tstate.named_params])
        tstate.apply_gradients(grads=flat, tx=ttx, ema_decay=0.9)
    assert tstate.step == int(jstate.step) == 7
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params["student"][k]),
                                   atol=1e-6)
    ema = torch.split(tstate.ema_params, [p.numel() for _, p in tstate.named_params])
    for (name, p), e in zip(tstate.named_params, ema):
        np.testing.assert_allclose(e.view_as(p).numpy(), np.asarray(
            jstate.ema_params["student"][name.split(".", 1)[1]]), atol=1e-6)


def test_config_rejects_what_is_not_ported():
    """What the port lacks raises, and only what the JAX package lacks too (an
    optimizer, a schedule, an erasing mode, the aa specs it rejects); every
    optimizer, schedule and LR-noise setting and every augmentation flag of
    the JAX TrainConfig constructs, cutmix_minmax among them."""
    for kw in (dict(sched="tanh"), dict(opt="lamb"), dict(opt="lamb", lr_noise=(0.5,)),
               dict(remode="corner"), dict(aa="augmix-m5"),
               dict(aa="rand-m9-mstd0.5")):
        with pytest.raises(NotImplementedError):
            TrainConfig(**kw)
    # the JAX package raises for the same optimizer and schedule when it
    # builds them
    for kw in (dict(sched="tanh"), dict(opt="lamb")):
        with pytest.raises(NotImplementedError):
            jo.make_optimizer(JTrainConfig(**kw), {"w": jnp.zeros((2, 2))}, 2)
    for kw in (dict(), dict(aa="original-mstd0.5"), dict(aa="", color_jitter=0.3),
               dict(ThreeAugment=True), dict(src=True), dict(mixup_mode="pair"),
               dict(mixup_mode="elem"), dict(aa=None, color_jitter=0.0),
               dict(sched="step"), dict(opt="sgd"), dict(lr_noise=(0.5,)),
               dict(opt="momentum", sched="plateau", lr_noise=(0.2, 0.8)),
               dict(opt="adam"), dict(cutmix_minmax=(0.2, 0.8))):
        TrainConfig(**kw)
