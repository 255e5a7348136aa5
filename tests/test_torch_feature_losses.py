"""The port's feature objectives (deltakd_tpu_torch/kd/losses.py: wasskd-l1,
mgd, vitkd through `total_loss`) against the JAX package's `total_loss` on the
same logits, features, aux weights and masking noise: the combined loss, the
distill term, and the gradients with respect to every student feature the
objective reads and every aux weight.

fp32 on the CPU; the same terms in another summation order, so everything
holds to 1e-5 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.kd import aux as jaux
from deltakd_tpu.kd import losses as jlosses
from deltakd_tpu_torch.kd import losses as tlosses
from deltakd_tpu_torch.kd.aux import AuxHeads
from deltakd_tpu_torch.models.convert import aux_flax_to_torch

torch.set_num_threads(1)

B, L, SD, TD, C, DEPTH = 4, 16, 24, 40, 10, 4
SP, TP = 2, 2          # a distilled student and teacher: CLS + DIST prefix
TOL = 1e-5


def _close(a, b, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    err, scale = np.max(np.abs(a - b)), np.max(np.abs(b))
    assert err <= TOL * scale, f"{what}: max abs err {err:.3e} > {TOL} x {scale:.3e}"


def _batch(seed):
    rng = np.random.RandomState(seed)
    return dict(
        logits=rng.randn(B, C).astype(np.float32),
        targets=rng.dirichlet(np.ones(C), B).astype(np.float32),
        s_feats=[rng.randn(B, SP + L, SD).astype(np.float32) for _ in range(DEPTH)],
        t_feats=[rng.randn(B, TP + L, TD).astype(np.float32) for _ in range(DEPTH)])


@pytest.mark.parametrize("kd_type", ["wasskd", "mgd", "vitkd"])
def test_total_loss_and_gradients_match_jax(kd_type):
    data = _batch(1)
    key = jax.random.PRNGKey(9)
    tree = jaux.init_aux_params(jax.random.PRNGKey(2), kd_type, SD, TD)
    if "mask_token" in tree:
        tree["mask_token"] = tree["mask_token"] + 0.2
    settings = dict(distillation_type=kd_type, student_prefix=SP, teacher_prefix=TP,
                    mgd_alpha=0.7, mgd_mask_ratio=0.4)
    jkd = jlosses.KDSettings(**settings)

    def j_loss(s_feats, aux):
        loss, m = jlosses.total_loss(
            jkd, student_logits=jnp.asarray(data["logits"]), student_dist_logits=None,
            student_feats=s_feats, teacher_logits=None,
            teacher_feats=[jnp.asarray(f) for f in data["t_feats"]], aux_params=aux,
            targets=jnp.asarray(data["targets"]), rng=key, train=True)
        return loss, m

    (j_total, j_m), (j_gs, j_ga) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(f) for f in data["s_feats"]], tree)

    heads = AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(0))
    heads.load_state_dict(aux_flax_to_torch(tree))
    s_feats = [torch.from_numpy(f).requires_grad_(True) for f in data["s_feats"]]
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (B, L))))
    total, m = tlosses.total_loss(
        tlosses.KDSettings(**settings), student_logits=torch.from_numpy(data["logits"]),
        student_dist_logits=None, teacher_logits=None,
        targets=torch.from_numpy(data["targets"]), student_feats=s_feats,
        teacher_feats=[torch.from_numpy(f) for f in data["t_feats"]], aux=heads,
        noise=None if kd_type == "wasskd" else noise)
    assert set(m) == set(j_m)
    _close(total, j_total, "total")
    _close(m["distill_loss"], j_m["distill_loss"], "distill")
    _close(m["base_loss"], j_m["base_loss"], "base")
    assert m["distill_loss"].item() > 0

    params = dict(heads.named_parameters())
    grads = torch.autograd.grad(total, s_feats + list(params.values()), allow_unused=True)
    used = {"wasskd": (0, 1, 2), "mgd": (DEPTH - 1,), "vitkd": (0, 1, DEPTH - 1)}[kd_type]
    for i in range(DEPTH):
        if i in used:
            _close(grads[i], j_gs[i], f"d s_feats[{i}]")
        else:
            assert grads[i] is None and float(jnp.abs(j_gs[i]).max()) == 0.0
    expect = aux_flax_to_torch(j_ga)
    assert set(expect) == set(params)
    for name, g in zip(params, grads[DEPTH:]):
        _close(g, expect[name].numpy(), f"d aux {name}")


def test_combine_rules():
    """base + 5 * distill for wasskd, base + distill for mgd and vitkd."""
    data = _batch(3)
    for kd_type, weight in (("wasskd", 5.0), ("mgd", 1.0), ("vitkd", 1.0)):
        heads = AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(1))
        total, m = tlosses.total_loss(
            tlosses.KDSettings(distillation_type=kd_type, student_prefix=SP, mgd_alpha=1.0),
            student_logits=torch.from_numpy(data["logits"]), student_dist_logits=None,
            teacher_logits=None, targets=torch.from_numpy(data["targets"]),
            student_feats=[torch.from_numpy(f) for f in data["s_feats"]],
            teacher_feats=[torch.from_numpy(f) for f in data["t_feats"]], aux=heads,
            generator=torch.Generator().manual_seed(0))
        np.testing.assert_allclose(total.item(), m["base_loss"].item()
                                   + weight * m["distill_loss"].item(), rtol=1e-6)


@pytest.mark.parametrize("kd_type", ["lrkd", "diffkd", "curkd", "saliency_mgd",
                                     "wasskd-sinkhorn"])
def test_unported_objectives_raise(kd_type):
    data = _batch(4)
    kd = (tlosses.KDSettings(distillation_type="wasskd", wasskd_type="sinkhorn", student_prefix=SP)
          if kd_type == "wasskd-sinkhorn" else tlosses.KDSettings(distillation_type=kd_type))
    aux = (AuxHeads("wasskd", SD, TD, torch.Generator().manual_seed(0))
           if kd_type == "wasskd-sinkhorn" else None)
    with pytest.raises(NotImplementedError):
        tlosses.total_loss(
            kd, student_logits=torch.from_numpy(data["logits"]), student_dist_logits=None,
            teacher_logits=None, targets=torch.from_numpy(data["targets"]),
            student_feats=[torch.from_numpy(f) for f in data["s_feats"]],
            teacher_feats=[torch.from_numpy(f) for f in data["t_feats"]], aux=aux)


def test_feature_objective_needs_features_and_settings_are_whole():
    from deltakd_tpu.configs.config import TrainConfig as JTrainConfig
    from deltakd_tpu_torch.configs.config import TrainConfig

    data = _batch(5)
    with pytest.raises(ValueError):
        tlosses.total_loss(tlosses.KDSettings(distillation_type="mgd"),
                           student_logits=torch.from_numpy(data["logits"]),
                           student_dist_logits=None, teacher_logits=None,
                           targets=torch.from_numpy(data["targets"]))
    cfg = TrainConfig(aa="", color_jitter=0.0, distillation_type="wasskd", mgd_alpha=3e-5)
    jcfg = JTrainConfig(distillation_type="wasskd", mgd_alpha=3e-5)
    kd = tlosses.KDSettings.from_config(cfg, student_prefix=2, teacher_prefix=2)
    jkd = jlosses.KDSettings.from_config(jcfg, student_prefix=2, teacher_prefix=2)
    assert vars(kd) == vars(jkd)
