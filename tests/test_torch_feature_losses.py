"""The port's feature objectives (deltakd_tpu_torch/kd/losses.py: all seven
through `total_loss`: wasskd in its l1 and sinkhorn modes, mgd, vitkd, lrkd,
diffkd, curkd in each of its three phases, saliency_mgd with each of its
three attention methods) against the JAX package's `total_loss` on the same
logits, features, aux weights and draws (masking noise and DiffKD's draws
rebuilt from the JAX key by tests/jax_draws.py): the combined loss, the
distill term, and the gradients with respect to every student feature the
objective reads and every aux weight (a head the objective does not reach,
such as saliency_attn behind its argsort, has a zero gradient on both sides).

fp32 on the CPU; the same terms in another summation order, so everything
holds to 1e-5 of the largest value, except the sinkhorn gradients: they
weight each cost by exp(-C / eps) with eps = 0.0025, so one fp32 rounding of
|x|^2 (about 4e-6 at |x|^2 = 40) moves a weight by 0.16%, and the two
packages' cross products round differently (the port's in fp64). Those hold
to SINKHORN_GRAD_TOL = 1e-3 of the largest value.
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
from tests.jax_draws import diffkd_draws

torch.set_num_threads(1)

B, L, SD, TD, C, DEPTH = 4, 16, 24, 40, 10, 8
SP, TP = 2, 2          # a distilled student and teacher: CLS + DIST prefix
TOL = 1e-5
SINKHORN_GRAD_TOL = 1e-3
LAST = DEPTH - 1
# the student blocks each case reads, by the case's objective (and phase)
USED = {"wasskd": (0, 1, 2), "wasskd-sinkhorn": (0, 1, 2), "mgd": (LAST,),
        "vitkd": (0, 1, LAST), "lrkd": (0, 1, LAST), "diffkd": (0, 1, LAST),
        "curkd-0": (0, 1, 2), "curkd-120": (3, 4, 5, 6), "curkd-200": (LAST,),
        "saliency_mgd-1": (LAST,), "saliency_mgd-2": (LAST,), "saliency_mgd-3": (LAST,)}


def _close(a, b, what="", tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    err, scale = np.max(np.abs(a - b)), np.max(np.abs(b))
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol} x {scale:.3e}"


def _batch(seed):
    rng = np.random.RandomState(seed)
    return dict(
        logits=rng.randn(B, C).astype(np.float32),
        targets=rng.dirichlet(np.ones(C), B).astype(np.float32),
        s_feats=[rng.randn(B, SP + L, SD).astype(np.float32) for _ in range(DEPTH)],
        t_feats=[rng.randn(B, TP + L, TD).astype(np.float32) for _ in range(DEPTH)])


def _settings(case):
    """(distillation type, KDSettings fields, the epoch) of a test case."""
    kd_type, _, arg = case.partition("-")
    settings = dict(distillation_type=kd_type, student_prefix=SP, teacher_prefix=TP,
                    mgd_alpha=0.7, mgd_mask_ratio=0.4, lrkd_rank=8, lrkd_alpha=0.3,
                    lrkd_beta=0.2, lrkd_gamma=0.5, saliency_mask_ratio=0.4)
    if kd_type == "wasskd" and arg:
        settings["wasskd_type"] = arg
    if kd_type == "saliency_mgd":
        settings["saliency_method"] = int(arg)
    return kd_type, settings, int(arg) if kd_type == "curkd" else 0


@pytest.mark.parametrize("kd_type", list(USED))
def test_total_loss_and_gradients_match_jax(kd_type):
    case = kd_type
    kd_type, settings, epoch = _settings(case)
    data = _batch(1)
    key = jax.random.PRNGKey(9)
    tree = jaux.init_aux_params(jax.random.PRNGKey(2), kd_type, SD, TD,
                                lrkd_rank=settings["lrkd_rank"],
                                saliency_method=settings.get("saliency_method", 1))
    if "mask_token" in tree:
        tree["mask_token"] = tree["mask_token"] + 0.2
    jkd = jlosses.KDSettings(**settings)

    def j_loss(s_feats, aux):
        loss, m = jlosses.total_loss(
            jkd, student_logits=jnp.asarray(data["logits"]), student_dist_logits=None,
            student_feats=s_feats, teacher_logits=None,
            teacher_feats=[jnp.asarray(f) for f in data["t_feats"]], aux_params=aux,
            targets=jnp.asarray(data["targets"]), rng=key,
            epoch=jnp.asarray(epoch, jnp.int32), train=True)
        return loss, m

    (j_total, j_m), (j_gs, j_ga) = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(f) for f in data["s_feats"]], tree)

    heads = AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(0),
                     lrkd_rank=settings["lrkd_rank"],
                     saliency_method=settings.get("saliency_method", 1))
    heads.load_state_dict(aux_flax_to_torch(tree))
    s_feats = [torch.from_numpy(f).requires_grad_(True) for f in data["s_feats"]]
    total, m = tlosses.total_loss(
        tlosses.KDSettings(**settings), student_logits=torch.from_numpy(data["logits"]),
        student_dist_logits=None, teacher_logits=None,
        targets=torch.from_numpy(data["targets"]), student_feats=s_feats,
        teacher_feats=[torch.from_numpy(f) for f in data["t_feats"]], aux=heads,
        noise=torch.from_numpy(np.array(jax.random.uniform(key, (B, L)))),
        diffkd_draws=diffkd_draws(key, (B, L, TD)) if kd_type == "diffkd" else None,
        epoch=epoch)
    assert set(m) == set(j_m)
    _close(total, j_total, "total")
    _close(m["distill_loss"], j_m["distill_loss"], "distill")
    _close(m["base_loss"], j_m["base_loss"], "base")
    assert m["distill_loss"].item() > 0

    params = dict(heads.named_parameters())
    grads = torch.autograd.grad(total, s_feats + list(params.values()), allow_unused=True)
    tol = SINKHORN_GRAD_TOL if case == "wasskd-sinkhorn" else TOL
    for i in range(DEPTH):
        if i in USED[case]:
            _close(grads[i], j_gs[i], f"d s_feats[{i}]", tol)
        else:
            assert grads[i] is None and float(jnp.abs(j_gs[i]).max()) == 0.0
    expect = aux_flax_to_torch(j_ga)
    assert set(expect) == set(params)
    for name, g in zip(params, grads[DEPTH:]):
        if g is None:   # a head the objective does not reach
            assert float(expect[name].abs().max()) == 0.0, name
        else:
            _close(g, expect[name].numpy(), f"d aux {name}", tol)


def test_combine_rules():
    """base + 5 * distill for wasskd (both modes); base * (1 - alpha) + alpha
    * distill for lrkd and diffkd; base + distill for the others."""
    data = _batch(3)
    alpha = 0.3
    for case in USED:
        kd_type, settings, epoch = _settings(case)
        heads = AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(1),
                         lrkd_rank=settings["lrkd_rank"],
                         saliency_method=settings.get("saliency_method", 1))
        total, m = tlosses.total_loss(
            tlosses.KDSettings(**dict(settings, alpha=alpha, mgd_alpha=1.0)),
            student_logits=torch.from_numpy(data["logits"]), student_dist_logits=None,
            teacher_logits=None, targets=torch.from_numpy(data["targets"]),
            student_feats=[torch.from_numpy(f) for f in data["s_feats"]],
            teacher_feats=[torch.from_numpy(f) for f in data["t_feats"]], aux=heads,
            generator=torch.Generator().manual_seed(0), epoch=epoch)
        base, distill = m["base_loss"].item(), m["distill_loss"].item()
        expect = (base + 5.0 * distill if kd_type == "wasskd" else
                  base * (1 - alpha) + alpha * distill if kd_type in ("lrkd", "diffkd")
                  else base + distill)
        np.testing.assert_allclose(total.item(), expect, rtol=1e-6, err_msg=case)


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
