"""The port's VisionTransformer against the JAX package's, on the same weights
carried across by models/convert.flax_to_torch: logits and per-block features,
distilled and plain, train and eval mode, through the unfused module path and
through the fused block (its plain version on the CPU).

fp32 on the CPU; tolerance 1e-4 of the largest reference value (summation
order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.models.import_timm import timm_to_flax
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.registry import get_model_config
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.ops.fused_block import fused_vit_block

torch.set_num_threads(1)

TOL = 1e-4
CFG = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=2,
           num_classes=10)   # N = 16 patches + prefix


def _models(distilled, fused, seed=0):
    j = JViT(JViTConfig(distilled=distilled, **CFG), dtype=jnp.float32)
    params = j.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, 32, 32, 3)))["params"]
    t = VisionTransformer(ViTConfig(distilled=distilled, **CFG), dtype=torch.float32,
                          block_fn=fused_vit_block if fused else None)
    t.load_state_dict(flax_to_torch(params))
    x = np.random.RandomState(seed).randn(4, 32, 32, 3).astype(np.float32)
    return j, params, t, x


def _close(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
    assert err <= TOL * scale, f"max abs err {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("distilled", [False, True])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_logits_and_features_match_jax(distilled, train, fused):
    j, params, t, x = _models(distilled, fused)
    jo = j.apply({"params": params}, jnp.asarray(x), train=train)
    with torch.no_grad():
        to = t(torch.from_numpy(x), train=train)
    _close(to.logits, jo.logits)
    if distilled:
        _close(to.logits_dist, jo.logits_dist)
    else:
        assert to.logits_dist is None
    assert len(to.features) == CFG["depth"]
    for tf, jf in zip(to.features, jo.features):
        _close(tf, jf)


def test_fused_path_writes_only_collected_features():
    _, _, t, x = _models(True, True)
    t.collect_features = frozenset({2})
    with torch.no_grad():
        out = t(torch.from_numpy(x), train=True)
        assert out.features[0] is None and out.features[1] is None
        assert out.features[2].shape == (4, 18, 64)
        assert all(f is None for f in t(torch.from_numpy(x), collect_features=False).features)


def test_distilled_train_returns_both_heads_eval_the_average():
    _, _, t, x = _models(True, False, seed=1)
    with torch.no_grad():
        tr = t(torch.from_numpy(x), train=True)
        ev = t(torch.from_numpy(x), train=False)
    torch.testing.assert_close(ev.logits, (tr.logits + tr.logits_dist) / 2)


def test_no_qkv_bias_runs_unfused_on_cpu_and_raises_elsewhere():
    cfg = ViTConfig(distilled=True, qkv_bias=False, **CFG)
    fused = VisionTransformer(cfg, dtype=torch.float32, block_fn=fused_vit_block)
    plain = VisionTransformer(cfg, dtype=torch.float32)
    plain.load_state_dict(fused.state_dict())
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(fused(x).logits, plain(x).logits, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="qkv_bias"):
        fused(x.to("meta"))


def test_flax_to_torch_inverts_timm_to_flax():
    j, params, t, _ = _models(True, False, seed=2)
    back, report = timm_to_flax({k: v.numpy() for k, v in t.state_dict().items()}, params)
    assert not report["skipped"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(t.state_dict()) == set(flax_to_torch(params))


def test_drop_path_ramp_and_scales():
    cfg = get_model_config("deit_tiny_distilled_patch16_224", num_classes=10,
                           drop_path_rate=0.1)
    assert (cfg.embed_dim, cfg.num_heads, cfg.depth) == (192, 3, 12)
    t = VisionTransformer(ViTConfig(distilled=True, drop_path_rate=0.1, **CFG),
                          dtype=torch.float32)
    rates = t.drop_path_rates()
    np.testing.assert_allclose(rates, [0.0, 0.05, 0.1])
    scales = t.draw_drop_scales(1000, torch.Generator().manual_seed(0), "cpu")
    assert scales[0] is None
    s = scales[2][0]
    np.testing.assert_allclose(np.unique(s.numpy()), [0.0, 1 / 0.9], rtol=1e-6)
    assert abs(float((s > 0).float().mean()) - 0.9) < 0.04
    with pytest.raises(ValueError):
        t(torch.zeros(2, 32, 32, 3), train=True)


@pytest.mark.parametrize("kd_type,feats,aux_keys", [
    ("soft", False, None),
    ("wasskd", {0, 1, 2}, {"align_wasskd"}),
    ("mgd", {11}, {"align", "mask_token", "generation"}),
    ("vitkd", {0, 1, 11}, {"align2", "align", "mask_token", "generation"})])
def test_load_teacher_student_returns_the_aux_heads(kd_type, feats, aux_keys):
    """(teacher, student, aux) as the JAX factory: aux is None for a logit
    objective, else the heads of the type from student width to teacher
    width; both models collect only the features the objective reads."""
    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.models.factory import load_teacher_student

    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224", aa="",
                      color_jitter=0.0, dataset="cifar-10", input_size=32,
                      distillation_type=kd_type, allow_random_teacher=True)
    teacher, student, aux = load_teacher_student(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in teacher.parameters())
    assert [student._collect(i, None) for i in range(12)] == [
        bool(feats) and i in feats for i in range(12)]
    assert teacher.collect_features == student.collect_features
    if aux_keys is None:
        assert aux is None
    else:
        assert {n.split(".")[0] for n, _ in aux.named_parameters()} == aux_keys
        assert aux.align_wasskd[0].weight.shape == (384, 192) if kd_type == "wasskd" \
            else aux.align.weight.shape == (384, 192)
    with pytest.raises(NotImplementedError):
        load_teacher_student(cfg.replace(distillation_type="lrkd"), device="cpu")
