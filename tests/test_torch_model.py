"""The port's VisionTransformer against the JAX package's, on the same weights
carried across by models/convert.flax_to_torch: logits and per-block features,
distilled and plain, train and eval mode, through the unfused module path,
through the fused block (its plain version on the CPU) and through the unfused
path with ``flash_attention`` and ``fused_mlp`` (with and without a qkv bias);
the factory's choice of path from ``mesh_shape`` and ``flash_attention``; and
the block-pair path (``block_pair_fn``) against the JAX model on the Pallas
pair kernels in interpret mode, with its drop-path masks, ``state_dict``,
``view`` and the factory's ``block_pair``.

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
from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu.ops.attention import reference_attention as j_reference_attention
from deltakd_tpu.ops.fused_mlp import reference_mlp as j_reference_mlp
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.registry import get_model_config
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from deltakd_tpu_torch.ops.attention import flash_attention
from deltakd_tpu_torch.ops.fused_block import fused_vit_block, fused_vit_block_pair
from deltakd_tpu_torch.ops.fused_mlp import fused_mlp

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


@pytest.mark.parametrize("distilled", [False, True])
@pytest.mark.parametrize("qkv_bias", [True, False])
def test_unfused_kernel_path_matches_jax(distilled, qkv_bias):
    """attention_fn=flash_attention, mlp_fn=fused_mlp, no block_fn (their plain
    versions on the CPU) against the JAX model given reference_attention and
    reference_mlp, on the same weights: logits, the dist head, every feature."""
    kw = dict(distilled=distilled, qkv_bias=qkv_bias, **CFG)
    j = JViT(JViTConfig(**kw), dtype=jnp.float32, attention_fn=j_reference_attention,
             mlp_fn=j_reference_mlp)
    params = j.init({"params": jax.random.PRNGKey(4)}, jnp.zeros((1, 32, 32, 3)))["params"]
    t = VisionTransformer(ViTConfig(**kw), dtype=torch.float32,
                          attention_fn=flash_attention, mlp_fn=fused_mlp)
    t.load_state_dict(flax_to_torch(params))
    assert (t.blocks[0].attn.qkv.bias is None) == (not qkv_bias)
    x = np.random.RandomState(4).randn(4, 32, 32, 3).astype(np.float32)
    jo = j.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.no_grad():
        to = t(torch.from_numpy(x), train=False)
    _close(to.logits, jo.logits)
    if distilled:
        _close(to.logits_dist, jo.logits_dist)
    for tf, jf in zip(to.features, jo.features):
        _close(tf, jf)


def test_no_qkv_bias_runs_unfused_on_cpu_and_raises_elsewhere():
    """A model without a qkv bias takes the unfused path on every device: it
    calls its attention_fn and mlp_fn and never its block_fn (nothing raises
    any more; the name is kept from when the card refused such a model)."""
    calls = {"attention": 0, "mlp": 0}

    def attention_fn(q, k, v):
        calls["attention"] += 1
        assert q.shape == (2, 2, 18, 32)
        return flash_attention(q, k, v)

    def mlp_fn(x, w1, b1, w2, b2):
        calls["mlp"] += 1
        assert w1.shape == (256, 64) and w2.shape == (64, 256)
        return fused_mlp(x, w1, b1, w2, b2)

    def block_fn(*args, **kwargs):
        raise AssertionError("block_fn called for a model without a qkv bias")

    cfg = ViTConfig(distilled=True, qkv_bias=False, **CFG)
    model = VisionTransformer(cfg, dtype=torch.float32, attention_fn=attention_fn,
                              mlp_fn=mlp_fn, block_fn=block_fn)
    plain = VisionTransformer(cfg, dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        out = model(x)
        _close(out.logits, plain(x).logits)
    assert calls == {"attention": CFG["depth"], "mlp": CFG["depth"]}
    # with a qkv bias the same block_fn wins over attention_fn and mlp_fn
    biased = VisionTransformer(ViTConfig(distilled=True, **CFG), dtype=torch.float32,
                               attention_fn=attention_fn, mlp_fn=mlp_fn, block_fn=block_fn)
    with pytest.raises(AssertionError, match="block_fn called"), torch.no_grad():
        biased(x)


def test_view_shares_parameters_and_overrides_the_path():
    """The eval view: same parameter storage, its own mlp_fn and feature
    collection; the model it came from is unchanged."""
    _, _, t, x = _models(True, False, seed=5)
    t.attention_fn = flash_attention
    view = t.view(mlp_fn=fused_mlp, collect_features=False)
    assert view.mlp_fn is fused_mlp and t.mlp_fn is None
    assert view.attention_fn is flash_attention and t.collect_features is True
    for (n1, p1), (n2, p2) in zip(t.named_parameters(), view.named_parameters()):
        assert n1 == n2 and p1 is p2
    with torch.no_grad():
        before = view(torch.from_numpy(x)).logits
        assert view.collect_features is False
        _close(before, t(torch.from_numpy(x)).logits)
        t.head.weight.mul_(2.0)      # an update of the model shows in the view
        _close(view(torch.from_numpy(x)).logits, t(torch.from_numpy(x)).logits)
        assert not torch.equal(view(torch.from_numpy(x)).logits, before)
    with pytest.raises(TypeError):
        t.view(dtype=torch.bfloat16)


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
    ("vitkd", {0, 1, 11}, {"align2", "align", "mask_token", "generation"}),
    ("lrkd", {0, 1, 11}, {"align"}),
    ("diffkd", {0, 1, 11}, {"denoise", "align"}),
    ("curkd", {0, 1, 2, 3, 4, 5, 6, 11}, {"curkd_align_early", "curkd_align_mid",
                                          "curkd_align_last", "mask_token", "generation"}),
    ("saliency_mgd", {11}, {"align", "mask_token", "generation", "saliency_attn"})])
def test_load_teacher_student_returns_the_aux_heads(kd_type, feats, aux_keys):
    """(teacher, student, aux) as the JAX factory: aux is None for a logit
    objective, else the heads of the type from student width to teacher
    width (LRKD's to its rank, Saliency-MGD's attention by its method);
    both models collect only the features the objective reads."""
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
        return
    assert {n.split(".")[0] for n, _ in aux.named_parameters()} == aux_keys
    first = {"wasskd": "align_wasskd.0", "curkd": "curkd_align_early.0",
             "lrkd": "align.0", "diffkd": "align.0"}.get(kd_type, "align")
    assert aux.get_submodule(first).weight.shape == ((32 if kd_type == "lrkd" else 384), 192)
    if kd_type == "lrkd":   # the config's rank sizes the align layers
        _, _, aux = load_teacher_student(cfg.replace(lrkd_rank=16), device="cpu")
        assert aux.align[2].weight.shape == (16, 192)
    if kd_type == "saliency_mgd":   # the config's method picks the attention heads
        _, _, aux = load_teacher_student(cfg.replace(saliency_method=3), device="cpu")
        assert {n for n, _ in aux.saliency_attn.named_children()} == {"q", "k"}


@pytest.mark.parametrize("mesh_shape,flash,path", [
    (None, True, "fused"), ((2, 1), True, "fused"), ((1, 2), True, "unfused"),
    ((1, 2), False, "plain")])
def test_load_teacher_student_picks_the_path_from_the_config(mesh_shape, flash, path):
    """As the JAX factory: the fused block unless the mesh has a model axis
    > 1, then flash_attention for both and fused_mlp for the frozen teacher
    only; with the kernels off, PyTorch's own ops throughout."""
    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.models.factory import load_teacher_student

    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224", aa="",
                      color_jitter=0.0, dataset="cifar-10", input_size=32,
                      distillation_type="soft", allow_random_teacher=True,
                      mesh_shape=mesh_shape, flash_attention=flash)
    fields = TrainConfig.__dataclass_fields__
    assert fields["flash_attention"].default is True and fields["mesh_shape"].default is None
    teacher, student, _ = load_teacher_student(cfg, seed=0, device="cpu")
    kernels = path != "plain"
    for model in (teacher, student):
        assert model.block_fn is (fused_vit_block if path == "fused" else None)
        assert model.attention_fn is (flash_attention if kernels else None)
    assert teacher.mlp_fn is (fused_mlp if kernels else None)
    assert student.mlp_fn is None
    if path == "unfused":
        # an explicit attention_fn=None turns the kernels off whatever the config says
        teacher, student, _ = load_teacher_student(cfg, attention_fn=None, device="cpu")
        assert teacher.block_fn is None and teacher.mlp_fn is None
        assert student.attention_fn is None


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("train", [False, True])
def test_paired_model_matches_jax_paired_model(depth, train, monkeypatch):
    """The pairing loop: blocks 0-1 through one pair call, at depth 3 the odd
    last block through the single block; only block 1's feature is collected
    (the pair's (False, True) variant). The JAX model runs the Pallas pair and
    block kernels in interpret mode."""
    monkeypatch.setenv("DELTAKD_FUSED_CP", "0")
    monkeypatch.delenv("DELTAKD_PAIR_HYBRID", raising=False)
    kw = dict(CFG, depth=depth, distilled=True)
    collect = frozenset({1})
    j = JViT(JViTConfig(**kw), dtype=jnp.float32, block_fn=jfb.fused_vit_block,
             block_pair_fn=jfb.fused_vit_block_pair, collect_features=collect)
    x = np.random.RandomState(6).randn(4, 32, 32, 3).astype(np.float32)
    jfb.set_interpret(True)
    try:
        params = j.init({"params": jax.random.PRNGKey(6)}, jnp.zeros((1, 32, 32, 3)))["params"]
        jo = j.apply({"params": params}, jnp.asarray(x), train=train)
    finally:
        jfb.set_interpret(False)
    calls = []

    def counting_pair(*args, **kwargs):
        calls.append((kwargs["need_features1"], kwargs["need_features2"]))
        return fused_vit_block_pair(*args, **kwargs)

    t = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block,
                          block_pair_fn=counting_pair, collect_features=collect)
    t.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        to = t(torch.from_numpy(x), train=train)
    assert calls == [(False, True)]
    _close(to.logits, jo.logits)
    _close(to.logits_dist, jo.logits_dist)
    assert len(to.features) == depth
    for i, (tf, jf) in enumerate(zip(to.features, jo.features)):
        if i == 1:
            _close(tf, jf)
        else:
            assert tf is None and jf is None


def test_paired_and_single_models_share_masks_and_state_dict():
    """Pairing changes neither the parameters nor the drop-path draws: equal
    generators give equal masks, each model loads the other's state_dict, and
    on the CPU at fp32 both compute the same function of them."""
    kw = dict(CFG, distilled=True, drop_path_rate=0.2)
    single = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block)
    paired = VisionTransformer(ViTConfig(**kw), dtype=torch.float32, block_fn=fused_vit_block,
                               block_pair_fn=fused_vit_block_pair)
    with torch.no_grad():
        for p in single.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    assert list(single.state_dict()) == list(paired.state_dict())
    paired.load_state_dict(single.state_dict())
    single.load_state_dict(paired.state_dict())
    a = single.draw_drop_scales(8, torch.Generator().manual_seed(3), "cpu")
    b = paired.draw_drop_scales(8, torch.Generator().manual_seed(3), "cpu")
    assert a[0] is None and b[0] is None
    for pa, pb in zip(a[1:], b[1:]):
        assert all(torch.equal(u, v) for u, v in zip(pa, pb))
    x = torch.from_numpy(np.random.RandomState(7).randn(8, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        so = single(x, train=True, generator=torch.Generator().manual_seed(4))
        po = paired(x, train=True, generator=torch.Generator().manual_seed(4))
    _close(po.logits, so.logits)
    for pf, sf in zip(po.features, so.features):
        _close(pf, sf)


def test_view_without_pairs_shares_storage_and_lists_its_overrides():
    """The eval model of a paired student: single blocks on the same
    parameters. view() takes exactly VIEW_OVERRIDES."""
    calls = {"pair": 0, "block": 0}

    def pair_fn(*args, **kwargs):
        calls["pair"] += 1
        return fused_vit_block_pair(*args, **kwargs)

    def block_fn(*args, **kwargs):
        calls["block"] += 1
        return fused_vit_block(*args, **kwargs)

    paired = VisionTransformer(ViTConfig(distilled=True, **CFG), dtype=torch.float32,
                               block_fn=block_fn, block_pair_fn=pair_fn)
    view = paired.view(block_pair_fn=None, collect_features=False)
    assert view.block_pair_fn is None and paired.block_pair_fn is pair_fn
    for (n1, p1), (n2, p2) in zip(paired.named_parameters(), view.named_parameters()):
        assert n1 == n2 and p1 is p2
    x = torch.from_numpy(np.random.RandomState(8).randn(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        out = view(x)
        assert calls == {"pair": 0, "block": CFG["depth"]}
        assert all(f is None for f in out.features)
        _close(paired(x).logits, out.logits)
        assert calls == {"pair": 1, "block": CFG["depth"] + 1}    # depth 3: a pair and a block
    assert "block_pair_fn" in VisionTransformer.VIEW_OVERRIDES
    for name in VisionTransformer.VIEW_OVERRIDES:
        assert getattr(paired.view(**{name: None}), name) is None
    with pytest.raises(TypeError, match="block_pair_fn"):
        paired.view(num_heads=2)


def test_no_qkv_bias_model_ignores_block_pair_fn():
    def pair_fn(*args, **kwargs):
        raise AssertionError("block_pair_fn called for a model without a qkv bias")

    cfg = ViTConfig(distilled=True, qkv_bias=False, **CFG)
    model = VisionTransformer(cfg, dtype=torch.float32, block_pair_fn=pair_fn)
    with torch.no_grad():
        out = model(torch.zeros(2, 32, 32, 3))
    assert out.logits.shape == (2, 10)


@pytest.mark.parametrize("mesh_shape,flash,block_pair,paired", [
    (None, True, True, True), ((2, 1), True, True, True), (None, True, False, False),
    ((1, 2), True, True, False), (None, False, True, False)])
def test_load_teacher_student_pairs_the_student_only(mesh_shape, flash, block_pair, paired):
    """block_pair=True (the JAX factory's DELTAKD_PAIR=1) gives the student,
    never the teacher, fused_vit_block_pair, and only with the kernels on and
    no model axis."""
    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.models.factory import create_model, load_teacher_student

    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224", aa="",
                      color_jitter=0.0, dataset="cifar-10", input_size=32,
                      distillation_type="soft", allow_random_teacher=True,
                      mesh_shape=mesh_shape, flash_attention=flash)
    teacher, student, _ = load_teacher_student(cfg, block_pair=block_pair, seed=0,
                                               device="cpu")
    assert teacher.block_pair_fn is None
    assert student.block_pair_fn is (fused_vit_block_pair if paired else None)
    if paired:
        assert student.block_fn is fused_vit_block
        eval_model = student.view(block_pair_fn=None, collect_features=False)
        assert eval_model.block_pair_fn is None and eval_model.head.weight is student.head.weight
    default = create_model("deit_tiny_distilled_patch16_224", num_classes=10, img_size=32,
                           device="cpu")
    assert default.block_pair_fn is None
