"""The port's teacher import (``models/import_timm.py``, ``models/pos_embed.py``)
against the JAX package's: a timm-named checkpoint written here with
``torch.save`` (a DeiT ``{"model": ...}`` wrapper with non-tensor entries
beside it, ``module.`` prefixes, a 1000-class head and a position-embedding
grid twice the target's) and the same weights as an ``.npz`` go into the
port's ``VisionTransformer`` through ``timm_to_torch`` and into the JAX model
through ``load_state_dict`` + ``timm_to_flax``. The reports are equal (the
heads skipped, every block loaded), and the logits agree to 1e-4 of the
largest value once both models carry the same fresh heads;
``interpolate_pos_embed`` agrees to 1e-5. Then the factory:
``load_teacher_student`` with ``teacher_checkpoint``.

fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.models.import_timm import load_state_dict as j_load_state_dict
from deltakd_tpu.models.import_timm import timm_to_flax
from deltakd_tpu.models.pos_embed import interpolate_pos_embed as j_interpolate_pos_embed
from deltakd_tpu.models.vit import ViTConfig as JViTConfig
from deltakd_tpu.models.vit import VisionTransformer as JViT
from deltakd_tpu_torch.configs.config import TrainConfig
from deltakd_tpu_torch.models.convert import flax_to_torch
from deltakd_tpu_torch.models.factory import load_teacher_student
from deltakd_tpu_torch.models.import_timm import (load_state_dict, strip_module_prefix,
                                                  timm_to_torch)
from deltakd_tpu_torch.models.pos_embed import interpolate_pos_embed
from deltakd_tpu_torch.models.vit import ViTConfig, VisionTransformer, init_weights

torch.set_num_threads(1)

TARGET = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=2, num_classes=10)


def _source_state(distilled=True, seed=0):
    """A timm-named state_dict of random values at a doubled grid (8 x 8
    patches) with a 1000-class head."""
    src = VisionTransformer(ViTConfig(**dict(TARGET, img_size=64, num_classes=1000,
                                             distilled=distilled)), dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    return {k: 0.2 * torch.randn(v.shape, generator=g) + (1.0 if "norm" in k and
                                                            k.endswith("weight") else 0.0)
            for k, v in src.state_dict().items()}


def _write(tmp_path, state, fmt):
    if fmt == "pth":
        path = str(tmp_path / "teacher.pth")
        torch.save({"model": {"module." + k: v for k, v in state.items()}, "epoch": 299,
                    "args": "deit_small_distilled_patch16_224"}, path)
    else:
        path = str(tmp_path / "teacher.npz")
        np.savez(path, **{k: v.numpy() for k, v in state.items()})
    return path


def _timm_name(flax_path):
    """'blocks_0/attn/qkv/kernel' -> 'blocks.0.attn.qkv.weight'."""
    parts = flax_path.split("/")
    if parts[0].startswith("blocks_"):
        parts[0] = "blocks." + parts[0][len("blocks_"):]
    if parts[0] == "patch_embed":
        parts.insert(1, "proj")
    parts[-1] = {"kernel": "weight", "scale": "weight"}.get(parts[-1], parts[-1])
    return ".".join(parts)


def _both_imports(path, distilled=True):
    j = JViT(JViTConfig(distilled=distilled, **TARGET), dtype=jnp.float32)
    params = j.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)))["params"]
    params, jreport = timm_to_flax(j_load_state_dict(path), params)
    t = VisionTransformer(ViTConfig(distilled=distilled, **TARGET), dtype=torch.float32)
    init_weights(t, torch.Generator().manual_seed(1))
    report = timm_to_torch(load_state_dict(path), t)
    return j, params, jreport, t, report


def _assert_reports_equal(report, jreport):
    assert report["loaded"] == [_timm_name(p) for p in jreport["loaded"]]
    assert report["skipped"] == [_timm_name(p) for p in jreport["skipped"]]
    assert report["unconsumed"] == jreport["unconsumed"]


def _close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_teacher_import_matches_jax(tmp_path, fmt):
    state = _source_state()
    path = _write(tmp_path, state, fmt)
    j, params, jreport, t, report = _both_imports(path)
    _assert_reports_equal(report, jreport)
    assert report["skipped"] == ["head.weight", "head.bias", "head_dist.weight",
                                 "head_dist.bias"]
    assert all(f"blocks.{i}.{n}" in report["loaded"] for i in range(2)
               for n in ("norm1.weight", "attn.qkv.weight", "mlp.fc2.bias"))
    # values copied from the file, never shared with its tensors
    sd = t.state_dict()
    for k, v in state.items():
        if k.startswith(("blocks.", "norm.", "patch_embed", "cls_token", "dist_token")):
            assert torch.equal(sd[k], v), k
    loaded = load_state_dict(path)
    timm_to_torch(loaded, t)
    loaded["blocks.0.attn.qkv.weight"].add_(1.0)
    assert torch.equal(t.state_dict()["blocks.0.attn.qkv.weight"],
                       state["blocks.0.attn.qkv.weight"])
    # the same fresh heads on both sides, then the same logits
    heads = {k: v for k, v in flax_to_torch(params).items() if k.startswith("head")}
    t.load_state_dict({**t.state_dict(), **heads})
    _close(t.state_dict()["pos_embed"], flax_to_torch(params)["pos_embed"], 1e-5)
    x = np.random.RandomState(0).randn(4, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        logits = t(torch.from_numpy(x), train=False).logits
    _close(logits, j.apply({"params": params}, jnp.asarray(x), train=False).logits, 1e-4)


def test_source_without_dist_token_into_a_distilled_target(tmp_path):
    """A plain ViT checkpoint (one prefix token) into a distilled model: the
    CLS position embedding is duplicated for the DIST slot, dist_token keeps
    its initialisation, as in JAX."""
    path = _write(tmp_path, _source_state(distilled=False, seed=3), "pth")
    j, params, jreport, t, report = _both_imports(path, distilled=True)
    _assert_reports_equal(report, jreport)
    assert "dist_token" not in report["loaded"] and "pos_embed" in report["loaded"]
    pos = t.state_dict()["pos_embed"]
    assert pos.shape == (1, 2 + 16, 64) and torch.equal(pos[:, 0], pos[:, 1])
    _close(pos, flax_to_torch(params)["pos_embed"], 1e-5)


@pytest.mark.parametrize("prefix", [1, 2])
@pytest.mark.parametrize("grids", [(6, 4), (6, 7), (5, 5)])
def test_interpolate_pos_embed_matches_jax(prefix, grids):
    old, new = grids
    pe = np.random.RandomState(old * new + prefix).randn(1, prefix + old * old, 16)
    pe = pe.astype(np.float32)
    got = interpolate_pos_embed(torch.from_numpy(pe), prefix, new * new)
    want = j_interpolate_pos_embed(jnp.asarray(pe), prefix, new * new)
    assert got.shape == (1, prefix + new * new, 16)
    _close(got, want, 1e-5)
    with pytest.raises(ValueError):
        interpolate_pos_embed(torch.from_numpy(pe[:, :-1]), prefix, new * new + 1)


def test_load_state_dict_formats(tmp_path):
    state = {"a.weight": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    torch.save({"state_dict": state, "epoch": 1}, str(tmp_path / "w.pth"))
    np.save(str(tmp_path / "w.npy"), {k: v.numpy() for k, v in state.items()},
            allow_pickle=True)
    for name in ("w.pth", "w.npy"):
        got = load_state_dict(str(tmp_path / name))
        assert set(got) == set(state) and all(torch.equal(got[k], state[k]) for k in state)
    assert strip_module_prefix("module.blocks.0") == "blocks.0"
    assert strip_module_prefix("blocks.0") == "blocks.0"
    # an unwrapped file with an entry that is no tensor: loaded, unconsumed
    torch.save({"cls_token": torch.ones(1, 1, 64), "arch": "deit"}, str(tmp_path / "u.pth"))
    t = VisionTransformer(ViTConfig(**TARGET), dtype=torch.float32)
    report = timm_to_torch(load_state_dict(str(tmp_path / "u.pth")), t)
    assert report == {"loaded": ["cls_token"], "skipped": [], "unconsumed": ["arch"]}
    j = JViT(JViTConfig(**TARGET), dtype=jnp.float32)
    params = j.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)))["params"]
    assert timm_to_flax(j_load_state_dict(str(tmp_path / "u.pth")), params)[1] == {
        "loaded": ["cls_token"], "skipped": [], "unconsumed": ["arch"]}


def test_load_teacher_student_imports_the_checkpoint(tmp_path):
    """A distillation config with ``teacher_checkpoint`` builds without
    allow_random_teacher; the teacher holds the file's blocks, its heads
    (another class count) are skipped, its grid interpolated (4 x 4 -> 2 x 2
    at 32 px). Without the checkpoint the same config still raises."""
    src = VisionTransformer(ViTConfig(img_size=64, patch_size=16, embed_dim=384, depth=12,
                                      num_heads=6, num_classes=1000, distilled=True),
                            dtype=torch.float32)
    init_weights(src, torch.Generator().manual_seed(5))
    state = {k: v + 0.01 for k, v in src.state_dict().items()}
    path = _write(tmp_path, state, "pth")
    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224", dataset="cifar-10",
                      input_size=32, distillation_type="soft", teacher_checkpoint=path)
    teacher, student, aux = load_teacher_student(cfg, device="cpu")
    report = teacher.import_report
    assert report["skipped"] == ["head.weight", "head.bias", "head_dist.weight",
                                 "head_dist.bias"]
    assert report["unconsumed"] == []
    assert all(f"blocks.{i}.mlp.fc1.weight" in report["loaded"] for i in range(12))
    sd = teacher.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in state.items() if k.startswith("blocks."))
    assert sd["pos_embed"].shape == (1, 2 + 4, 384)
    assert not any(p.requires_grad for p in teacher.parameters())
    with pytest.raises(ValueError, match="teacher_checkpoint"):
        load_teacher_student(cfg.replace(teacher_checkpoint=None), device="cpu")
