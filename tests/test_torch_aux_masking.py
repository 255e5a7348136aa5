"""The port's aux heads and token masking (deltakd_tpu_torch/kd/aux.py,
kd/masking.py, models/convert.aux_flax_to_torch) against the JAX package's
kd/aux.py and kd/masking.py on the same weights and the same masking noise,
for the aux trees of all seven feature types (saliency_mgd with the ``qk``
head of methods 1 and 2 and the ``q``, ``k`` heads of method 3): every
linear and conv head, DiffKD's denoiser with the JAX dropout draw, the three
saliency attention-score functions and saliency masking.

fp32 on the CPU; the linear and conv heads, the denoiser and the attention
scores differ in summation order only (1e-5 of the largest value), masking
and index helpers are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.kd import aux as jaux
from deltakd_tpu.kd import masking as jmask
from deltakd_tpu.train.optim import wd_mask as j_wd_mask
from deltakd_tpu_torch.kd import aux as taux
from deltakd_tpu_torch.kd import masking as tmask
from deltakd_tpu_torch.models.convert import aux_flax_to_torch
from deltakd_tpu_torch.train.optim import wd_mask
from deltakd_tpu_torch.train.state import trainable_parameters

torch.set_num_threads(1)

SD, TD, RANK = 24, 40, 8
TYPES = ("wasskd", "mgd", "vitkd", "lrkd", "diffkd", "curkd", "saliency_mgd",
         "saliency_mgd-3")


def _kw(case):
    """(distillation type, the aux-tree options) of a case name."""
    kd_type, _, method = case.partition("-")
    return kd_type, dict(lrkd_rank=RANK, saliency_method=int(method or 1))


def _close(a, b, tol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(b))


def _heads(case, seed=0):
    """JAX aux tree (mask_token moved off zero) and the port's module holding
    the same weights."""
    kd_type, kw = _kw(case)
    tree = jaux.init_aux_params(jax.random.PRNGKey(seed), kd_type, SD, TD, **kw)
    if "mask_token" in tree:
        tree["mask_token"] = tree["mask_token"] + 0.3
    heads = taux.AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(seed), **kw)
    heads.load_state_dict(aux_flax_to_torch(tree), strict=True)
    return tree, heads


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("kd_type", TYPES)
def test_aux_flax_to_torch_round_trip(kd_type):
    """Every leaf of the JAX tree lands under its own key (kernel -> weight,
    transposed) and comes back unchanged."""
    tree, heads = _heads(kd_type)
    sd = heads.state_dict()
    leaves = dict(_leaves(tree))
    assert len(sd) == len(leaves)
    for name, leaf in leaves.items():
        p = sd[name.replace("kernel", "weight")].numpy()
        if name.endswith("kernel"):
            p = p.T if p.ndim == 2 else p.transpose(2, 3, 1, 0)   # back to [in,out] / HWIO
        np.testing.assert_array_equal(p, leaf, err_msg=name)


@pytest.mark.parametrize("kd_type", TYPES)
def test_dense_and_generation_match_jax(kd_type):
    """Every linear head of the tree on [3, 16, in] inputs, and the
    generation head's convs on an NHWC grid."""
    tree, heads = _heads(kd_type, 1)
    rng = np.random.RandomState(2)
    linears = [name[:-len(".kernel")] for name, leaf in _leaves(tree)
               if name.endswith("kernel") and leaf.ndim == 2]
    assert len(linears) == sum(isinstance(m, torch.nn.Linear) for m in heads.modules())
    for name in linears:
        jp = tree
        for part in name.split("."):
            jp = jp[int(part)] if isinstance(jp, list) else jp[part]
        x = rng.randn(3, 16, jp["kernel"].shape[0]).astype(np.float32)
        _close(taux.dense(heads.get_submodule(name), torch.from_numpy(x)),
               jaux.dense(jp, jnp.asarray(x)))
    if "generation" in tree:
        grid = rng.randn(3, 4, 4, TD).astype(np.float32)
        _close(taux.conv3x3(heads.generation.conv1, torch.from_numpy(grid)),
               jaux.conv3x3(tree["generation"]["conv1"], jnp.asarray(grid)))
        _close(taux.generation_apply(heads.generation, torch.from_numpy(grid)),
               jaux.generation_apply(tree["generation"], jnp.asarray(grid)))


# fan-in of each head's init bound, by name prefix (the align layers: SD)
FAN_IN = {"generation": 9 * TD, "denoise.net1": TD, "denoise.net2": 2 * TD,
          "denoise.time1": 1, "denoise.time2": TD, "saliency_attn": TD}


@pytest.mark.parametrize("kd_type", TYPES)
def test_aux_init_and_decay_mask(kd_type):
    """Torch-default init from the generator (U(+-1/sqrt(fan_in)), zero mask
    token, reproducible), and the same weight-decay mask as the JAX package:
    kernels and the [1, 1, D] mask token decay, biases and the saliency
    attention do not."""
    kd, kw = _kw(kd_type)
    a = taux.AuxHeads(kd, SD, TD, torch.Generator().manual_seed(5), **kw)
    b = taux.AuxHeads(kd, SD, TD, torch.Generator().manual_seed(5), **kw)
    c = taux.AuxHeads(kd, SD, TD, torch.Generator().manual_seed(6), **kw)
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                              c.state_dict().values()):
        assert torch.equal(p, q)
        if name == "mask_token":
            assert float(p.abs().max()) == 0.0
            continue
        assert not torch.equal(p, r)
        fan_in = next((v for k, v in FAN_IN.items() if name.startswith(k)), SD)
        bound = 1.0 / np.sqrt(fan_in)
        assert float(p.abs().max()) <= bound
        if p.numel() > 500:
            assert float(p.abs().max()) > 0.9 * bound
            np.testing.assert_allclose(float(p.std()), bound / np.sqrt(3), rtol=0.1)
    tree = jaux.init_aux_params(jax.random.PRNGKey(0), kd, SD, TD, **kw)
    expect = {name.replace("kernel", "weight"): bool(v)
              for name, v in _leaves(j_wd_mask(tree))}
    student = torch.nn.Linear(2, 2)
    got = wd_mask(trainable_parameters(student, a))
    assert {k[len("aux."):]: v for k, v in got.items() if k.startswith("aux.")} == expect
    assert ("mask_token" not in expect) or expect["mask_token"] is True


def test_aux_heads_reject_what_has_none():
    for kd_type, kw in (("soft", {}), ("none", {}), ("saliency_mgd", dict(saliency_method=4))):
        with pytest.raises(ValueError):
            taux.AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(0), **kw)


@pytest.mark.parametrize("train", [True, False])
def test_denoise_apply_matches_jax(train):
    """DiffKD's denoiser on [B, L, TD] with integer timesteps; in training
    the Dropout(0.1) keep mask is the JAX key's bernoulli draw."""
    tree, heads = _heads("diffkd", 3)
    rng = np.random.RandomState(4)
    x = rng.randn(4, 16, TD).astype(np.float32)
    t = np.array([0, 3, 7, 5])
    key = jax.random.PRNGKey(11)
    j = jaux.denoise_apply(tree["denoise"], jnp.asarray(x), jnp.asarray(t), key, train)
    keep = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.9, x.shape)))
    out = taux.denoise_apply(heads.denoise, torch.from_numpy(x), torch.from_numpy(t),
                             train=train, keep=keep)
    _close(out, j)
    assert float(out.abs().min() == 0) == float(train)
    # the keep mask drawn from a generator: reproducible, about 10% dropped
    a = taux.denoise_apply(heads.denoise, torch.from_numpy(x), torch.from_numpy(t),
                           torch.Generator().manual_seed(0), train)
    b = taux.denoise_apply(heads.denoise, torch.from_numpy(x), torch.from_numpy(t),
                           torch.Generator().manual_seed(0), train)
    assert torch.equal(a, b)
    if train:
        assert 0.05 < float((a == 0).float().mean()) < 0.15


def test_attention_scores_match_jax():
    """The three saliency attention-score functions with 8 heads of 5."""
    rng = np.random.RandomState(5)
    x = rng.randn(3, 17, TD).astype(np.float32)
    tree, heads = _heads("saliency_mgd", 6)
    p, jp = heads.saliency_attn, tree["saliency_attn"]
    for diagonal in (True, False):
        _close(taux.simple_attention_scores(p, torch.from_numpy(x), diagonal=diagonal),
               jaux.simple_attention_scores(jp, jnp.asarray(x), diagonal=diagonal))
    _close(taux.simple_attention_cls_row(p, torch.from_numpy(x)),
           jaux.simple_attention_cls_row(jp, jnp.asarray(x)))
    tree, heads = _heads("saliency_mgd-3", 6)
    _close(taux.cross_attention_scores(heads.saliency_attn, torch.from_numpy(x[:, :1]),
                                       torch.from_numpy(x[:, 1:])),
           jaux.cross_attention_scores(tree["saliency_attn"], jnp.asarray(x[:, :1]),
                                       jnp.asarray(x[:, 1:])))


@pytest.mark.parametrize("method", [1, 2, 3])
def test_saliency_masking_matches_jax(method):
    """Kept tokens, mask and restore order from the teacher's [CLS, DIST,
    16 patches] features; then the same from pinned scores with ties (both
    argsorts stable)."""
    tree, heads = _heads(f"saliency_mgd-{method}", 7)
    rng = np.random.RandomState(8)
    t_feat = rng.randn(4, 2 + 16, TD).astype(np.float32)
    s_feat = rng.randn(4, 16, TD).astype(np.float32)
    j = jmask.saliency_masking(tree, jnp.asarray(t_feat), jnp.asarray(s_feat), 0.4, method)
    got = tmask.saliency_masking(heads.saliency_attn, torch.from_numpy(t_feat),
                                 torch.from_numpy(s_feat), 0.4, method)
    assert got[0].shape == (4, int(16 * 0.6), TD)
    for a, b in zip(got, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tied = np.round(rng.rand(4, 16) * 3) / 3
    j = jmask._keep_lowest(jnp.asarray(tied), jnp.asarray(s_feat), 9)
    got = tmask.saliency_masking(None, None, torch.from_numpy(s_feat), 0.4, method,
                                 scores=torch.from_numpy(tied))
    for a, b in zip(got, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tmask.saliency_scores(heads.saliency_attn, torch.from_numpy(t_feat), 4)


@pytest.mark.parametrize("ratio", [0.5, 0.75, 0.3])
def test_random_masking_matches_jax_on_the_same_noise(ratio):
    B, L, D = 4, 16, 8
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.uniform(key, (B, L)))
    x = np.random.RandomState(4).randn(B, L, D).astype(np.float32)
    j_keep, j_mask, j_restore, j_masked = jmask.random_masking(key, jnp.asarray(x), ratio)
    t_keep, t_mask, t_restore, t_masked = tmask.random_masking(
        None, torch.from_numpy(x), ratio, noise=torch.from_numpy(noise))
    assert t_keep.shape[1] == int(L * (1 - ratio))
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(t_restore.numpy(), np.asarray(j_restore))
    np.testing.assert_array_equal(t_masked.numpy(), np.asarray(j_masked))
    # tied noise: both argsorts are stable
    tied = np.round(noise * 4) / 4
    ids = jnp.argsort(jnp.asarray(tied), axis=1)
    _, _, t_restore, _ = tmask.random_masking(None, torch.from_numpy(x), ratio,
                                              noise=torch.from_numpy(tied))
    np.testing.assert_array_equal(t_restore.numpy(), np.asarray(jnp.argsort(ids, axis=1)))


def test_random_masking_draws_from_the_generator():
    x = torch.zeros(3, 16, 2)
    a = tmask.random_masking(torch.Generator().manual_seed(0), x, 0.5)
    b = tmask.random_masking(torch.Generator().manual_seed(0), x, 0.5)
    c = tmask.random_masking(torch.Generator().manual_seed(1), x, 0.5)
    assert torch.equal(a[2], b[2]) and not torch.equal(a[2], c[2])
    assert a[1].sum(1).tolist() == [8.0] * 3


def test_fill_restore_and_grid_match_jax():
    B, L, D, keep = 3, 16, 6, 7
    rng = np.random.RandomState(8)
    x_keep = rng.randn(B, keep, D).astype(np.float32)
    token = rng.randn(1, 1, D).astype(np.float32)
    restore = np.stack([rng.permutation(L) for _ in range(B)])
    j = jmask.fill_and_restore(jnp.asarray(x_keep), jnp.asarray(restore), jnp.asarray(token))
    t = tmask.fill_and_restore(torch.from_numpy(x_keep), torch.from_numpy(restore),
                               torch.from_numpy(token))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    grid = tmask.tokens_to_grid(t)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jmask.tokens_to_grid(j)))
    assert grid.shape == (B, 4, 4, D)
    assert torch.equal(tmask.grid_to_tokens(grid), t)
