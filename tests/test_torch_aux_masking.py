"""The port's aux heads and token masking (deltakd_tpu_torch/kd/aux.py,
kd/masking.py, models/convert.aux_flax_to_torch) against the JAX package's
kd/aux.py and kd/masking.py on the same weights and the same masking noise.

fp32 on the CPU; the linear and conv heads differ in summation order only
(1e-5 of the largest value), masking and index helpers are exact.
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

SD, TD = 24, 40
TYPES = ("wasskd", "mgd", "vitkd")


def _close(a, b, tol=1e-5):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= tol * np.max(np.abs(b))


def _heads(kd_type, seed=0):
    """JAX aux tree (mask_token moved off zero) and the port's module holding
    the same weights."""
    tree = jaux.init_aux_params(jax.random.PRNGKey(seed), kd_type, SD, TD)
    if "mask_token" in tree:
        tree["mask_token"] = tree["mask_token"] + 0.3
    heads = taux.AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(seed))
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
    tree, heads = _heads(kd_type, 1)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 16, SD).astype(np.float32)
    if kd_type == "wasskd":
        pairs = [(tree["align_wasskd"][i], heads.align_wasskd[i]) for i in range(3)]
    else:
        pairs = [(tree["align"], heads.align)]
        if kd_type == "vitkd":
            pairs += [(tree["align2"][i], heads.align2[i]) for i in range(2)]
    for jp, layer in pairs:
        _close(taux.dense(layer, torch.from_numpy(x)), jaux.dense(jp, jnp.asarray(x)))
    if kd_type != "wasskd":
        grid = rng.randn(3, 4, 4, TD).astype(np.float32)
        _close(taux.conv3x3(heads.generation.conv1, torch.from_numpy(grid)),
               jaux.conv3x3(tree["generation"]["conv1"], jnp.asarray(grid)))
        _close(taux.generation_apply(heads.generation, torch.from_numpy(grid)),
               jaux.generation_apply(tree["generation"], jnp.asarray(grid)))


@pytest.mark.parametrize("kd_type", TYPES)
def test_aux_init_and_decay_mask(kd_type):
    """Torch-default init from the generator (U(+-1/sqrt(fan_in)), zero mask
    token, reproducible), and the same weight-decay mask as the JAX package:
    kernels and the [1, 1, D] mask token decay, biases do not."""
    a = taux.AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(5))
    b = taux.AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(5))
    c = taux.AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(6))
    for (name, p), q, r in zip(a.state_dict().items(), b.state_dict().values(),
                              c.state_dict().values()):
        assert torch.equal(p, q)
        if name == "mask_token":
            assert float(p.abs().max()) == 0.0
            continue
        assert not torch.equal(p, r)
        fan_in = 9 * TD if "generation" in name else SD
        bound = 1.0 / np.sqrt(fan_in)
        assert float(p.abs().max()) <= bound
        if p.numel() > 500:
            assert float(p.abs().max()) > 0.9 * bound
            np.testing.assert_allclose(float(p.std()), bound / np.sqrt(3), rtol=0.1)
    tree = jaux.init_aux_params(jax.random.PRNGKey(0), kd_type, SD, TD)
    expect = {name.replace("kernel", "weight"): bool(v)
              for name, v in _leaves(j_wd_mask(tree))}
    student = torch.nn.Linear(2, 2)
    got = wd_mask(trainable_parameters(student, a))
    assert {k[len("aux."):]: v for k, v in got.items() if k.startswith("aux.")} == expect
    assert ("mask_token" not in expect) or expect["mask_token"] is True


@pytest.mark.parametrize("kd_type", ["lrkd", "diffkd", "curkd", "saliency_mgd"])
def test_unported_aux_heads_raise(kd_type):
    with pytest.raises(NotImplementedError):
        taux.AuxHeads(kd_type, SD, TD, torch.Generator().manual_seed(0))


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
