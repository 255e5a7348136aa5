"""The port's WassKD-sinkhorn solver (deltakd_tpu_torch/kd/sinkhorn.py) and
LRKD's spectral targets (kd/losses.py `rank_k_targets` with both solvers,
`lrkd_targets`, `_canon_sign`) against the JAX package's on the same inputs.

fp32 on the CPU. Divergences and spectral targets hold to 1e-5 of the
largest value. The divergence's gradients hold to 1e-3: they weight each
cost by exp(-C / eps), eps = 0.0025, so one fp32 rounding of |x|^2 moves a
weight by |x|^2 * 6e-8 / eps, and the two packages round the cross product
differently (the port forms it in fp64). The targets are held on a planted
spectrum whose top singular values stand well apart: the eigenvectors of a
random Gram matrix's bulk are ill-conditioned, and the subspace solver starts
from another random block than the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.kd import losses as jlosses
from deltakd_tpu.kd import sinkhorn as jsk
from deltakd_tpu_torch.kd import losses as tlosses
from deltakd_tpu_torch.kd import sinkhorn as tsk

torch.set_num_threads(1)

TOL, GRAD_TOL = 1e-5, 1e-3


def _close(a, b, tol=TOL, what=""):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    err, scale = np.max(np.abs(a - b)), np.max(np.abs(b))
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("batched", [False, True])
def test_sinkhorn_divergence_and_gradients_match_jax(batched):
    """One problem with N != M, or three problems at [3, 16, 40]; the
    gradients of a weighted sum of the divergences."""
    rng = np.random.RandomState(0)
    if batched:
        x = (0.5 * rng.randn(3, 16, 40)).astype(np.float32)
        y = (0.5 * rng.randn(3, 16, 40) + 0.2).astype(np.float32)
        w = np.array([1.0, 2.0, 3.0], np.float32)
        j_fn = lambda a, b: jnp.sum(jsk.batched_sinkhorn_divergence(a, b) * w)  # noqa: E731
        t_fn = tsk.batched_sinkhorn_divergence
    else:
        x = rng.randn(16, 8).astype(np.float32)
        y = (rng.randn(12, 8) + 0.5).astype(np.float32)
        w = np.float32(1.0)
        j_fn = jsk.sinkhorn_divergence
        t_fn = tsk.sinkhorn_divergence
    j_val, (j_gx, j_gy) = jax.value_and_grad(j_fn, argnums=(0, 1))(jnp.asarray(x),
                                                                    jnp.asarray(y))
    tx, ty = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    div = t_fn(tx, ty)
    assert div.shape == ((3,) if batched else ())
    total = (div * torch.from_numpy(np.asarray(w))).sum()
    total.backward()
    _close(total, j_val, what="divergence")
    _close(tx.grad, j_gx, GRAD_TOL, "dx")
    _close(ty.grad, j_gy, GRAD_TOL, "dy")


def test_sinkhorn_divergence_properties():
    """Zero at x = y, positive apart; a batched solve equals its problems
    solved one by one; the solve takes no gradient; bf16 inputs are solved
    in fp32."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(2, 12, 6).astype(np.float32))
    y = torch.from_numpy(rng.randn(2, 12, 6).astype(np.float32) + 0.3)
    same = tsk.batched_sinkhorn_divergence(x, x)
    assert float(same.abs().max()) < 1e-4 * float(tsk.batched_sinkhorn_divergence(x, y).min())
    both = tsk.batched_sinkhorn_divergence(x, y)
    assert float(both.min()) > 0
    for i in range(2):
        _close(tsk.sinkhorn_divergence(x[i], y[i]), both[i], 1e-6)
    pots = tsk._solve_scan(x.requires_grad_(True), y, 0.0025, 20, 6)
    assert not any(p.requires_grad for p in pots)
    half = tsk.batched_sinkhorn_divergence(x.detach().bfloat16(), y.bfloat16())
    assert half.dtype == torch.float32
    _close(half, tsk.batched_sinkhorn_divergence(x.detach().bfloat16().float(),
                                                 y.bfloat16().float()), 0.0)


def test_eps_schedule_matches_jax():
    diam = np.array([40.0, 0.001, 3.5], np.float32)
    got = tsk._eps_schedule(torch.from_numpy(diam), 0.0025, 20, 6)
    for i, d in enumerate(diam):
        _close(got[i], jsk._eps_schedule(jnp.asarray(d), 0.0025, 20, 6), 2e-6)


def _planted(M, D, top, seed):
    """A [M, D] matrix U diag(s) V^T whose first ``top`` singular values fall
    geometrically from 40 by a factor 0.85 a step, and the rest lie in
    [0.1, 1]."""
    rng = np.random.RandomState(seed)
    u = np.linalg.qr(rng.randn(M, D))[0]
    v = np.linalg.qr(rng.randn(D, D))[0]
    s = np.concatenate([40.0 * 0.85 ** np.arange(top), rng.uniform(0.1, 1.0, D - top)])
    return (u * s) @ v.T


@pytest.mark.parametrize("solver", ["eigh", "subspace"])
def test_rank_k_targets_match_jax(solver):
    a = _planted(200, 40, 10, 2).astype(np.float32)
    j = jlosses.rank_k_targets(jnp.asarray(a), 8, solver=solver)
    got = tlosses.rank_k_targets(torch.from_numpy(a), 8, solver=solver)
    _close(got, j)
    # the other solver; the exact SVD's U_k diag(S_k) up to column signs
    _close(got, tlosses.rank_k_targets(torch.from_numpy(a), 8,
                                       solver="eigh" if solver == "subspace" else "subspace"))
    u, s, _ = np.linalg.svd(a.astype(np.float64), full_matrices=False)
    _close(np.abs(got.numpy()), np.abs(u[:, :8] * s[:8]))


def test_subspace_eigvecs_match_jax_batched():
    """[3, D, D] Gram matrices of planted spectra: the top-8 eigenvectors,
    signs made canonical, against the JAX solver's and against eigh."""
    grams = np.stack([(a.T @ a) for a in (_planted(150, 32, 10, s) for s in (3, 4, 5))])
    grams = grams.astype(np.float32)
    got = tlosses.topk_eigvecs_subspace(torch.from_numpy(grams), 8)
    _close(got, jlosses.topk_eigvecs_subspace(jnp.asarray(grams), 8))
    vecs = torch.linalg.eigh(torch.from_numpy(grams))[1]
    _close(got, tlosses._canon_sign(vecs.flip(-1)[..., :8]))


def test_lrkd_targets_are_per_layer_rank_k_targets():
    """lrkd_targets' batched eigh of blocks 0, 1 and the last is
    rank_k_targets of each, and it matches the JAX package's on the same
    planted features; ||targets||^2 is the sum of the top-k eigenvalues."""
    B, N, D, tp = 4, 50, 32, 2
    feats = [_planted(B * N, D, 10, 6 + i).reshape(B, N, D) for i in range(4)]
    feats = [np.concatenate([np.zeros((B, tp, D)), f], 1).astype(np.float32) for f in feats]
    kd = tlosses.KDSettings(distillation_type="lrkd", lrkd_rank=8, teacher_prefix=tp)
    got = tlosses.lrkd_targets(kd, [torch.from_numpy(f) for f in feats])
    assert got.shape == (3, B * N, 8)
    for row, i in enumerate((0, 1, 3)):
        a = feats[i][:, tp:].reshape(-1, D)
        _close(got[row], tlosses.rank_k_targets(torch.from_numpy(a), 8), 1e-6)
        _close(got[row], jlosses.rank_k_targets(jnp.asarray(a), 8))
        top = np.linalg.eigvalsh(a.astype(np.float64).T @ a)[::-1][:8]
        np.testing.assert_allclose(float((got[row].double() ** 2).sum()), top.sum(), rtol=1e-5)


def test_canon_sign_matches_jax():
    rng = np.random.RandomState(9)
    v = rng.randn(2, 6, 4).astype(np.float32)
    v[0, :, 1] = 0.0                          # a zero column keeps its sign
    v[1, 2, 2], v[1, 4, 2] = 5.0, -5.0        # tied largest magnitudes cancel
    np.testing.assert_array_equal(tlosses._canon_sign(torch.from_numpy(v)).numpy(),
                                  np.asarray(jlosses._canon_sign(jnp.asarray(v))))
