"""The port's fused attention (deltakd_tpu_torch/ops/attention.py) against the
JAX package's: ``flash_attention`` and its gradients against
``reference_attention`` and ``jax.grad`` of it, and the plain forward
``(o, lse)`` and the plain backward (the versions the CUDA kernels are held to)
against the Pallas kernel bodies ``_fwd_kernel`` / ``_bwd_kernel`` run by the
Pallas interpreter. The JAX wrappers pin their blocks to TPU memory, so the
test builds its own ``pl.pallas_call`` around the unchanged bodies.

fp32 on the CPU; differences are summation order only, so the tolerance is
1e-5 of the largest reference value. The kernels themselves run only on a
card (tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deltakd_tpu.ops import attention as jat
from deltakd_tpu_torch.ops import attention as tat

torch.set_num_threads(1)

TOL = 1e-5
SHAPES = [(2, 2, 10, 8), (1, 3, 20, 16), (2, 1, 7, 64)]
# the backward kernel's edges at head dim 64: one row, a 64-row tile and one
# row more, and the longest sequence the kernels take; then N = 50, under
# one 64-row tile, for three heads (the fp32 backward's tiles are per head)
KERNEL_LENGTHS = [(1, 2, 1, 64), (1, 2, 65, 64), (1, 1, 656, 64), (1, 3, 50, 64)]
# the fp32 forward kernel's edges at head dim 64 (it cuts the last 64-key
# chunk to its groups of 8 keys and gives a CTA 128 query rows): one group,
# a second 128-row tile of one row, the main path's N = 198 (two keys of
# padding in its one tail group) and a whole tail group
FORWARD_LENGTHS = [(1, 2, 8, 64), (1, 1, 129, 64), (1, 1, 198, 64), (1, 2, 200, 64)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    # q, k of std 2: scores spread over several units, the softmax is not flat
    q, k = (2.0 * rng.randn(*shape).astype(np.float32) for _ in range(2))
    v, do = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    return q, k, v, do


def _close(a, b, tol=TOL, floor=0.0):
    """max |a - b| <= tol * max(max |b|, floor); ``floor`` only where b is
    zero by its math and holds rounding alone."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), max(float(np.max(np.abs(b))), floor)
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def _pallas_fwd(q3, k3, v3):
    BH, N, D = q3.shape
    spec = pl.BlockSpec((1, N, D), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jat._fwd_kernel, scale=D ** -0.5), grid=(BH,),
        in_specs=[spec] * 3,
        out_specs=(spec, pl.BlockSpec((1, N, 1), lambda i: (i, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((BH, N, D), q3.dtype),
                   jax.ShapeDtypeStruct((BH, N, 1), jnp.float32)),
        interpret=True)(q3, k3, v3)


def _pallas_bwd(q3, k3, v3, o3, lse, do3):
    BH, N, D = q3.shape
    spec = pl.BlockSpec((1, N, D), lambda i: (i, 0, 0))
    return pl.pallas_call(
        functools.partial(jat._bwd_kernel, scale=D ** -0.5), grid=(BH,),
        in_specs=[spec] * 4 + [pl.BlockSpec((1, N, 1), lambda i: (i, 0, 0)), spec],
        out_specs=(spec,) * 3,
        out_shape=tuple(jax.ShapeDtypeStruct((BH, N, D), q3.dtype) for _ in range(3)),
        interpret=True)(q3, k3, v3, o3, lse, do3)


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_jax_reference(shape):
    q, k, v, _ = _inputs(shape)
    ref = jat.reference_attention(*map(jnp.asarray, (q, k, v)))
    _close(tat.flash_attention(*map(torch.from_numpy, (q, k, v))), ref)
    _close(tat.reference_attention(*map(torch.from_numpy, (q, k, v))), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_gradients_match_jax_grad(shape):
    q, k, v, do = _inputs(shape, 1)
    jg = jax.grad(lambda q, k, v: jnp.sum(jat.reference_attention(q, k, v) * do),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tg = torch.autograd.grad(tat.flash_attention(tq, tk, tv), [tq, tk, tv],
                             torch.from_numpy(do))
    for a, b in zip(tg, jg):
        _close(a, b)


@pytest.mark.parametrize("shape", SHAPES[:2] + FORWARD_LENGTHS)
def test_plain_forward_matches_interpreted_pallas_body(shape):
    q, k, v, _ = _inputs(shape, 2)
    B, H, N, D = shape
    q3, k3, v3 = (jnp.asarray(a.reshape(B * H, N, D)) for a in (q, k, v))
    j_o, j_lse = _pallas_fwd(q3, k3, v3)
    t_o, t_lse = tat._plain_fwd(*map(torch.from_numpy, (q, k, v)))
    assert t_o.shape == shape and t_lse.shape == shape[:-1]
    _close(t_o.reshape(B * H, N, D), j_o)
    _close(t_lse.reshape(B * H, N, 1), j_lse)
    # the kernels alone take [B*H, N, d] too
    o3, lse3 = tat._plain_fwd(*(torch.from_numpy(np.array(a)) for a in (q3, k3, v3)))
    _close(o3, j_o)
    assert lse3.shape == (B * H, N)


@pytest.mark.parametrize("shape", SHAPES[:2] + KERNEL_LENGTHS)
def test_plain_backward_matches_interpreted_pallas_body(shape):
    q, k, v, do = _inputs(shape, 3)
    B, H, N, D = shape
    q3, k3, v3, do3 = (jnp.asarray(a.reshape(B * H, N, D)) for a in (q, k, v, do))
    o3, lse = _pallas_fwd(q3, k3, v3)
    j_grads = _pallas_bwd(q3, k3, v3, o3, lse, do3)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    t_o, t_lse = tat._plain_fwd(tq, tk, tv)
    t_grads = tat._plain_bwd(tq, tk, tv, t_o, t_lse, tdo)
    # one key: p = 1 has no gradient, so dq and dk are zero up to rounding
    # on both sides (about 1e-7); they are held to 1e-5 of the largest dv
    floor = float(np.max(np.abs(np.asarray(j_grads[2])))) if N == 1 else 0.0
    for a, b, f in zip(t_grads, j_grads, (floor, floor, 0.0)):
        _close(a.reshape(B * H, N, D), b, floor=f)


def test_plain_backward_matches_autograd_and_cpu_reaches_no_kernel():
    q, k, v, do = _inputs((2, 2, 12, 8), 4)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    auto = torch.autograd.grad(tat.reference_attention(tq, tk, tv), [tq, tk, tv],
                               torch.from_numpy(do))
    tat.reset_launches()
    with torch.no_grad():
        o, lse = tat._plain_fwd(tq, tk, tv)
        plain = tat._plain_bwd(tq, tk, tv, o, lse, torch.from_numpy(do))
    fn = torch.autograd.grad(tat.flash_attention(tq, tk, tv), [tq, tk, tv],
                             torch.from_numpy(do))
    for a, b, c in zip(plain, fn, auto):
        _close(a, c)
        _close(b, c)
    assert not tat.LAUNCHES


def test_flash_attention_reads_views_of_a_packed_projection():
    """The model hands over strided [B, H, N, d] views of one qkv tensor."""
    rng = np.random.RandomState(5)
    B, N, H, D = 2, 9, 2, 8
    qkv = torch.from_numpy(rng.randn(B, N, 3, H, D).astype(np.float32)).requires_grad_(True)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert not q.is_contiguous()
    out = tat.flash_attention(q, k, v)
    ref = tat.reference_attention(q, k, v)
    _close(out, ref)
    do = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    (g,), (g_ref,) = (torch.autograd.grad(o, [qkv], do, retain_graph=True) for o in (out, ref))
    _close(g, g_ref)


def test_dispatch_is_by_device_and_kernels_refuse_what_they_do_not_take():
    assert tat.best_attention_fn(True) is tat.flash_attention
    assert tat.best_attention_fn(False) is None
    q = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError, match="no implementation for device"):
        tat.flash_attention(*(q.to("meta"),) * 3)
    with pytest.raises(ValueError, match=r"\[B, H, N, d\]"):
        tat.flash_attention(q[0], q[0], q[0])
    # the kernel wrappers never fall back to the plain version
    with pytest.raises(ValueError, match="CUDA bf16"):
        tat.kernel_flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA bf16"):
        tat.kernel_flash_bwd(q, q, q, q, torch.zeros(1, 2, 4), q)
