"""The port's fused MLP (deltakd_tpu_torch/ops/fused_mlp.py) against the JAX
package's: the forward against ``reference_mlp``, the gradients of
``fused_mlp_train`` for all five operands against ``jax.grad`` of it, and the
plain forward and backward (the versions the CUDA kernels are held to) against
the Pallas kernel bodies ``_mlp_kernel`` / ``_mlp_bwd_kernel`` run by the
Pallas interpreter over a two-tile grid (the JAX wrappers pin their blocks to
TPU memory, so the test builds its own ``pl.pallas_call`` around the unchanged
bodies, accumulation across grid steps included).

The port takes nn.Linear's [out, in] weights, the JAX functions [in, out]: the
tests hand each its layout. fp32 on the CPU; tolerance 1e-5 of the largest
reference value (summation order, and erf against the TPU body's polynomial
erf, which is within 1.5e-7 of it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deltakd_tpu.ops import fused_mlp as jfm
from deltakd_tpu_torch.ops import fused_mlp as tfm

torch.set_num_threads(1)

TOL = 1e-5
D, F = 16, 64


def _inputs(lead, seed=0):
    """x [*lead, D], weights of std 1/sqrt(fan-in) in the port's layout,
    biases, and a cotangent."""
    rng = np.random.RandomState(seed)
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    x, dy = f32(rng.randn(*lead, D)), f32(rng.randn(*lead, D))
    w1, b1 = f32(rng.randn(F, D) / np.sqrt(D)), f32(0.1 * rng.randn(F))
    w2, b2 = f32(rng.randn(D, F) / np.sqrt(F)), f32(0.1 * rng.randn(D))
    return x, w1, b1, w2, b2, dy


def _jax_operands(x, w1, b1, w2, b2):
    return tuple(map(jnp.asarray, (x, w1.T, b1, w2.T, b2)))


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def _tile_specs(tile):
    row = pl.BlockSpec((tile, D), lambda i: (i, 0))
    whole = lambda *shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))  # noqa: E731
    return row, whole


def _pallas_fwd(x2, w1, b1, w2, b2, tile):
    row, whole = _tile_specs(tile)
    return pl.pallas_call(
        jfm._mlp_kernel, grid=(x2.shape[0] // tile,),
        in_specs=[row, whole(D, F), whole(1, F), whole(F, D), whole(1, D)],
        out_specs=row, out_shape=jax.ShapeDtypeStruct(x2.shape, x2.dtype),
        interpret=True)(x2, w1, b1.reshape(1, F), w2, b2.reshape(1, D))


def _pallas_bwd(x2, w1, b1, w2, dy2, tile):
    row, whole = _tile_specs(tile)
    f32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    return pl.pallas_call(
        jfm._mlp_bwd_kernel, grid=(x2.shape[0] // tile,),
        in_specs=[row, whole(D, F), whole(1, F), whole(F, D), row],
        out_specs=(row, whole(D, F), whole(1, F), whole(F, D), whole(1, D)),
        out_shape=(jax.ShapeDtypeStruct(x2.shape, x2.dtype), f32(D, F), f32(1, F),
                   f32(F, D), f32(1, D)),
        interpret=True)(x2, w1, b1.reshape(1, F), w2, dy2)


@pytest.mark.parametrize("lead", [(16,), (37,), (3, 11), (2, 3, 5)])
def test_forward_matches_jax_reference(lead):
    """Any leading shape, row counts that no tile divides."""
    x, w1, b1, w2, b2, _ = _inputs(lead)
    ref = jfm.reference_mlp(*_jax_operands(x, w1, b1, w2, b2))
    ops = tuple(map(torch.from_numpy, (x, w1, b1, w2, b2)))
    _close(tfm.fused_mlp(*ops), ref)
    _close(tfm.fused_mlp_train(*ops), ref)
    _close(tfm.reference_mlp(*ops), ref)


def test_plain_forward_matches_interpreted_pallas_body():
    x, w1, b1, w2, b2, _ = _inputs((16,), 1)
    j_out = _pallas_fwd(*_jax_operands(x, w1, b1, w2, b2), tile=8)
    _close(tfm._plain_fwd(*map(torch.from_numpy, (x, w1, b1, w2, b2))), j_out)


def test_plain_backward_matches_interpreted_pallas_body():
    """dx per tile and the fp32 sums over both tiles of the sequential grid."""
    x, w1, b1, w2, b2, dy = _inputs((16,), 2)
    jx, jw1, jb1, jw2, _ = _jax_operands(x, w1, b1, w2, b2)
    j_dx, j_dw1, j_db1, j_dw2, j_db2 = _pallas_bwd(jx, jw1, jb1, jw2, jnp.asarray(dy), tile=8)
    dx, dw1, db1, dw2, db2 = tfm._plain_bwd(*map(torch.from_numpy, (x, w1, b1, w2, dy)))
    _close(dx, j_dx)
    _close(dw1, np.asarray(j_dw1).T)
    _close(db1, np.asarray(j_db1)[0])
    _close(dw2, np.asarray(j_dw2).T)
    _close(db2, np.asarray(j_db2)[0])


@pytest.mark.parametrize("lead", [(37,), (3, 11)])
def test_train_gradients_match_jax_grad(lead):
    x, w1, b1, w2, b2, dy = _inputs(lead, 3)
    jg = jax.grad(lambda *ops: jnp.sum(jfm.reference_mlp(*ops) * dy),
                  argnums=(0, 1, 2, 3, 4))(*_jax_operands(x, w1, b1, w2, b2))
    ops = [torch.from_numpy(a).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    tg = torch.autograd.grad(tfm.fused_mlp_train(*ops), ops, torch.from_numpy(dy))
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, np.asarray(b).T if i in (1, 3) else b)


def test_plain_backward_matches_autograd_and_cpu_reaches_no_kernel():
    x, w1, b1, w2, b2, dy = _inputs((37,), 4)
    ops = [torch.from_numpy(a).requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    auto = torch.autograd.grad(tfm.reference_mlp(*ops), ops, torch.from_numpy(dy))
    tfm.reset_launches()
    with torch.no_grad():
        plain = tfm._plain_bwd(*ops[:4], torch.from_numpy(dy))
    for a, b in zip(plain, auto):
        _close(a, b)
    assert not tfm.LAUNCHES


def test_fused_mlp_is_forward_only():
    x, w1, b1, w2, b2, _ = _inputs((5,), 5)
    ops = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    ops[1].requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        tfm.fused_mlp(*ops)
    with torch.no_grad():
        out = tfm.fused_mlp(*ops)
    assert not out.requires_grad
    assert tfm.fused_mlp_train(*ops).requires_grad


def test_dispatch_is_by_device_and_kernels_refuse_what_they_do_not_take():
    assert tfm.best_mlp_fn(True) is tfm.fused_mlp and tfm.best_mlp_fn(False) is None
    assert tfm.best_train_mlp_fn(True) is tfm.fused_mlp_train
    assert tfm.best_train_mlp_fn(False) is None
    x, w1, b1, w2, b2, dy = (torch.from_numpy(a) for a in _inputs((5,), 6))
    with pytest.raises(ValueError, match="no implementation for device"):
        tfm.fused_mlp(x.to("meta"), w1, b1, w2, b2)
    # the kernel wrappers never fall back to the plain version (fp32 CPU x:
    # the forward and the backward, which have fp32 forms, refuse the device;
    # fp16 x, which neither takes, the dtype)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tfm.kernel_fused_mlp(x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tfm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy)
    with pytest.raises(ValueError, match="x must be torch.bfloat16 or torch.float32"):
        tfm.kernel_fused_mlp_bwd(x.half(), w1, b1, w2, dy.half())
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tfm.kernel_fused_mlp_bwd(x.bfloat16(), w1, b1, w2, dy.bfloat16())


def test_two_plain_linears_compose_to_the_plain_forward():
    """The yardstick `[mlp two-gemm]` of the forward kernel: the block GEMM's
    plain version with GELU, then without, on bf16 operands and bf16-rounded
    biases, is the plain forward the kernel is held to, bit for bit."""
    from deltakd_tpu_torch.ops.fused_block import plain_linear

    x, w1, b1, w2, b2, _ = (torch.from_numpy(a) for a in _inputs((37,), 7))
    x, w1, w2 = x.bfloat16(), w1.bfloat16(), w2.bfloat16()
    b1, b2 = b1.bfloat16().float(), b2.bfloat16().float()
    h = plain_linear(x, w1, b1, gelu=True)[1]
    out = plain_linear(h, w2, b2)[1]
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tfm._plain_fwd(x, w1, b1, w2, b2))


@pytest.mark.parametrize("D", [192, 384, 768, 1024])
def test_forward_plan_covers_every_model_width(D):
    """Every width of the model zoo, with F = 4D, is taken by the forward
    kernel (its entry point picks the plan: D = 192 one warpgroup, 384 and
    768 two of 192 columns, 1024 two of 128)."""
    from deltakd_tpu_torch.models.registry import MODEL_REGISTRY

    assert D in {cfg.embed_dim for cfg in MODEL_REGISTRY.values()}
    assert tfm.forward_takes(D, 4 * D)


@pytest.mark.parametrize("D,F", [(192, 192), (192, 64), (384, 192), (768, 192),
                                 (576, 320), (256, 384), (192, 96), (192, 32), (384, 96)])
def test_forward_kernel_takes_the_tensor_parallel_shards(D, F):
    """A model rank's hidden shard F/M: a multiple of 32 where D is a
    multiple of 192 (one warpgroup's plan, hidden chunks of 64 and a 32-wide
    tail: DeiT-Ti at a model axis of 8, DeiT-S at 16), of 128 otherwise; the
    fp32 form takes multiples of 16."""
    assert tfm.forward_takes(D, F)
    assert tfm.forward_takes(D, F, torch.float32)
    assert not tfm.forward_takes(D, 40, torch.float32)


@pytest.mark.parametrize("D,F", [(64, 256), (80, 320), (192, 784), (1536, 6144),
                                 (2048, 8192), (256, 320), (192, 48)])
def test_forward_kernel_refuses_widths_without_a_plan(D, F):
    """D not a multiple of 192 or 256, F not a multiple of 32 (DeiT-Ti at a
    model axis of 16: 48), nor of 128 where D is not a multiple of 192), D
    wider than
    1024 (an x tile that leaves no room in shared memory): ValueError before
    anything is launched or allocated, on any device, and no fall-back to the
    plain version."""
    assert not tfm.forward_takes(D, F)
    x = torch.zeros(3, D, dtype=torch.bfloat16)
    w1, w2 = torch.empty(F, D, dtype=torch.bfloat16), torch.empty(D, F, dtype=torch.bfloat16)
    b1, b2 = torch.zeros(F), torch.zeros(D)
    tfm.reset_launches()
    with pytest.raises(ValueError, match="takes no width"):
        tfm.kernel_fused_mlp(x, w1, b1, w2, b2)
    assert not tfm.LAUNCHES
    # the dispatch still gives a CPU tensor the plain version, whatever its width
    if D <= 192:
        assert tfm.fused_mlp(x, w1.normal_(), b1, w2.normal_(), b2).shape == x.shape
