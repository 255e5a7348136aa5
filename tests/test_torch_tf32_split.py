"""The plain version of the fp32 linear GEMM's weight split
(deltakd_tpu_torch/ops/fused_block.py ``tf32_split``, the function the card's
``split_weights_tf32_kernel`` and the backward's fp32 transpose are held to
bit for bit), against a numpy reference written from the definition of TF32
rounding, and the 3xTF32 product on its permuted operands against the JAX
package's interpreted Pallas kernels.

- hi = TF32(v) rounded to nearest, ties away from zero (the card's
  cvt.rna.tf32.f32), bit for bit: random values, exact ties at bit 13, +-0,
  subnormals, values that round up into the next binade; inf and NaN pass
  through. lo = TF32(v - hi) bit for bit; |v - hi - lo| <= 2^-21 |v|.
- Within each k-step of 8, column j holds k = 2 (j % 4) + j // 4; its
  inverse restores the weight.
- The product a_lo w_hi + a_hi w_lo + a_hi w_hi on the permuted operands,
  in fp64, is the unpermuted one (summation order only: 1e-12 of the
  largest value). Run through the fp32 MLP forward and the fp32 block's
  four linear products (D = 64, N = 10, two heads), it agrees with the
  interpreted Pallas bodies ``_mlp_kernel`` and ``_fwd_kernel`` to 1e-5 of
  the largest value (their fp32 products against 3xTF32's ~2^-21 operands).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deltakd_tpu.models.vit import Block
from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu.ops import fused_mlp as jfm
from deltakd_tpu_torch.models.convert import flax_block_to_torch
from deltakd_tpu_torch.ops import fused_block as fb

torch.set_num_threads(1)

TOL = 1e-5
D, N, H, B = 64, 10, 2, 2


def _np_tf32_rna(v):
    """fp32 v rounded to nearest TF32 (10 explicit mantissa bits), ties away
    from zero, from the definition: the magnitude in units of the TF32 quantum
    of its binade (2^(e - 10) for 2^e <= |v| < 2^(e + 1), 2^-136 below the
    normal range) rounded half up, in fp64 (exact); inf and NaN as they
    are."""
    v = np.asarray(v, np.float32)
    out = v.copy()
    fin = np.isfinite(v)
    x = v[fin].astype(np.float64)
    _, e = np.frexp(np.abs(x))          # |x| = m 2^e, m in [0.5, 1)
    q = np.ldexp(1.0, np.maximum(e - 1, -126) - 10)
    out[fin] = np.copysign(np.floor(np.abs(x) / q + 0.5) * q, x).astype(np.float32)
    return out


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _values():
    """[R, 8] fp32 values of every kind the split must round as the card
    does."""
    rng = np.random.RandomState(0)
    rand = (rng.randn(64) * 10.0 ** rng.randint(-20, 20, 64)).astype(np.float32)
    base = rng.randint(0, 1 << 23, 32).astype(np.uint32) & ~np.uint32(0x1FFF)
    exps = rng.randint(1, 254, 32).astype(np.uint32) << 23
    ties = (exps | base | 0x1000).view(np.float32)                 # low 13 bits exactly half
    sub = (rng.randint(1, 1 << 23, 32).astype(np.uint32)).view(np.float32)   # subnormals
    sub_ties = ((rng.randint(0, 1 << 10, 8).astype(np.uint32) << 13) | 0x1000).view(np.float32)
    # the top 10 mantissa bits all ones and the rest at least half: into the next binade
    carry = ((rng.randint(1, 254, 16).astype(np.uint32) << 23) | 0x7FE000
             | rng.randint(0x1000, 0x2000, 16).astype(np.uint32)).view(np.float32)
    zeros = np.array([0.0, -0.0], np.float32)
    v = np.concatenate([rand, ties, sub, sub_ties, carry, zeros])
    v = np.concatenate([v, -v])
    v = np.concatenate([v, np.zeros((-len(v)) % 8, np.float32)])
    return v.astype(np.float32).reshape(-1, 8)


def _unpermute(t, cols):
    out = torch.empty_like(t)
    out[:, cols] = t
    return out


def test_hi_is_tf32_rounded_to_nearest_ties_away():
    v = _values()
    hi, _, cols = fb.tf32_split(torch.from_numpy(v))
    np.testing.assert_array_equal(_bits(_unpermute(hi, cols).numpy()), _bits(_np_tf32_rna(v)))
    # the rounding did move values: ties up in magnitude, carries into the next binade
    assert (_bits(np.abs(_unpermute(hi, cols).numpy())) > _bits(np.abs(v))).any()


@pytest.mark.parametrize("special", [np.inf, -np.inf, np.nan])
def test_inf_and_nan_pass_through(special):
    v = np.full((2, 8), special, np.float32)
    v[0, 3] = 1.5
    hi, lo, cols = fb.tf32_split(torch.from_numpy(v))
    hi, lo = _unpermute(hi, cols).numpy(), _unpermute(lo, cols).numpy()
    mask = ~np.isfinite(v)
    np.testing.assert_array_equal(_bits(hi[mask]), _bits(v[mask]))
    assert np.isnan(lo[mask]).all()                 # inf - inf, NaN - NaN
    assert hi[0, 3] == 1.5 and lo[0, 3] == 0.0


def test_lo_is_the_rounded_remainder():
    v = _values()
    hi, lo, cols = fb.tf32_split(torch.from_numpy(v))
    hi, lo = _unpermute(hi, cols).numpy(), _unpermute(lo, cols).numpy()
    np.testing.assert_array_equal(_bits(lo), _bits(_np_tf32_rna(v - hi)))
    # both parts are TF32 values: their low 13 bits are zero
    assert not ((_bits(hi) | _bits(lo)) & 0x1FFF).any()


def test_split_error_is_within_2_to_the_minus_21():
    rng = np.random.RandomState(1)
    v = (rng.randn(256, 64) * 10.0 ** rng.randint(-30, 30, (256, 64))).astype(np.float32)
    hi, lo, cols = fb.tf32_split(torch.from_numpy(v))
    w = v[:, cols.numpy()].astype(np.float64)
    err = np.abs(w - hi.numpy().astype(np.float64) - lo.numpy().astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(w)).all()
    assert err.max() > 0                            # 3xTF32 keeps about 21 bits, not 24


@pytest.mark.parametrize("C", [8, 24, 64])
def test_columns_in_tf32_key_slot_order_and_the_inverse_restores_w(C):
    w = torch.from_numpy(np.random.RandomState(C).randn(5, C).astype(np.float32))
    hi, lo, cols = fb.tf32_split(w)
    j = np.arange(C)
    np.testing.assert_array_equal(cols.numpy(), 8 * (j // 8) + 2 * (j % 4) + (j % 8) // 4)
    # columns t and t + 4 of a k-step hold the neighbouring k = 2t and 2t + 1
    for t in range(4):
        np.testing.assert_array_equal(cols.numpy()[t::8] + 1, cols.numpy()[t + 4::8])
    inverse = torch.argsort(cols)
    assert torch.equal(w[:, cols][:, inverse], w)
    np.testing.assert_array_equal(_bits(hi[:, inverse].numpy()), _bits(_np_tf32_rna(w.numpy())))
    assert torch.equal((hi.double() + lo.double())[:, inverse].float(),
                       (hi.double() + lo.double()).float()[:, inverse])


def tf32x3_linear(a, w):
    """a [..., K] w [N, K]^T as the fp32 GEMM computes it: w split once
    (tf32_split: columns permuted), a split the same way (the kernel's
    fragments read a's k in that order), the three products a_lo w_hi +
    a_hi w_lo + a_hi w_hi in fp64, rounded to fp32 once."""
    lead, K = a.shape[:-1], a.shape[-1]
    w_hi, w_lo, _ = fb.tf32_split(w)
    a_hi, a_lo, _ = fb.tf32_split(a.reshape(-1, K))
    a_hi, a_lo, w_hi, w_lo = (t.double() for t in (a_hi, a_lo, w_hi, w_lo))
    out = a_lo @ w_hi.T + a_hi @ w_lo.T + a_hi @ w_hi.T
    return out.float().reshape(*lead, w.shape[0])


@pytest.mark.parametrize("K", [8, 64, 256])
def test_permuted_3xtf32_product_is_the_unpermuted_one(K):
    rng = np.random.RandomState(K)
    a = torch.from_numpy(rng.randn(33, K).astype(np.float32))
    w = torch.from_numpy((rng.randn(40, K) / np.sqrt(K)).astype(np.float32))
    rna = lambda t: torch.from_numpy(_np_tf32_rna(t.numpy())).double()   # noqa: E731
    a_hi, w_hi = rna(a), rna(w)
    a_lo, w_lo = rna(a - a_hi.float()), rna(w - w_hi.float())
    plain = a_lo @ w_hi.T + a_hi @ w_lo.T + a_hi @ w_hi.T
    got = tf32x3_linear(a, w).double()
    assert (got - plain.float().double()).abs().max() <= 1e-12 * plain.abs().max()
    # and it is an fp32-accurate product of the fp32 operands
    exact = a.double() @ w.double().T
    assert (got - exact).abs().max() <= 1e-6 * exact.abs().max()


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def test_emulated_fp32_mlp_forward_matches_interpreted_pallas():
    F, tile = 4 * D, N
    rng = np.random.RandomState(3)
    f32 = lambda t: t.astype(np.float32)   # noqa: E731
    x = f32(rng.randn(B * N, D))
    w1, b1 = f32(rng.randn(F, D) / np.sqrt(D)), f32(0.1 * rng.randn(F))
    w2, b2 = f32(rng.randn(D, F) / np.sqrt(F)), f32(0.1 * rng.randn(D))
    row = pl.BlockSpec((tile, D), lambda i: (i, 0))
    whole = lambda *shape: pl.BlockSpec(shape, lambda i: (0,) * len(shape))   # noqa: E731
    want = pl.pallas_call(
        jfm._mlp_kernel, grid=(B * N // tile,),
        in_specs=[row, whole(D, F), whole(1, F), whole(F, D), whole(1, D)],
        out_specs=row, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(*map(jnp.asarray, (x, w1.T, b1.reshape(1, F), w2.T, b2.reshape(1, D))))
    t = torch.from_numpy
    h = torch.nn.functional.gelu(tf32x3_linear(t(x), t(w1)) + t(b1))
    got = tf32x3_linear(h, t(w2)) + t(b2)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("need_feat", [False, True])
def test_emulated_fp32_block_forward_matches_interpreted_pallas(need_feat, monkeypatch):
    monkeypatch.setenv("DELTAKD_FUSED_CP", "0")
    blk = Block(num_heads=H, mlp_ratio=4.0, qkv_bias=True, drop_path_rate=0.0, ln_eps=1e-6)
    params = blk.init({"params": jax.random.PRNGKey(4)}, jnp.zeros((1, N, D)), True)["params"]
    rng = np.random.RandomState(4)
    params = jax.tree.map(lambda p: p + 0.05 * rng.randn(*p.shape).astype(np.float32), params)
    x = rng.randn(B, N, D).astype(np.float32)
    sa = np.array([0.0, 1 / 0.9], np.float32)
    sm = np.array([1 / 0.9, 1.0], np.float32)
    jfb.set_interpret(True)
    try:
        want = jfb.fused_vit_block(jnp.asarray(x), params, num_heads=H, scale_attn=jnp.asarray(sa),
                                   scale_mlp=jnp.asarray(sm), need_features=need_feat)
    finally:
        jfb.set_interpret(False)
    want_out, want_feat = want

    plain_mm = fb._mm

    def mm(a, b, dtype):   # the four linear products (b = W^T) as the fp32 GEMM computes them
        if dtype == torch.float32 and b.dim() == 2:
            return tf32x3_linear(a, b.t())
        return plain_mm(a, b, dtype)

    monkeypatch.setattr(fb, "_mm", mm)
    out, feat = fb.reference_vit_block(torch.from_numpy(x), flax_block_to_torch(params),
                                       num_heads=H, scale_attn=torch.from_numpy(sa),
                                       scale_mlp=torch.from_numpy(sm))
    _close(out.numpy() - x, np.asarray(want_out) - x)
    if need_feat:
        _close(feat.numpy(), np.asarray(want_feat))
