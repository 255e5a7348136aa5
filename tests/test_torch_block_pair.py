"""The port's block pair (fused_vit_block_pair in
deltakd_tpu_torch/ops/fused_block.py) against the JAX package's: forward and
gradients (dx and all 24 weight gradients) against the Pallas pair kernels run
by the Pallas interpreter and against two chained pure-XLA reference blocks,
for the four (need_features1, need_features2) variants, with drop-path scales
that hold zeros, 1/keep and 1; the plain backward against autograd; the
single-forward (hybrid) keyword; dispatch.

Everything runs in fp32 on the CPU, where the pair and two chained single
blocks are the same function (nothing is rounded between the blocks);
differences are summation order only, so the tolerance is 1e-4 of the largest
reference value, 1e-5 where both sides are PyTorch. The kernels themselves run
only on a card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deltakd_tpu.models.vit import Block
from deltakd_tpu.ops import fused_block as jfb
from deltakd_tpu_torch.models.convert import flax_block_to_torch
from deltakd_tpu_torch.ops import fused_block as tfb

torch.set_num_threads(1)

B, N, D, H = 4, 18, 64, 2
TOL = 1e-4
KEEP = 0.9
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
SCALE_NAMES = ("scale_attn1", "scale_mlp1", "scale_attn2", "scale_mlp2")


def _setup(seed=0):
    """Two blocks' parameters shifted off their init, x, the four scales and
    cotangents for out, feat1 and feat2, all from numpy seeds."""
    rng = np.random.RandomState(seed)
    blk = Block(num_heads=H, mlp_ratio=4.0, qkv_bias=True, drop_path_rate=0.0,
                ln_eps=1e-6)
    params = []
    for i in range(2):
        p = blk.init({"params": jax.random.PRNGKey(seed + 10 * i)}, jnp.zeros((1, N, D)),
                     True)["params"]
        params.append(jax.tree.map(
            lambda a: a + 0.05 * rng.randn(*a.shape).astype(np.float32), p))
    x = rng.randn(B, N, D).astype(np.float32)
    scales = np.array([[0.0, 1 / KEEP, 1 / KEEP, 1.0],       # s_attn1
                       [1 / KEEP, 0.0, 1 / KEEP, 1.0],       # s_mlp1
                       [1 / KEEP, 1 / KEEP, 0.0, 1.0],       # s_attn2
                       [1.0, 1 / KEEP, 0.0, 1 / KEEP]], np.float32)   # s_mlp2
    gs = [rng.randn(B, N, D).astype(np.float32) for _ in range(3)]
    return params, x, scales, gs


def _np(a):
    return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol=TOL):
    a, b = _np(a).astype(np.float32), _np(b).astype(np.float32)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def _j_chained(x, p1, p2, *, num_heads, need_features1=True, need_features2=True,
               scale_attn1=None, scale_mlp1=None, scale_attn2=None, scale_mlp2=None):
    """Two chained pure-XLA reference blocks: the plain reference of the pair."""
    mid, f1 = jfb.reference_vit_block(x, p1, num_heads=num_heads, scale_attn=scale_attn1,
                                      scale_mlp=scale_mlp1)
    out, f2 = jfb.reference_vit_block(mid, p2, num_heads=num_heads, scale_attn=scale_attn2,
                                      scale_mlp=scale_mlp2)
    return out, (f1 if need_features1 else None), (f2 if need_features2 else None)


def _jax_run(fn, params, x, scales, gs, nf1, nf2):
    """(out, feat1, feat2, dx, block 1's grads, block 2's) of a JAX pair."""
    kw = dict(zip(SCALE_NAMES, map(jnp.asarray, scales)), num_heads=H,
              need_features1=nf1, need_features2=nf2)

    def loss(p1, p2, x):
        out, f1, f2 = fn(x, p1, p2, **kw)
        total = jnp.sum(out * gs[0])
        if nf1:
            total = total + jnp.sum(f1 * gs[1])
        if nf2:
            total = total + jnp.sum(f2 * gs[2])
        return total

    out, f1, f2 = fn(jnp.asarray(x), *params, **kw)
    g1, g2, gx = jax.grad(loss, argnums=(0, 1, 2))(*params, jnp.asarray(x))
    return out, f1, f2, np.asarray(gx), flax_block_to_torch(g1), flax_block_to_torch(g2)


def _torch_run(params, x, scales, gs, nf1, nf2, **extra):
    tps = [{k: v.clone().requires_grad_(True) for k, v in flax_block_to_torch(p).items()}
           for p in params]
    tx = torch.from_numpy(x).requires_grad_(True)
    out, f1, f2 = tfb.fused_vit_block_pair(
        tx, *tps, num_heads=H, need_features1=nf1, need_features2=nf2,
        **dict(zip(SCALE_NAMES, map(torch.from_numpy, scales))), **extra)
    loss = (out * torch.from_numpy(gs[0])).sum()
    if nf1:
        loss = loss + (f1 * torch.from_numpy(gs[1])).sum()
    if nf2:
        loss = loss + (f2 * torch.from_numpy(gs[2])).sum()
    grads = torch.autograd.grad(
        loss, [tx] + [tp[n] for tp in tps for n in tfb.PARAM_NAMES])
    n = len(tfb.PARAM_NAMES)
    return (out, f1, f2, grads[0].numpy(), dict(zip(tfb.PARAM_NAMES, grads[1:1 + n])),
            dict(zip(tfb.PARAM_NAMES, grads[1 + n:])))


def _compare(t, j, nf1, nf2):
    _close(t[0], j[0])
    for flag, tf, jf in ((nf1, t[1], j[1]), (nf2, t[2], j[2])):
        if flag:
            _close(tf, jf)
        else:
            assert tf is None and jf is None
    _close(t[3], j[3])
    for t_dw, j_dw in ((t[4], j[4]), (t[5], j[5])):
        for name in tfb.PARAM_NAMES:
            _close(t_dw[name], j_dw[name])


@pytest.mark.parametrize("nf1,nf2", FLAGS)
def test_pair_matches_interpreted_pallas_pair_kernels(nf1, nf2, monkeypatch):
    """The Pallas pair kernels themselves (forward and recompute backward),
    run by the Pallas interpreter on the CPU, on the single-device path."""
    monkeypatch.setenv("DELTAKD_FUSED_CP", "0")
    monkeypatch.delenv("DELTAKD_PAIR_HYBRID", raising=False)
    params, x, scales, gs = _setup(1)
    jfb.set_interpret(True)
    try:
        j = _jax_run(jfb.fused_vit_block_pair, params, x, scales, gs, nf1, nf2)
    finally:
        jfb.set_interpret(False)
    _compare(_torch_run(params, x, scales, gs, nf1, nf2), j, nf1, nf2)


@pytest.mark.parametrize("nf1,nf2", FLAGS)
def test_pair_matches_chained_jax_reference(nf1, nf2):
    params, x, scales, gs = _setup(2)
    j = _jax_run(_j_chained, params, x, scales, gs, nf1, nf2)
    _compare(_torch_run(params, x, scales, gs, nf1, nf2), j, nf1, nf2)


def test_pair_with_all_scales_zero_is_the_identity():
    params, x, _, _ = _setup(3)
    zero = torch.zeros(B)
    out, f1, f2 = tfb.reference_vit_block_pair(
        torch.from_numpy(x), *map(flax_block_to_torch, params), num_heads=H,
        scales=(zero,) * 4)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-6)
    assert f1.shape == f2.shape == x.shape


@pytest.mark.parametrize("extra", ["none", "feat1", "feat2", "both"])
def test_plain_pair_backward_matches_autograd_and_dispatch(extra):
    """The plain pair backward (the kernel's reference, written from the
    kernel's formulas) equals autograd through two plain forwards, with an
    extra cotangent on either feature; CPU tensors never reach a kernel."""
    params, x, scales, gs = _setup(4)
    tps = [{k: v.requires_grad_(True) for k, v in flax_block_to_torch(p).items()}
           for p in params]
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = [torch.from_numpy(s) for s in scales]
    mid, f1 = tfb.reference_vit_block(tx, tps[0], num_heads=H, scale_attn=ts[0],
                                      scale_mlp=ts[1])
    out, f2 = tfb.reference_vit_block(mid, tps[1], num_heads=H, scale_attn=ts[2],
                                      scale_mlp=ts[3])
    g_out, g_f1, g_f2 = map(torch.from_numpy, gs)
    g_f1 = g_f1 if extra in ("feat1", "both") else None
    g_f2 = g_f2 if extra in ("feat2", "both") else None
    loss = (out * g_out).sum()
    if g_f1 is not None:
        loss = loss + (f1 * g_f1).sum()
    if g_f2 is not None:
        loss = loss + (f2 * g_f2).sum()
    auto = torch.autograd.grad(loss, [tx] + [tp[n] for tp in tps for n in tfb.PARAM_NAMES])
    tfb.reset_launches()
    dx, dw1, dw2 = tfb.reference_vit_block_pair_bwd(tx.detach(), *tps, g_out, g_f1, g_f2,
                                                    num_heads=H, scales=ts)
    _close(dx, auto[0], 1e-5)
    n = len(tfb.PARAM_NAMES)
    for name, a1, a2 in zip(tfb.PARAM_NAMES, auto[1:1 + n], auto[1 + n:]):
        _close(dw1[name], a1, 1e-5)
        _close(dw2[name], a2, 1e-5)
    r_out, r_f1, r_f2 = tfb.reference_vit_block_pair(tx.detach(), *tps, num_heads=H, scales=ts)
    _close(r_out, out, 1e-5)
    _close(r_f1, f1, 1e-5)
    _close(r_f2, f2, 1e-5)
    assert not tfb.LAUNCHES


@pytest.mark.parametrize("nf1,nf2", [(False, False), (True, True)])
def test_single_forward_keyword_gives_the_pair_values_at_fp32(nf1, nf2):
    """The attribution variant (two single-block forwards, the pair backward)
    rounds nothing between the blocks at fp32, so it equals the pair."""
    params, x, scales, gs = _setup(5)
    pair = _torch_run(params, x, scales, gs, nf1, nf2)
    hybrid = _torch_run(params, x, scales, gs, nf1, nf2, single_forward=True)
    _compare(hybrid, pair, nf1, nf2)


def test_pair_rounds_nothing_between_the_blocks_in_bf16():
    """In bf16 the pair keeps the activation between the blocks unrounded:
    its output differs from two chained single blocks, whose first output is
    rounded to bf16, and equals the second block applied to the unrounded
    activation."""
    params, x, scales, _ = _setup(6)
    tps = [flax_block_to_torch(p) for p in params]
    ws = [tfb.block_params(tp) for tp in tps]
    xb = torch.from_numpy(x).bfloat16()
    ts = [torch.from_numpy(s) for s in scales]
    out, _, _ = tfb.reference_vit_block_pair(xb, *tps, num_heads=H, scales=ts)
    mid32, _, _ = tfb._block_fwd_stash(xb.float(), ws[0], ts[0], 1e-6, H, torch.bfloat16, ts[1])
    want, _, _ = tfb._block_fwd_stash(mid32, ws[1], ts[2], 1e-6, H, torch.bfloat16, ts[3])
    assert torch.equal(out, want.bfloat16())
    mid, _ = tfb.reference_vit_block(xb, tps[0], num_heads=H, scale_attn=ts[0],
                                     scale_mlp=ts[1])
    chained, _ = tfb.reference_vit_block(mid, tps[1], num_heads=H, scale_attn=ts[2],
                                         scale_mlp=ts[3])
    assert out.dtype == chained.dtype == torch.bfloat16
    assert not torch.equal(out, chained)
    _close(out, chained, 2e-2)


def test_pair_dispatch_and_operand_checks():
    """A meta tensor has no implementation; the kernel wrappers refuse fp32
    input with bf16 weights, two blocks of different hidden widths and a head
    dim without a kernel before they touch a library; best_block_pair_fn
    gives the function or None."""
    params, x, scales, _ = _setup(7)
    tps = [flax_block_to_torch(p) for p in params]
    ws = [tfb.block_params(tp) for tp in tps]
    ts = tuple(torch.from_numpy(s) for s in scales)
    with pytest.raises(ValueError, match="no implementation"):
        tfb.pair_fwd(torch.empty(B, N, D, device="meta"), ts, *ws, H, 1e-6, True, True)
    with pytest.raises(ValueError, match="no implementation"):
        tfb.pair_bwd(torch.empty(B, N, D, device="meta"), ts, *ws, None, None, None, H, 1e-6)
    # one head of 64, so that the dtypes are what is refused
    with pytest.raises(ValueError, match="fp32 x takes fp32 weights"):
        tfb.fused_pair_fwd_cuda(torch.from_numpy(x), ts, *[[t.bfloat16() for t in w]
                                                          for w in ws], D // 64, 1e-6, True,
                                True)
    narrow = list(ws[1])
    narrow[8], narrow[9], narrow[10] = narrow[8][:128], narrow[9][:128], narrow[10][:, :128]
    # one head of 64, a head dim the kernels take, so that the widths are what is refused
    with pytest.raises(ValueError, match="hidden widths"):
        tfb.fused_pair_bwd_cuda(torch.from_numpy(x).bfloat16(), ts, ws[0], tuple(narrow),
                                torch.from_numpy(x), None, None, D // 64, 1e-6)
    with pytest.raises(ValueError, match="head dim"):
        tfb.fused_pair_fwd_cuda(torch.from_numpy(x).bfloat16(), ts, *ws, H, 1e-6, True, True)
    assert tfb.best_block_pair_fn() is tfb.fused_vit_block_pair
    assert tfb.best_block_pair_fn(False) is None
    assert not tfb.LAUNCHES
