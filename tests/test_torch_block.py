"""The port's fused block (deltakd_tpu_torch/ops/fused_block.py) against the
JAX package's: the plain PyTorch forward and its gradients (through the
autograd Function and the plain backward) against the JAX pure-XLA
reference and the Pallas kernel run in interpret mode, with and without the
feature output and with drop-path scales of 0 and 1/keep.

Everything runs in fp32 on the CPU; differences are summation order only, so
the tolerance is 1e-4 of the largest reference value. The kernels themselves
run only on a card (tests/test_torch_cuda.py).
"""

import ast
import os

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


def _setup(seed=0):
    blk = Block(num_heads=H, mlp_ratio=4.0, qkv_bias=True, drop_path_rate=0.0,
                ln_eps=1e-6)
    params = blk.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, N, D)),
                      True)["params"]
    rng = np.random.RandomState(seed)
    # shift every param off its init so LN and bias grads are non-trivial
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.randn(*p.shape).astype(np.float32), params)
    x = rng.randn(B, N, D).astype(np.float32)
    sa = np.array([0.0, 1 / KEEP, 1 / KEEP, 1.0], np.float32)
    sm = np.array([1 / KEEP, 0.0, 1 / KEEP, 1.0], np.float32)
    g_out = rng.randn(B, N, D).astype(np.float32)
    g_feat = rng.randn(B, N, D).astype(np.float32)
    return params, x, sa, sm, g_out, g_feat


def _np(a):
    return a.detach().float().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(a, b, tol=TOL):
    a, b = _np(a).astype(np.float32), _np(b).astype(np.float32)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def _jax_grads(fn, params, x, sa, sm, g_out, g_feat, need_feat):
    def loss(p, x):
        out, feat = fn(x, p, num_heads=H, scale_attn=jnp.asarray(sa),
                       scale_mlp=jnp.asarray(sm))
        l = jnp.sum(out * g_out)
        return l + jnp.sum(feat * g_feat) if need_feat else l

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    return np.asarray(gx), flax_block_to_torch(gp)


def _torch_grads(params, x, sa, sm, g_out, g_feat, need_feat):
    tp = {k: v.clone().requires_grad_(True) for k, v in flax_block_to_torch(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, feat = tfb.fused_vit_block(tx, tp, num_heads=H, scale_attn=torch.from_numpy(sa),
                                    scale_mlp=torch.from_numpy(sm),
                                    need_features=need_feat)
    loss = (out * torch.from_numpy(g_out)).sum()
    if need_feat:
        loss = loss + (feat * torch.from_numpy(g_feat)).sum()
    else:
        assert feat is None
    grads = torch.autograd.grad(loss, [tx] + [tp[n] for n in tfb.PARAM_NAMES])
    return out, feat, grads[0].numpy(), dict(zip(tfb.PARAM_NAMES, grads[1:]))


def test_forward_matches_jax_reference():
    params, x, sa, sm, *_ = _setup()
    j_out, j_feat = jfb.reference_vit_block(jnp.asarray(x), params, num_heads=H,
                                            scale_attn=jnp.asarray(sa),
                                            scale_mlp=jnp.asarray(sm))
    t_out, t_feat = tfb.reference_vit_block(torch.from_numpy(x), flax_block_to_torch(params),
                                            num_heads=H, scale_attn=torch.from_numpy(sa),
                                            scale_mlp=torch.from_numpy(sm))
    _close(t_out, j_out)
    _close(t_feat, j_feat)
    # both branches scaled to 0: the block is the identity
    zero = torch.zeros(B)
    out, _ = tfb.reference_vit_block(torch.from_numpy(x), flax_block_to_torch(params),
                                     num_heads=H, scale_attn=zero, scale_mlp=zero)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-6)


@pytest.mark.parametrize("need_feat", [False, True])
def test_gradients_match_jax_reference(need_feat):
    params, x, sa, sm, g_out, g_feat = _setup(1)
    j_dx, j_dw = _jax_grads(jfb.reference_vit_block, params, x, sa, sm, g_out, g_feat,
                            need_feat)
    _, _, t_dx, t_dw = _torch_grads(params, x, sa, sm, g_out, g_feat, need_feat)
    _close(t_dx, j_dx)
    for name in tfb.PARAM_NAMES:
        _close(t_dw[name], j_dw[name])


@pytest.mark.parametrize("need_feat", [False, True])
def test_forward_and_gradients_match_interpreted_pallas_kernel(need_feat, monkeypatch):
    """The Pallas kernels themselves (forward and recompute backward), run by
    the Pallas interpreter on the CPU, on the single-device path."""
    monkeypatch.setenv("DELTAKD_FUSED_CP", "0")
    params, x, sa, sm, g_out, g_feat = _setup(2)
    jfb.set_interpret(True)
    try:
        j_out, j_feat = jfb.fused_vit_block(jnp.asarray(x), params, num_heads=H,
                                            scale_attn=jnp.asarray(sa),
                                            scale_mlp=jnp.asarray(sm),
                                            need_features=need_feat)
        j_dx, j_dw = _jax_grads(
            lambda x, p, **kw: jfb.fused_vit_block(x, p, need_features=need_feat, **kw),
            params, x, sa, sm, g_out, g_feat, need_feat)
    finally:
        jfb.set_interpret(False)
    t_out, t_feat, t_dx, t_dw = _torch_grads(params, x, sa, sm, g_out, g_feat, need_feat)
    _close(t_out, j_out)
    if need_feat:
        _close(t_feat, j_feat)
    _close(t_dx, j_dx)
    for name in tfb.PARAM_NAMES:
        _close(t_dw[name], j_dw[name])


def test_plain_backward_matches_autograd_and_dispatch():
    """The plain backward (the kernel's reference) equals autograd through the
    plain forward; CPU tensors never reach a kernel."""
    params, x, sa, sm, g_out, g_feat = _setup(3)
    tp = {k: v.requires_grad_(True) for k, v in flax_block_to_torch(params).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    kw = dict(num_heads=H, scale_attn=torch.from_numpy(sa), scale_mlp=torch.from_numpy(sm))
    out, feat = tfb.reference_vit_block(tx, tp, **kw)
    loss = (out * torch.from_numpy(g_out)).sum() + (feat * torch.from_numpy(g_feat)).sum()
    auto = torch.autograd.grad(loss, [tx] + [tp[n] for n in tfb.PARAM_NAMES])
    tfb.reset_launches()
    dx, dws = tfb.reference_vit_block_bwd(tx.detach(), tp, torch.from_numpy(g_out),
                                          torch.from_numpy(g_feat), **kw)
    _close(dx, auto[0], 1e-5)
    for name, a in zip(tfb.PARAM_NAMES, auto[1:]):
        _close(dws[name], a, 1e-5)
    assert not tfb.LAUNCHES


@pytest.mark.parametrize("width,heads", [(128, 4), (128, 1), (96, 2)])
def test_kernel_operands_reject_head_dims_without_kernel(width, heads):
    """The block kernels take head dim 64 only (the forward's attention has no
    other instantiation): the operand check raises ValueError before any
    launch; bf16 CPU tensors, so nothing could launch."""
    g = torch.Generator().manual_seed(0)
    bf = torch.bfloat16

    def weights(D):
        shapes = [(D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,),
                  (4 * D, D), (4 * D,), (D, 4 * D), (D,)]
        return [torch.randn(s, generator=g) for s in shapes]

    s = torch.ones(2)
    x = torch.randn(2, 5, width, generator=g).to(bf)
    with pytest.raises(ValueError, match="head dim"):
        tfb._kernel_operands(x, s, s, weights(width), heads, "fused_block_fwd")
    x64 = torch.randn(2, 5, 128, generator=g).to(bf)
    x_, sa_, sm_, ws = tfb._kernel_operands(x64, s, s, weights(128), 2, "fused_block_fwd")
    assert x_.dtype == bf and ws[2].dtype == bf and ws[0].dtype == torch.float32
    assert not tfb.LAUNCHES


def test_plain_forward_matches_jax_reference_at_finetune_length():
    """The plain block forward, which the card's kernel is held to, against the
    JAX reference at the 384-px finetune's sequence length (N=578: 24x24
    patches and two prefix tokens), B=1, D=128, 2 heads."""
    n, width, heads = 578, 128, 2
    blk = Block(num_heads=heads, mlp_ratio=4.0, qkv_bias=True, drop_path_rate=0.0,
                ln_eps=1e-6)
    params = blk.init({"params": jax.random.PRNGKey(5)}, jnp.zeros((1, n, width)),
                      True)["params"]
    rng = np.random.RandomState(5)
    params = jax.tree.map(
        lambda p: p + 0.05 * rng.randn(*p.shape).astype(np.float32), params)
    x = rng.randn(1, n, width).astype(np.float32)
    sa, sm = np.array([1 / KEEP], np.float32), np.array([1.0], np.float32)
    j_out, j_feat = jfb.reference_vit_block(jnp.asarray(x), params, num_heads=heads,
                                            scale_attn=jnp.asarray(sa),
                                            scale_mlp=jnp.asarray(sm))
    t_out, t_feat = tfb.reference_vit_block(torch.from_numpy(x), flax_block_to_torch(params),
                                            num_heads=heads, scale_attn=torch.from_numpy(sa),
                                            scale_mlp=torch.from_numpy(sm))
    assert t_out.shape == (1, n, width)
    _close(t_out - torch.from_numpy(x), np.asarray(j_out) - x)
    _close(t_feat, j_feat)


@pytest.mark.parametrize("epilogue", ["qkv", "proj", "fc1", "fc2"])
def test_plain_linear_is_the_forward_chains_product(epilogue):
    """plain_linear, the version the forward's GEMM is held to on the card,
    written out: a w^T + b in fp32 with bf16 operands, q's scaling, GELU and
    its derivative, the drop-path-scaled residual; kernel_linear refuses CPU
    tensors."""
    g = torch.Generator().manual_seed(1)
    M, K, N, rps = 12, 16, 24, 4
    a, w = torch.randn(M, K, generator=g), torch.randn(N, K, generator=g)
    bias, res = torch.randn(N, generator=g), torch.randn(M, N, generator=g)
    rs = torch.tensor([0.0, 1.5, 1.0])
    v = a.bfloat16().float() @ w.bfloat16().float().t() + bias
    kw, grad = {}, None
    if epilogue == "qkv":
        kw = dict(scale_cols=8, col_scale=0.25)
        v = torch.cat([v[:, :8] * 0.25, v[:, 8:]], dim=1)
    elif epilogue == "fc1":
        kw = dict(gelu=True)
        grad = torch.autograd.functional.jacobian(
            lambda t: torch.nn.functional.gelu(t), v[0]).diagonal()
        v = torch.nn.functional.gelu(v)
    pre = v
    if epilogue in ("proj", "fc2"):
        kw = dict(residual=res, res_scale=rs, rows_per_sample=rps)
        v = res + rs.repeat_interleave(rps)[:, None] * v
    out32, out_lp, got_pre, got_grad = tfb.plain_linear(a, w, bias, **kw)
    torch.testing.assert_close(out32, v, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out_lp, v.bfloat16())
    torch.testing.assert_close(got_pre, pre.bfloat16())
    if grad is None:
        assert got_grad is None
    else:
        torch.testing.assert_close(got_grad[0], grad, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tfb.kernel_linear(a.bfloat16(), w.bfloat16(), bias, **kw)


def test_port_imports_no_jax():
    """deltakd_tpu_torch, chip_smoke.py and scripts/ import neither jax,
    deltakd_tpu nor the JAX package's benchmarks."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, "chip_smoke.py")]
    for top in ("deltakd_tpu_torch", "scripts"):
        for d, _, names in os.walk(os.path.join(root, top)):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for module in ("models/import_timm.py", "models/pos_embed.py", "data/augment.py",
                   "data/mixup.py", "data/sampler.py", "data/sources.py",
                   "data/pipeline.py", "data/loader.py", "obs/logger.py", "obs/meters.py",
                   "obs/wandb_adapter.py", "obs/profiling.py", "ckpt/checkpoint.py",
                   "train/loop.py", "cli/train.py", "cli/eval.py", "cli/sweep.py",
                   "parallel/distributed.py", "parallel/mesh.py"):
        assert os.path.join(root, "deltakd_tpu_torch", module) in files, module
    for script in ("equivalence_run.py", "soak_run.py", "dryrun_multichip.py"):
        assert os.path.join(root, "scripts", script) in files, script
    banned = ("jax", "jaxlib", "flax", "optax", "deltakd_tpu", "benchmarks")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in banned, f"{path} imports {m}"
