"""The math of the block backward's kernels (deltakd_tpu_torch/ops/csrc/
attention_bwd.cuh, gemm_sm90.cuh) against the JAX package's on the CPU, and
the factory's choice of kernels by dtype.

- The attention backward in its flash form (from the row statistic lse and
  delta = rowsum(dO * O), as attention_bwd.cuh computes it), written here in
  plain PyTorch, against JAX `_attention_bwd_one` (the form with the softmax
  normalisation folded into row scalings) at fp32: the same gradient reached
  two ways, so the tolerance is 1e-5 of the largest value (fp32 rounding).
- `plain_weight_grad`, the weight gradient's plain version, against the four
  weight-gradient products of JAX `_block_bwd_reverse` at fp32, summed over
  the batch, at M = 36 and 18 rows; 1e-5 of the largest value (summation
  order).
- `plain_linear` with `mul`, the input gradient dhpre = (g_feat W2) * gelu',
  against the JAX reverse sweep's own formula on bf16 operands; 1e-5 of the
  largest value (summation order).
- `load_teacher_student`: the JAX factory's route at either dtype: the fused
  block for both models (the kernels' fp32 forms at fp32), flash_attention on
  the unfused route with the teacher's fused MLP, the pair for the student
  where asked at bf16 and NotImplementedError at fp32.
The kernels themselves run only on a card (tests/test_torch_cuda.py).
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

TOL = 1e-5


def _close(a, b, tol=TOL):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = b.detach().float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    assert a.shape == b.shape
    err, scale = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} x {scale:.3e}"


def flash_attention_bwd(qkv, dmerged, H):
    """dqkv [N, 3D] of one element in the flash form, as attention_bwd.cuh
    computes it per head: q pre-scaled, P = exp(S - lse),
    delta = rowsum(dO * O), dS = P (dP - delta); dq carries the q scale."""
    N, D3 = qkv.shape
    D = D3 // 3
    hd = D // H
    scale = hd ** -0.5
    parts = {"q": [], "k": [], "v": []}
    for h in range(H):
        q = qkv[:, h * hd:(h + 1) * hd] * scale
        k = qkv[:, D + h * hd:D + (h + 1) * hd]
        v = qkv[:, 2 * D + h * hd:2 * D + (h + 1) * hd]
        do = dmerged[:, h * hd:(h + 1) * hd]
        s = q @ k.t()
        p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
        delta = (do * (p @ v)).sum(-1, keepdim=True)
        ds = p * (do @ v.t() - delta)
        parts["q"].append(ds @ k * scale)
        parts["k"].append(ds.t() @ q)
        parts["v"].append(p.t() @ do)
    return torch.cat(parts["q"] + parts["k"] + parts["v"], dim=-1)


@pytest.mark.parametrize("n_tok", [50, 198])
def test_flash_form_attention_backward_matches_jax(n_tok):
    """Three heads of 64; q, k of std 1.5 so that the softmax is far from
    flat."""
    H, hd = 3, 64
    D = H * hd
    rng = np.random.RandomState(n_tok)
    qkv = rng.randn(n_tok, 3 * D).astype(np.float32)
    qkv[:, :2 * D] *= 1.5
    dmerged = rng.randn(n_tok, D).astype(np.float32)
    scale = hd ** -0.5
    _, es, rss = jfb._attention_fwd_stash(jnp.asarray(qkv), D, H, scale, jnp.float32)
    j = jfb._attention_bwd_one(jnp.asarray(qkv), jnp.asarray(dmerged), es, rss, D, H, hd,
                               scale, jnp.float32)
    t = flash_attention_bwd(torch.from_numpy(qkv), torch.from_numpy(dmerged), H)
    for i in range(3):   # dq, dk, dv each against its own largest value
        _close(t[:, i * D:(i + 1) * D], np.asarray(j)[:, i * D:(i + 1) * D])


B, N, D, H = 2, 18, 128, 2
HD = D // H


def _block(seed):
    """A JAX block's params off their init, the kernel weight dict at fp32,
    the input, the drop-path scales and the output cotangent."""
    blk = Block(num_heads=H, mlp_ratio=4.0, qkv_bias=True, drop_path_rate=0.0, ln_eps=1e-6)
    params = blk.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, N, D)),
                      True)["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda p: p + 0.05 * rng.randn(*p.shape).astype(np.float32), params)
    w = dict(zip(jfb._W_NAMES, jfb._weight_arrays(params, jnp.float32)))
    x = rng.randn(B, N, D).astype(np.float32)
    sa = np.array([1 / 0.9, 1.0], np.float32)
    sm = np.array([1.0, 1 / 0.9], np.float32)
    g_out = rng.randn(B, N, D).astype(np.float32)
    return params, w, x, sa, sm, g_out


def _reverse_operands(w, x, sa, sm, g_out, batch=B):
    """Per weight-gradient product, (output cotangent G, input X) over the
    rows of the first ``batch`` elements, built from JAX's stash as
    `_block_bwd_reverse` builds them, and JAX's own weight gradient summed
    over those elements (torch layout)."""
    scale = HD ** -0.5
    ops = {"w2": [], "w1": [], "wproj": [], "wqkv": []}
    sums = {}
    for b in range(batch):
        _, stash = jfb._block_fwd_stash(jnp.asarray(x[b]), w, sa[b], 1e-6, H, D, scale,
                                        jnp.float32)
        (y, qkv, es, rss, merged, _, _, xhat2, rstd2, z, h, hgrad) = stash
        _, tiles = jfb._block_bwd_reverse(stash, w, jnp.asarray(g_out[b]), None, sa[b], sm[b],
                                          1e-6, H, D, HD, scale, jnp.float32)
        g_feat = g_out[b] * sm[b]
        dhpre = (g_feat @ np.asarray(w["w2"]).T) * np.asarray(hgrad)
        dz = dhpre @ np.asarray(w["w1"]).T
        dx2 = g_out[b] + np.asarray(jfb._ln_bwd(jnp.asarray(dz), xhat2, rstd2, w["g2"])[0])
        dattn = dx2 * sa[b]
        dmerged = dattn @ np.asarray(w["wproj"]).T
        dqkv = jfb._attention_bwd_one(qkv, jnp.asarray(dmerged), es, rss, D, H, HD, scale,
                                      jnp.float32)
        for name, g, a, tile in (("w2", g_feat, h, tiles[10]), ("w1", dhpre, z, tiles[8]),
                                 ("wproj", dattn, merged, tiles[4]),
                                 ("wqkv", dqkv, y, tiles[2])):
            ops[name].append((np.asarray(g), np.asarray(a)))
            sums[name] = sums.get(name, 0.0) + np.asarray(tile).T
    return ops, sums


PRODUCTS = ["w2", "w1", "wproj", "wqkv"]


# fp32 throughout; M = B x N = 36 rows, and one element's 18 (no multiple of
# 4 or of the fp32 kernel's 32-row k-block, the edges its tiling treats
# apart)
@pytest.mark.parametrize("product,batch", [pytest.param(p, B, id=p) for p in PRODUCTS]
                         + [pytest.param(p, 1, id=f"{p}-M{N}") for p in PRODUCTS])
def test_plain_weight_grad_matches_jax_reverse_sweep(product, batch):
    _, w, x, sa, sm, g_out = _block(3)
    ops, sums = _reverse_operands(w, x, sa, sm, g_out, batch)
    g = torch.from_numpy(np.stack([o[0] for o in ops[product]]))
    a = torch.from_numpy(np.stack([o[1] for o in ops[product]]))
    got = tfb.plain_weight_grad(g, a, torch.float32)
    assert got.dtype == torch.float32 and got.shape == sums[product].shape
    _close(got, sums[product])


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_linear_mul_is_the_input_gradient_times_gelu_grad(with_bias):
    """dhpre = (g_feat W2) * gelu'(hpre), W2 the nn.Linear weight [D, F]:
    plain_linear(g_feat, W2^T, mul=gelu') against JAX's formula in
    `_block_bwd_reverse` on bf16 operands; with a bias, the bias enters before
    the multiplier."""
    params, w, x, sa, _, g_out = _block(4)
    _, stash = jfb._block_fwd_stash(jnp.asarray(x[0]), w, sa[0], 1e-6, H, D, HD ** -0.5,
                                    jnp.float32)
    hgrad = np.array(stash[11])
    g_feat = g_out[0]
    bias = np.random.RandomState(5).randn(4 * D).astype(np.float32) if with_bias else None
    w2_bf16 = jnp.asarray(w["w2"]).astype(jnp.bfloat16)    # JAX layout [F, D]
    dh = jax.lax.dot_general(jnp.asarray(g_feat).astype(jnp.bfloat16), w2_bf16,
                             (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32)
    want = (np.asarray(dh) + (0.0 if bias is None else bias)) * hgrad
    w2_torch = flax_block_to_torch(params)["mlp.fc2.weight"]      # [D, F]
    out32, out_lp, _, grad = tfb.plain_linear(
        torch.from_numpy(g_feat), w2_torch.t(), None if bias is None else torch.from_numpy(bias),
        mul=torch.from_numpy(hgrad))
    assert grad is None
    _close(out32, want)
    _close(out_lp, out32.bfloat16(), 0.0)


@pytest.mark.parametrize("dtype,block_pair,mesh_shape", [
    ("float32", False, None), ("float32", True, None), ("float32", False, (1, 2)),
    ("bfloat16", False, None), ("bfloat16", True, None), ("bfloat16", False, (1, 2)),
    ("float32", True, (1, 2))])
def test_factory_turns_the_kernels_off_for_fp32(dtype, block_pair, mesh_shape):
    """The factory's kernels at each dtype. The name is from before the fp32
    forms: the kernels are no longer turned off for fp32. An fp32 config is
    routed as the JAX factory routes it, through the kernels' fp32 forms: the
    fused block for both models; on the unfused route (a model axis of 2)
    flash_attention for both and the fused MLP for the forward-only teacher;
    block_pair gives the student the pair at either dtype (the pair's fp32
    form at fp32), never on the unfused route. Compute dtype and parameters
    follow the config."""
    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.ops.attention import flash_attention
    from deltakd_tpu_torch.ops.fused_block import fused_vit_block, fused_vit_block_pair
    from deltakd_tpu_torch.ops.fused_mlp import fused_mlp

    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224", aa="",
                      color_jitter=0.0, dataset="cifar-10", input_size=32,
                      distillation_type="soft", allow_random_teacher=True, dtype=dtype,
                      mesh_shape=mesh_shape)
    unfused = mesh_shape is not None
    teacher, student, _ = load_teacher_student(cfg, block_pair=block_pair, seed=0,
                                               device="cpu")
    want = torch.float32 if dtype == "float32" else torch.bfloat16
    assert teacher.dtype == student.dtype == want
    assert next(student.parameters()).dtype == torch.float32
    assert teacher.attention_fn is student.attention_fn is flash_attention
    assert teacher.block_pair_fn is None
    assert student.mlp_fn is None
    if unfused:
        assert teacher.block_fn is student.block_fn is None
        assert student.block_pair_fn is None
        assert teacher.mlp_fn is fused_mlp
    else:
        assert teacher.block_fn is student.block_fn is fused_vit_block
        assert student.block_pair_fn is (fused_vit_block_pair if block_pair else None)
