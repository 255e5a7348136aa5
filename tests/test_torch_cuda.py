"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Run on a machine with an NVIDIA GPU (no JAX needed there):
    python -m pytest tests/test_torch_cuda.py -m cuda
Without a card the tests skip: a CUDA kernel has no CPU mode. The fused
block: small shape (D=128, 2 heads of 64, N=18) with drop-path scales of 0
and 1/keep, and the forward and the backward (with and without a feature
cotangent) at N in (50, 198, 578) for D in (192, 384, 768); bf16 operands, so
the tolerance is 2e-2 of the largest reference value. The GEMM alone: the
forward's products against F.linear plus their epilogue, the backward's input
gradient with the GELU derivative as `mul` and its weight gradients against
their plain versions, same tolerance, two runs the same bits. An fp32 soft-KD
train step through the factory, which gives an fp32 config no kernels: on the
card, and on the CPU as well (the one case here that runs without a card). The
block-pair kernels: the four (feat1, feat2) variants at D=192 and D=384 on
weights of std 1/sqrt(fan-in), scales with zeros, through the kernels alone
and through the autograd Function. The sort kernels: inputs with ties (+0.0 tied with a later -0.0 from
n = 4 on), n from 2 to 1024; the value sort also in fp16 and int32 with NaN, +-inf and
the int32 extremes, against torch.sort (NaNs at the same places); sorted values, signs and gradients exactly, the loss to 1e-5 (fp32 sums in
another order). The attention and MLP
kernels: O(1) bf16 inputs (q, k of std 2, weights of std 1/sqrt(fan-in)), ragged
N and M; 2e-2 of the largest reference value, 1e-3 absolute on lse. The
train-time data path: the RA and AA transform at 224 px on the card against
the CPU on the same draws (as chip_smoke.py phase 9), no host sync in the
transform or in mixup, and a fused soft-KD step with TrainConfig's defaults
and a teacher imported from a checkpoint written with chip_smoke.py's
``write_teacher_checkpoint``.
"""

import pytest
import torch

from deltakd_tpu_torch.ops import attention as at
from deltakd_tpu_torch.ops import fused_block as fb
from deltakd_tpu_torch.ops import fused_mlp as fm
from deltakd_tpu_torch.ops import sort as so

B, N, D, H = 4, 18, 128, 2


@pytest.mark.cuda
@pytest.mark.parametrize("need_feat", [False, True])
def test_kernels_match_plain_version_on_card(need_feat):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(0)
    shapes = [(D,), (D,), (3 * D, D), (3 * D,), (D, D), (D,), (D,), (D,),
              (4 * D, D), (4 * D,), (D, 4 * D), (D,)]
    params = {n: (0.1 * torch.randn(s, generator=g) + (1.0 if "norm" in n and "weight" in n
                                                       else 0.0)).cuda()
              for n, s in zip(fb.PARAM_NAMES, shapes)}
    x = torch.randn(B, N, D, generator=g).cuda().bfloat16()
    keep = 0.9
    kw = dict(num_heads=H, scale_attn=torch.tensor([0, 1 / keep, 1 / keep, 1]).cuda(),
              scale_mlp=torch.tensor([1 / keep, 0, 1 / keep, 1]).cuda())
    g_out = torch.randn(B, N, D, generator=g).cuda().bfloat16()
    g_feat = torch.randn(B, N, D, generator=g).cuda().bfloat16() if need_feat else None
    out, feat = fb.kernel_block_fwd(x, params, need_features=need_feat, **kw)
    r_out, r_feat = fb.reference_vit_block(x, params, **kw)
    dx, dws = fb.kernel_block_bwd(x, params, g_out, g_feat, **kw)
    r_dx, r_dws = fb.reference_vit_block_bwd(x, params, g_out, g_feat, **kw)
    # out is compared as out - x, so that the residual does not hide the branches
    pairs = [(out.float() - x.float(), r_out.float() - x.float()), (dx, r_dx)]
    pairs += [(dws[n], r_dws[n]) for n in fb.PARAM_NAMES]
    if need_feat:
        pairs.append((feat, r_feat))
    else:
        assert feat is None
    for a, b in pairs:
        a, b = a.float(), b.float()
        assert (a - b).abs().max().item() <= 2e-2 * b.abs().max().item()
    # a head dim without a kernel instantiation is refused before any launch
    fb.reset_launches()
    with pytest.raises(ValueError, match="head dim"):
        fb.kernel_block_fwd(x, params, need_features=need_feat, **{**kw, "num_heads": 4})
    assert not fb.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("n_tok", [50, 198, 578])
@pytest.mark.parametrize("width,heads", [(192, 3), (384, 6), (768, 12)])
def test_block_forward_sequence_lengths_on_card(width, heads, n_tok):
    """The forward (TMA + wgmma GEMM, on-chip attention) at ragged sequence
    lengths and every registered width; drop-path scales with zeros; two runs
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(width + n_tok)
    params = _block_params(width, g)
    x = torch.randn(2, n_tok, width, generator=g).cuda().bfloat16()
    kw = dict(num_heads=heads, scale_attn=torch.tensor([0.0, 1 / 0.9]).cuda(),
              scale_mlp=torch.tensor([1 / 0.9, 1.0]).cuda())
    out, feat = fb.kernel_block_fwd(x, params, need_features=True, **kw)
    again = fb.kernel_block_fwd(x, params, need_features=True, **kw)
    r_out, r_feat = fb.reference_vit_block(x, params, **kw)
    _within(out.float() - x.float(), r_out.float() - x.float())
    _within(feat, r_feat)
    assert torch.equal(out, again[0]) and torch.equal(feat, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("product", ["qkv", "proj", "fc1", "fc2"])
@pytest.mark.parametrize("width", [192, 384])
def test_linear_matches_f_linear_on_card(width, product):
    """The forward's GEMM alone (gemm_sm90.cuh) against F.linear plus the
    epilogue forward_chain gives the product, every output, M ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(width)
    M = 1001
    n_mult, k_mult = {"qkv": (3, 1), "proj": (1, 1), "fc1": (4, 1), "fc2": (1, 4)}[product]
    N, K = n_mult * width, k_mult * width
    a = torch.randn(M, K, generator=g).cuda().bfloat16()
    w = (torch.randn(N, K, generator=g) / K ** 0.5).cuda().bfloat16()
    bias = (0.1 * torch.randn(N, generator=g)).cuda()
    kw = {"qkv": dict(scale_cols=width, col_scale=0.125), "fc1": dict(gelu=True)}.get(product)
    if kw is None:
        res = torch.randn(M, N, generator=g).cuda()
        kw = dict(residual=res.bfloat16() if product == "proj" else res,
                  res_scale=torch.tensor([0.0, 1.5] * 71 + [1.0]).cuda(), rows_per_sample=7)
    got = fb.kernel_linear(a, w, bias, **kw)
    ref = fb.plain_linear(a, w, bias, **kw)
    for x, r in zip(got, ref):
        if r is None:
            assert x is None
        else:
            _within(x, r)
    if product == "qkv":    # past the q columns, the product is F.linear's
        lin = torch.nn.functional.linear(a.float(), w.float(), bias)
        _within(got[0][:, width:], lin[:, width:])


@pytest.mark.cuda
@pytest.mark.parametrize("n_tok", [50, 198, 578])
@pytest.mark.parametrize("width,heads", [(192, 3), (384, 6), (768, 12)])
def test_block_backward_sequence_lengths_on_card(width, heads, n_tok):
    """The backward (recompute with lse, attention backward with the scores
    on chip, every product on the TMA + wgmma GEMM) at ragged sequence
    lengths and every registered width, with and without a feature
    cotangent; drop-path scales with zeros; two runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(width + n_tok + 1)
    params = _block_params(width, g)
    x = torch.randn(2, n_tok, width, generator=g).cuda().bfloat16()
    kw = dict(num_heads=heads, scale_attn=torch.tensor([0.0, 1 / 0.9]).cuda(),
              scale_mlp=torch.tensor([1 / 0.9, 1.0]).cuda())
    g_out, g_feat = (torch.randn(x.shape, generator=g).cuda().bfloat16() for _ in range(2))
    for gf in (None, g_feat):
        dx, dws = fb.kernel_block_bwd(x, params, g_out, gf, **kw)
        dx2, dws2 = fb.kernel_block_bwd(x, params, g_out, gf, **kw)
        r_dx, r_dws = fb.reference_vit_block_bwd(x, params, g_out, gf, **kw)
        _within(dx, r_dx)
        for n in fb.PARAM_NAMES:
            _within(dws[n], r_dws[n])
            assert torch.equal(dws[n], dws2[n])
        assert torch.equal(dx, dx2)
    # a sequence longer than the attention backward's shared-memory dQ holds is
    # refused before any launch
    long_x = torch.zeros(1, fb.KERNEL_BWD_MAX_N + 1, width, device="cuda", dtype=torch.bfloat16)
    fb.reset_launches()
    with pytest.raises(ValueError, match="sequence length"):
        fb.kernel_block_bwd(long_x, params, long_x, None, num_heads=heads)
    assert not fb.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("M,O,I", [(1001, 192, 768), (1584, 768, 192), (50, 192, 192),
                                   (1001, 576, 192), (333, 384, 1536)])
def test_weight_grad_matches_plain_version_on_card(M, O, I):
    """The backward's weight-gradient GEMM (fp32 partials over row ranges,
    summed in a fixed order) against plain_weight_grad: ragged M, O that
    leaves half a 128-row tile; two runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(M + O + I)
    G = torch.randn(M, O, generator=g).cuda().bfloat16()
    X = torch.randn(M, I, generator=g).cuda().bfloat16()
    dw = fb.kernel_weight_grad(G, X)
    assert dw.dtype == torch.float32 and dw.shape == (O, I)
    _within(dw, fb.plain_weight_grad(G, X))
    assert torch.equal(dw, fb.kernel_weight_grad(G, X))
    with pytest.raises(ValueError):
        fb.kernel_weight_grad(G.cpu(), X.cpu())
    with pytest.raises(ValueError):
        fb.kernel_weight_grad(G[:, :O - 4], X)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [192, 384])
def test_input_gradient_with_mul_on_card(width):
    """dhpre = (g_feat W2) * gelu' on the GEMM (kernel_linear on W2^T with
    `mul`) against plain_linear, M ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(width + 5)
    M, F = 1001, 4 * width
    gfeat = torch.randn(M, width, generator=g).cuda().bfloat16()
    w2 = (torch.randn(width, F, generator=g) / width ** 0.5).cuda().bfloat16()
    mul = (1.2 * torch.rand(M, F, generator=g) - 0.1).cuda()
    got = fb.kernel_linear(gfeat, w2.t().contiguous(), mul=mul, outputs=("f32", "bf16"))
    ref = fb.plain_linear(gfeat, w2.t(), mul=mul)
    _within(got[0], ref[0])
    _within(got[1], ref[1])
    with pytest.raises(ValueError):
        fb.kernel_linear(gfeat, w2.t().contiguous(), mul=mul[:, :8])


def _block_params(width, g):
    shapes = [(width,), (width,), (3 * width, width), (3 * width,), (width, width), (width,),
              (width,), (width,), (4 * width, width), (4 * width,), (width, 4 * width), (width,)]
    return {n: (torch.randn(s, generator=g) * (s[-1] ** -0.5 if len(s) == 2 else 0.1)
                + (1.0 if "norm" in n and "weight" in n else 0.0)).cuda()
            for n, s in zip(fb.PARAM_NAMES, shapes)}


@pytest.mark.cuda
@pytest.mark.parametrize("nf1,nf2", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("width,heads", [(192, 3), (384, 6)])
def test_pair_kernels_match_plain_version_on_card(width, heads, nf1, nf2):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(width + 2 * nf1 + nf2)
    n_tok, batch = 50, 4
    p1, p2 = _block_params(width, g), _block_params(width, g)
    x = torch.randn(batch, n_tok, width, generator=g).cuda().bfloat16()
    keep = 0.9
    scales = tuple(torch.tensor(v).cuda() for v in (
        [0, 1 / keep, 1 / keep, 0], [1 / keep, 0, 1 / keep, 0], [1 / keep, 1, 0, 0],
        [1, 1 / keep, 0, 0]))
    g_out, g_f1, g_f2 = (torch.randn(x.shape, generator=g).cuda().bfloat16() for _ in range(3))
    g_f1, g_f2 = (g_f1 if nf1 else None), (g_f2 if nf2 else None)
    kw = dict(num_heads=heads, scales=scales)
    out, f1, f2 = fb.kernel_block_pair_fwd(x, p1, p2, need_features1=nf1, need_features2=nf2,
                                           **kw)
    r_out, r_f1, r_f2 = fb.reference_vit_block_pair(x, p1, p2, **kw)
    dx, dw1, dw2 = fb.kernel_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)
    r_dx, r_dw1, r_dw2 = fb.reference_vit_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)
    assert torch.equal(out[3], x[3])        # all four scales 0: the pair is the identity
    _within(out.float() - x.float(), r_out.float() - x.float())
    _within(dx, r_dx)
    for n in fb.PARAM_NAMES:
        _within(dw1[n], r_dw1[n])
        _within(dw2[n], r_dw2[n])
    for flag, f, r_f in ((nf1, f1, r_f1), (nf2, f2, r_f2)):
        if flag:
            _within(f, r_f)
        else:
            assert f is None
    # through the autograd Function: one launch each, gradients in the parameters' dtype
    leaves = [{n: t.clone().requires_grad_(True) for n, t in p.items()} for p in (p1, p2)]
    x_leaf = x.clone().requires_grad_(True)
    fb.reset_launches()
    names = ("scale_attn1", "scale_mlp1", "scale_attn2", "scale_mlp2")
    o, a1, a2 = fb.fused_vit_block_pair(x_leaf, *leaves, num_heads=heads, need_features1=nf1,
                                        need_features2=nf2, **dict(zip(names, scales)))
    loss = (o.float() * g_out.float()).sum()
    loss = loss + sum((a.float() * c.float()).sum() for a, c in ((a1, g_f1), (a2, g_f2))
                      if a is not None)
    grads = torch.autograd.grad(loss, [x_leaf] + [p[n] for p in leaves for n in fb.PARAM_NAMES])
    assert fb.LAUNCHES == {("fused_pair_fwd", width): 1, ("fused_pair_bwd", width): 1}
    assert torch.equal(grads[0], dx) and grads[1].dtype == torch.float32
    assert torch.equal(grads[1], dw1["norm1.weight"])
    with pytest.raises(ValueError):
        fb.kernel_block_pair_fwd(x.float(), p1, p2, **kw)


def _within(a, b, tol=2e-2):
    a, b = a.float(), b.float()
    assert (a - b).abs().max().item() <= tol * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.int32])
@pytest.mark.parametrize("shape", [(3, 196, 40), (2, 2, 5), (2, 1024, 20), (4, 33, 1)])
def test_value_sort_matches_torch_sort_on_card(shape, dtype):
    """The value sort in its four dtypes: ties, +-0.0, +-inf and NaN (the int32
    extremes for int32); torch.sort's values where it has no NaN, the NaNs at
    the same places, each column's -0.0 count kept."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(shape[1])
    if dtype == torch.int32:
        x = torch.randint(-40, 40, shape, generator=g, dtype=torch.int32)
        x.view(-1)[:4] = torch.tensor([-2**31, 2**31 - 1, 2**31 - 1, 0], dtype=torch.int32)
    else:
        x = (torch.randn(shape, generator=g) * 4).round() / 4
        x.view(-1)[:6] = torch.tensor([float("nan"), -0.0, float("inf"), 0.0, -float("inf"), -0.0])
        x = x.to(dtype)
    x = x.cuda()
    so.reset_launches()
    out = so.bitonic_sort(x, axis=1)
    assert so.LAUNCHES == {"bitonic_sort": 1} and out.dtype == dtype
    # torch.sort on the card puts a NaN with its sign bit set first (the CPU
    # cast to bf16 makes every NaN 0xffff); the value sort puts every NaN last
    ref = torch.sort(torch.where(torch.isnan(x), x.abs(), x) if dtype.is_floating_point else x,
                     dim=1).values
    nan = torch.isnan(ref) if dtype.is_floating_point else torch.zeros_like(ref, dtype=torch.bool)
    assert torch.equal(out[~nan], ref[~nan])
    if dtype.is_floating_point:
        assert torch.equal(torch.isnan(out), nan)
        neg_zero = lambda t: ((t == 0) & torch.signbit(t)).sum(dim=1)
        assert torch.equal(neg_zero(out), neg_zero(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 196, 40), (2, 64, 33), (2, 2, 5), (1, 1024, 20),
                                   (2, 1024, 20), (2, 33, 40), (4, 196, 384)])
def test_sort_kernels_match_plain_version_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(shape[1])
    s = torch.randn(shape, generator=g).bfloat16().to(dtype)
    t = torch.randn(shape, generator=g).bfloat16().to(dtype)
    s[:, 1] = s[:, 0]
    if shape[1] >= 4:   # +0.0 tied with a later -0.0: the stable order keeps row 2 first
        s[:, 2], s[:, 3] = 0.0, -0.0
    t[:, :1] = s[:, :1]
    s, t = s.cuda(), t.cuda()
    assert torch.equal(so.bitonic_sort(s, axis=1), torch.sort(s, dim=1).values)
    assert torch.equal(so.bitonic_sort(s, axis=2), torch.sort(s, dim=2).values)
    so.reset_launches()
    s_k, t_k = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
    loss = so.sorted_l1(s_k, t_k, 1)
    g_s, g_t = torch.autograd.grad(loss, [s_k, t_k])
    assert so.LAUNCHES == {"sorted_l1_fwd": 1, "sorted_l1_bwd": 1}
    s_r = s.clone().requires_grad_(True)
    ref = so.sorted_l1_reference(s_r, t, 1)
    (g_r,) = torch.autograd.grad(ref, [s_r])
    assert abs(loss.item() - ref.item()) <= 1e-5 * abs(ref.item())
    assert torch.equal(g_s, g_r) and g_t.abs().max().item() == 0.0
    _, sign = so.kernel_sorted_l1_fwd(s, t)
    assert torch.equal(sign, so._plain_sl1_fwd(s, t)[1])
    with pytest.raises(ValueError):
        so.sorted_l1(s.double(), t.double(), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 198, 64), (1, 2, 50, 64), (6, 16, 64), (1, 1, 578, 64),
                                   (2, 6, 578, 64), (1, 2, 656, 64)])
def test_attention_kernels_match_plain_version_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(shape[-2])
    q, k = (2 * torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    v, do = (torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    o, lse = at.kernel_flash_fwd(q, k, v)
    r_o, r_lse = at._plain_fwd(q, k, v)
    _within(o, r_o)
    assert (lse - r_lse).abs().max().item() <= 1e-3
    grads = at.kernel_flash_bwd(q, k, v, o, lse, do)
    for a, b, c in zip(grads, at._plain_bwd(q, k, v, o, lse, do),
                       at.kernel_flash_bwd(q, k, v, o, lse, do)):
        _within(a, b)
        assert torch.equal(a, c)
    if len(shape) == 4:     # through the autograd Function, on strided views
        B, H, N, D = shape
        qkv = torch.randn(B, N, 3, H, D, generator=g).cuda().bfloat16().requires_grad_(True)
        views = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        at.reset_launches()
        (g_k,) = torch.autograd.grad(at.flash_attention(*views), [qkv], do)
        assert at.LAUNCHES == {("flash_fwd", B * H): 1, ("flash_bwd", B * H): 1}
        (g_r,) = torch.autograd.grad(at.reference_attention(*views), [qkv], do)
        _within(g_k, g_r)
    with pytest.raises(ValueError):
        at.kernel_flash_fwd(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        at.kernel_flash_fwd(q[..., :32], k[..., :32], v[..., :32])
    long = torch.zeros(1, 1, at.max_sequence() + 1, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        at.kernel_flash_bwd(long, long, long, long, long[..., 0].float(), long)


def _mlp_operands(M, D):
    """x and dy in bf16, fp32 weights and biases (the model's parameters, as
    the model passes them), on the card."""
    g = torch.Generator().manual_seed(M)
    F = 4 * D
    x, dy = (torch.randn(M, D, generator=g).cuda().bfloat16() for _ in range(2))
    w1 = (torch.randn(F, D, generator=g) / D ** 0.5).cuda()
    w2 = (torch.randn(D, F, generator=g) / F ** 0.5).cuda()
    b1, b2 = ((0.1 * torch.randn(n, generator=g)).cuda() for n in (F, D))
    return x, w1, b1, w2, b2, dy


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1000, 37, 130])
@pytest.mark.parametrize("D", [192, 384, 768, 1024])
def test_mlp_kernels_match_plain_version_on_card(M, D):
    """Every width of the model zoo (one to four column passes of the
    forward) at ragged M, on fp32 parameters as the model passes them; two
    runs give the same bits. On bf16 weights and bf16-rounded biases (nothing
    for the wrapper to cast) the forward allocates its output and nothing of
    size M x F, and gives the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, w1, b1, w2, b2, dy = _mlp_operands(M, D)
    F = 4 * D
    out = fm.kernel_fused_mlp(x, w1, b1, w2, b2)
    _within(out, fm._plain_fwd(x, w1, b1, w2, b2))
    assert torch.equal(out, fm.kernel_fused_mlp(x, w1, b1, w2, b2))
    grads = fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy)
    for a, b in zip(grads, fm._plain_bwd(x, w1, b1, w2, dy)):
        _within(a, b)
    assert all(torch.equal(a, b) for a, b in zip(grads, fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy)))
    ops = [t.clone().requires_grad_(True) for t in (x.reshape(1, M, D), w1, b1, w2, b2)]
    fm.reset_launches()
    grads = torch.autograd.grad(fm.fused_mlp_train(*ops), ops, dy.reshape(1, M, D))
    assert fm.LAUNCHES == {("fused_mlp_fwd", D): 1, ("fused_mlp_bwd", D): 1}
    assert [t.dtype for t in grads] == [t.dtype for t in ops]
    with pytest.raises(RuntimeError, match="forward only"):
        fm.fused_mlp(*ops)
    with pytest.raises(ValueError):
        fm.kernel_fused_mlp(x.float(), w1, b1, w2, b2)

    lp = [w1.bfloat16(), b1.bfloat16().float(), w2.bfloat16(), b2.bfloat16().float()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out_lp = fm.kernel_fused_mlp(x, *lp)
    torch.cuda.synchronize()
    # the output, and the biases rounded to bf16 and held in fp32
    assert torch.cuda.max_memory_allocated() - before <= M * D * 2 + 4 * (F + D) + 2048
    assert torch.cuda.max_memory_allocated() - before < M * F * 2
    assert torch.equal(out_lp, out)


@pytest.mark.cuda
def test_mlp_backward_at_a_width_the_forward_refuses_on_card():
    """D = 64 (no model's width): the backward kernel takes it and holds
    against its plain version, two runs the same bits; the forward refuses it
    with ValueError and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    M, D = 37, 64
    x, w1, b1, w2, b2, dy = _mlp_operands(M, D)
    grads = fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy)
    for a, b in zip(grads, fm._plain_bwd(x, w1, b1, w2, dy)):
        _within(a, b)
    assert all(torch.equal(a, b) for a, b in zip(grads, fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy)))
    fm.reset_launches()
    with pytest.raises(ValueError, match="takes no width"):
        fm.kernel_fused_mlp(x, w1, b1, w2, b2)
    assert not fm.LAUNCHES


def _fp32_soft_step(device):
    """One soft-KD train step of DeiT-Small -> DeiT-Tiny at 32 px, batch 4,
    from an fp32 TrainConfig through load_teacher_student: no kernel is
    given to either model and none launches; finite metrics and a changed
    student. Returns the metrics."""
    import numpy as np

    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.data.mixup import MixupConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224", batch_size=4,
                      distillation_type="soft", dataset="cifar-100", input_size=32,
                      dtype="float32", drop_path_rate=0.1, epochs=300, aa="",
                      color_jitter=0.0, allow_random_teacher=True)
    teacher, student, aux = load_teacher_student(cfg, seed=0, device=device)
    for model in (teacher, student):
        assert all(getattr(model, f) is None
                   for f in ("block_fn", "block_pair_fn", "attention_fn", "mlp_fn"))
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 100)
    state = TrainState(student, tx=tx, aux=aux)
    kd = KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                teacher_prefix=teacher.cfg.num_prefix_tokens)
    step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher, aux=aux,
                            aug=AugmentConfig.from_config(cfg),
                            mixup=MixupConfig.from_config(cfg, student.cfg.num_classes), tx=tx)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (4, 32, 32, 3), dtype=np.uint8)).to(device)
    labels = torch.from_numpy(rng.randint(0, student.cfg.num_classes, (4,))).to(device)
    before = state.params.clone()
    for mod in (fb, at, fm, so):
        mod.reset_launches()
    metrics = {k: float(v) for k, v in
               step(state, images, labels, torch.Generator(device=device).manual_seed(1)).items()}
    assert not any(mod.LAUNCHES for mod in (fb, at, fm, so))
    assert all(np.isfinite(v) for v in metrics.values())
    assert (state.params - before).abs().max().item() > 0
    return metrics


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_fp32_soft_kd_step_runs_without_kernels(device):
    """The kernels take bf16 only; an fp32 config trains on PyTorch's own ops,
    on the card as on the CPU."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.set_num_threads(1)
    _fp32_soft_step(device)


# -----------------------------------------------------------------------------
# The train-time data path and the teacher import
# -----------------------------------------------------------------------------

RA_SPEC, AA_SPEC = "rand-m9-mstd0.5-inc1", "original-mstd0.5"
CIFAR_STD = (0.2675, 0.2565, 0.2761)


def _close_pixels(a, b, tol, level):
    """At most ``level`` + ``tol`` anywhere, under 1% of the values beyond
    ``tol`` (as tests/test_torch_augment_transform.py holds the port to JAX)."""
    diff = (a.float().cpu() - b.float().cpu()).abs()
    assert diff.max().item() <= level + tol, diff.max().item()
    assert (diff > tol).float().mean().item() < 0.01


def _u8_batch(B, H, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, 256, (B, H, H, 3), dtype=np.uint8)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 256])
@pytest.mark.parametrize("spec", [RA_SPEC, AA_SPEC])
def test_augment_on_card_matches_cpu(spec, H):
    """The RA and AA train transform at 224 px in bf16 on the card against the
    CPU on the same draws, stage by stage: from 32 px the geometric ops run as
    a dense warp at the source, from 256 px as a gather warp at the output
    (integer pixels, where a sum that differs in its last bit flips a
    rounding: one level at each of the bicubic resample's two); the pixel
    stage from the same integers. Two runs on the card give the
    same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data import augment as ta

    ac = ta.AugmentConfig.from_config(TrainConfig(dataset="cifar-100", aa=spec))
    u8 = _u8_batch(32, H)
    d = ta.draw_train_transform(torch.Generator(device="cuda").manual_seed(0), u8.shape, ac,
                                device="cuda")
    d_cpu = ta.draws_to(d, "cpu")
    geo = ta.geometric_stage(u8, ac, d)
    geo_cpu = ta.geometric_stage(u8.cpu(), ac, d_cpu)
    # a rounding flip of one level at each of the bicubic resample's two roundings
    _close_pixels(geo, geo_cpu, tol=1e-3, level=2.0)
    level = 1.0 / (255.0 * min(CIFAR_STD))
    _close_pixels(ta.pixel_stage(geo_cpu.cuda(), ac, d), ta.pixel_stage(geo_cpu, ac, d_cpu),
                  tol=1.6e-2, level=level)
    assert torch.equal(ta.apply_train_transform(u8, ac, d), ta.apply_train_transform(u8, ac, d))


@pytest.mark.cuda
def test_transform_and_mixup_do_not_sync():
    """No host sync in the train transform (every policy and variant, both
    warp sides) or in mixup (every mode): torch.cuda's sync debug mode
    'error' raises on any synchronising call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data import augment as ta
    from deltakd_tpu_torch.data import mixup as tm

    variants = [dict(aa=RA_SPEC), dict(aa=AA_SPEC), dict(ThreeAugment=True), dict(src=True),
                dict(aa="", color_jitter=0.3), dict(aa=RA_SPEC, aug_pixel_bf16=False)]
    labels = torch.arange(16, device="cuda") % 100
    gen = torch.Generator(device="cuda").manual_seed(0)
    for H in (32, 256):
        u8 = _u8_batch(16, H)
        for kw in variants:
            ac = ta.AugmentConfig.from_config(TrainConfig(dataset="cifar-100", **kw))
            ta.train_transform(gen, u8, ac)             # warm-up: handles, caches
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = ta.train_transform(gen, u8, ac)
                for mode in ("batch", "pair", "elem"):
                    tm.apply_mixup(gen, out, labels, tm.MixupConfig(num_classes=100, mode=mode))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()


@pytest.mark.cuda
def test_recipe_soft_step_on_card(tmp_path):
    """One fused soft-KD step with TrainConfig's defaults (RandAugment, mixup,
    erasing 0.25, bf16 pixel stage) and the teacher from a written
    checkpoint: both heads skipped, the grid interpolated to 14 x 14, the
    fused-block kernels launched, finite metrics."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from chip_smoke import write_teacher_checkpoint
    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.data.mixup import MixupConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from deltakd_tpu_torch.train.step import build_train_step

    path = str(tmp_path / "deit_small_distilled.pth")
    state = write_teacher_checkpoint(path)
    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224",
                      student_model="deit_tiny_distilled_patch16_224", batch_size=8,
                      distillation_type="soft", dataset="cifar-100", weight_decay=1e-4,
                      alpha=0.1, tau=3.0, teacher_checkpoint=path)
    teacher, student, aux = load_teacher_student(cfg, seed=0, device="cuda")
    report = teacher.import_report
    assert report["skipped"] == ["head.weight", "head.bias", "head_dist.weight",
                                 "head_dist.bias"]
    assert teacher.pos_embed.shape == (1, 2 + 14 * 14, 384)
    assert torch.equal(teacher.blocks[5].mlp.fc1.weight.cpu(), state["blocks.5.mlp.fc1.weight"])
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 100)
    state_ = TrainState(student, tx=tx, aux=aux)
    kd = KDSettings.from_config(cfg, student_prefix=2, teacher_prefix=2)
    step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher, aux=aux,
                            aug=AugmentConfig.from_config(cfg),
                            mixup=MixupConfig.from_config(cfg, 100), tx=tx)
    images = _u8_batch(8, 32)
    labels = torch.arange(8, device="cuda")
    fb.reset_launches()
    metrics = {k: float(v) for k, v in
               step(state_, images, labels, torch.Generator(device="cuda").manual_seed(1)).items()}
    assert fb.LAUNCHES == {("fused_block_fwd", 384): 12, ("fused_block_fwd", 192): 12,
                           ("fused_block_bwd", 192): 12}
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["distill_loss"] > 0
