"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Run on a machine with an NVIDIA GPU (no JAX needed there):
    python -m pytest tests/test_torch_cuda.py -m cuda
Without a card the tests skip: a CUDA kernel has no CPU mode. The fused
block: small shape (D=128, 2 heads of 64, N=18) with drop-path scales of 0
and 1/keep, and the forward and the backward (with and without a feature
cotangent) at N in (50, 197, 198, 578, 786, 1026) for D in (192, 384, 768), and at
B = 32, D = 192 for N = 786 and 1026 beside flash_bwd there (the attention backward's
split route at 96 heads), whose split route forced at N = 198 and 704 gives the bits of
its short route, forced too; bf16 operands, so
the tolerance is 2e-2 of the largest reference value. The GEMM alone: the
forward's products against F.linear plus their epilogue, the backward's input
gradient with the GELU derivative as `mul` and its weight gradients against
their plain versions, same tolerance, two runs the same bits. An fp32 soft-KD
train step through the factory, which gives an fp32 config the fused block:
its fp32 kernels on the card, its plain version on the CPU (the one case here
that runs without a card). The fp32 forms of the block and attention kernels
at B=8 (chip_smoke.py phase 13's criterion): each error against the plain
fp32 version (TF32 off) at most 0.02 of the bf16 kernel's on the same
inputs (every fp32 product is 3xTF32), or below 1e-6 of the largest value;
two runs the same bits; the same for the fp32 weight gradient alone at the
backward's four shapes and M = 1001, 1584, 50688, for the fp32 linear
product alone at the forward's four products and the backward's four input
gradients (D = 192, 384; M = 1001, 50688), whose weight split also equals
its plain version bit for bit, for the MLP forward's and
backward's fp32 forms at every zoo width and for the block pair's fp32 forms in the four
feature variants, and a paired fp32 soft-KD step (6 fp32 pair forwards and 6
fp32 pair backwards; its `cpu` case runs without a card). The
block-pair kernels: the four (feat1, feat2) variants at D=192 and D=384 on
weights of std 1/sqrt(fan-in), scales with zeros, through the kernels alone
and through the autograd Function. The sort kernels: inputs with ties (+0.0 tied with a later -0.0 from
n = 4 on), n from 2 to 1296 (past one warp's 1024 keys); the value sort also in fp16 and int32 with NaN, +-inf and
the int32 extremes, against torch.sort (NaNs at the same places); sorted values, signs and gradients exactly, the loss to 1e-5 (fp32 sums in
another order); on the long route (n > 4096) at n = 4097, 8192, 16641,
65536 with NaN, +-inf and -0.0, sorted_l1 also with NaN (sign(NaN) read as
0). The attention and MLP
kernels: O(1) bf16 inputs (q, k of std 2, weights of std 1/sqrt(fan-in)), ragged
N and M; 2e-2 of the largest reference value, 1e-3 absolute on lse; rows 3
and 4 at [1, 47105, 64] (past the old cap of 47,104; the plain versions in
1024-row chunks) and at 65,537 batch x heads, row 1 at 21,846 x 3 heads. The
train-time data path: the RA and AA transform at 224 px on the card against
the CPU on the same draws (as chip_smoke.py phase 9), no host sync in the
transform or in mixup, and a fused soft-KD step with TrainConfig's defaults
and a teacher imported from a checkpoint written with chip_smoke.py's
``write_teacher_checkpoint``. The recipes' objectives: one fused step of
WassKD-sinkhorn, Saliency-MGD, LRKD, DiffKD, CurKD (epochs 0, 120, 200) and
hard KD in their exp/*.sh configurations at batch 8 (the DeiT-Ti without a
distillation token, N = 197, but for hard), and the Sinkhorn divergence with
TF32 on in the process: the same bits as with it off. The runtime: run() of
two tiny epochs on the card against the same run on the CPU (launch counts
per train step and eval batch, the losses to 5e-2 relative). Learning:
chip_smoke.py phase 16a's fused bf16 route, 100 steps of the 224 px texture
task, train and held-out top-1 above 85%.
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
@pytest.mark.parametrize("n_tok", [50, 197, 198, 578, 786, 1026])
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
@pytest.mark.parametrize("n_tok", [50, 197, 198, 578, 786, 1026])
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
    # no length cap is left: a head dim the kernels have no instantiation for
    # is what they refuse, before any launch
    fb.reset_launches()
    with pytest.raises(ValueError):
        fb.kernel_block_bwd(x, params, g_out, None, num_heads=heads * 2)
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
    # fp32 x takes the pair's fp32 form, with fp32 weights only
    mixed = {n: t.bfloat16() if t.dim() == 2 else t for n, t in p1.items()}
    with pytest.raises(ValueError, match="fp32 x takes fp32 weights"):
        fb.kernel_block_pair_fwd(x.float(), mixed, p2, **kw)


def _within(a, b, tol=2e-2):
    a, b = a.float(), b.float()
    assert (a - b).abs().max().item() <= tol * b.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32, torch.int32])
@pytest.mark.parametrize("shape", [(3, 196, 40), (2, 2, 5), (2, 1024, 20), (4, 33, 1),
                                   (2, 1296, 20)])
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
                                   (2, 1024, 20), (2, 33, 40), (4, 196, 384), (2, 1296, 20)])
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
                                   (2, 6, 578, 64), (1, 2, 656, 64), (1, 2, 786, 64),
                                   (1, 2, 1026, 64)])
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
    with pytest.raises(ValueError):   # a mix of dtypes
        at.kernel_flash_fwd(q.float(), k, v)
    with pytest.raises(ValueError):
        at.kernel_flash_fwd(q[..., :32], k[..., :32], v[..., :32])
    # no length cap is left (the bf16 kernels took N up to 47,104 before):
    # a row past it runs on both kernels (test_attention_past_the_old_limits_on_card)
    assert not hasattr(at, "max_sequence") and not hasattr(at, "KERNEL_MAX_N")


@pytest.mark.cuda
@pytest.mark.parametrize("n_tok", [786, 1026])
def test_long_attention_backward_at_96_heads_on_card(n_tok):
    """The bf16 attention backward's split route (N > 256) at B = 32 and 3
    heads (B*H = 96: the student at 448 and 512 px): flash_bwd and the block
    backward (D = 192, drop-path scales with zeros) within the plain
    version's tolerance, two runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(n_tok + 25)
    shape = (32, 3, n_tok, 64)
    q, k = (2 * torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    v, do = (torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    o, lse = at.kernel_flash_fwd(q, k, v)
    at.reset_launches()
    grads = at.kernel_flash_bwd(q, k, v, o, lse, do)
    assert at.LAUNCHES == {("flash_bwd", 96): 1}
    for a, b, c in zip(grads, at._plain_bwd(q, k, v, o, lse, do),
                       at.kernel_flash_bwd(q, k, v, o, lse, do)):
        _within(a, b)
        assert torch.equal(a, c)
    del q, k, v, do, o, lse, grads
    params = _block_params(192, g)
    x, g_out = (torch.randn(32, n_tok, 192, generator=g).cuda().bfloat16() for _ in range(2))
    drop = torch.where(torch.arange(32) % 4 == 0, 0.0, 1 / 0.9).cuda()
    kw = dict(num_heads=3, scale_attn=drop, scale_mlp=drop.flip(0))
    dx, dws = fb.kernel_block_bwd(x, params, g_out, None, **kw)
    dx2, dws2 = fb.kernel_block_bwd(x, params, g_out, None, **kw)
    r_dx, r_dws = fb.reference_vit_block_bwd(x, params, g_out, None, **kw)
    _within(dx, r_dx)
    assert torch.equal(dx, dx2)
    for n in fb.PARAM_NAMES:
        _within(dws[n], r_dws[n])
        assert torch.equal(dws[n], dws2[n])


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n_tok", [(96, 198), (96, 704)])
def test_split_route_gives_the_short_routes_bits_on_card(bh, n_tok):
    """The bf16 attention backward's two routes, each forced: the same
    products and sums in the same order, so the split route's dq, dk and dv
    come out with the short route's bits. The forced routes are bf16 only,
    the short one up to 704 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(bh + n_tok)
    shape = (bh, n_tok, 64)
    q, k = (1.5 * torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    v, do = (torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    o, lse = at.kernel_flash_fwd(q, k, v)
    at.reset_launches()
    short = at.kernel_flash_bwd(q, k, v, o, lse, do, route="short")
    split = at.kernel_flash_bwd(q, k, v, o, lse, do, route="split")
    assert at.LAUNCHES == {("flash_bwd_short", bh): 1, ("flash_bwd_split", bh): 1}
    for a, b in zip(split, short):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bf16 only"):
        at.kernel_flash_bwd(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                            route="split")
    long = torch.zeros(1, 1, at.SHORT_ROUTE_MAX_N + 1, 64, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="short route"):
        at.kernel_flash_bwd(long, long, long, long, long[..., 0].float(), long, route="short")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 3])
@pytest.mark.parametrize("n", [4097, 8192, 16641, 65536])
def test_long_sorts_match_plain_version_on_card(n, d):
    """Rows 9 and 10 (and 11 behind them) on the long route (n > 4096: runs
    of 4096 rows sorted in the block, the merge stages of stride 4096 and up
    in device memory): the value sort in its four dtypes with NaN, +-inf and
    -0.0 against torch.sort (the NaNs last), sorted_l1 in bf16 and fp32 with
    ties, +0.0 tied with a later -0.0 and NaN (sign bit clear) against the
    plain stable sort, sign(NaN) read as 0: values, signs and gradient
    exactly, the loss to 1e-5 where it is finite; two runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(n + d)
    shape = (2, n, d)
    for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.int32):
        if dtype == torch.int32:
            x = torch.randint(-40, 40, shape, generator=g, dtype=torch.int32)
            x.view(-1)[:4] = torch.tensor([-2**31, 2**31 - 1, 2**31 - 1, 0], dtype=torch.int32)
        else:
            x = (torch.randn(shape, generator=g) * 4).round() / 4
            x.view(-1)[torch.randperm(x.numel(), generator=g)[:x.numel() // 100]] = float("nan")
            x.view(-1)[:4] = torch.tensor([-0.0, float("inf"), 0.0, -float("inf")])
            x = x.to(dtype)
        x = x.cuda()
        if dtype.is_floating_point:
            x = torch.where(torch.isnan(x), x.abs(), x)   # the card sorts -NaN first
        so.reset_launches()
        out = so.bitonic_sort(x, axis=1)
        assert so.LAUNCHES == {"bitonic_sort": so.launches_per_call(n)}
        ref = torch.sort(x, dim=1).values
        nan = torch.isnan(ref) if dtype.is_floating_point else torch.zeros_like(ref, dtype=torch.bool)
        assert torch.equal(out[~nan], ref[~nan])
        if dtype.is_floating_point:
            assert torch.equal(torch.isnan(out), nan)
            neg_zero = lambda t: ((t == 0) & torch.signbit(t)).sum(dim=1)
            assert torch.equal(neg_zero(out), neg_zero(x))
        bits = torch.int16 if dtype.itemsize == 2 else torch.int32
        assert torch.equal(out.view(bits), so.bitonic_sort(x, axis=1).view(bits))
    for dtype in (torch.bfloat16, torch.float32):
        for with_nan in (False, True):
            s = (torch.randn(shape, generator=g) * 4).round().div(4).to(dtype)
            t = (torch.randn(shape, generator=g) * 4).round().div(4).to(dtype)
            s[:, 2], s[:, 3] = 0.0, -0.0
            if with_nan:
                s.view(-1)[torch.randperm(s.numel(), generator=g)[:s.numel() // 100]] = float("nan")
                t.view(-1)[torch.randperm(t.numel(), generator=g)[:t.numel() // 100]] = float("nan")
            s, t = (torch.where(torch.isnan(a), a.abs(), a) for a in (s.cuda(), t.cuda()))
            so.reset_launches()
            total, sign = so.kernel_sorted_l1_fwd(s, t)
            total2, sign2 = so.kernel_sorted_l1_fwd(s, t)
            s_sorted, idx = torch.sort(s, dim=1, stable=True)
            diff = s_sorted.float() - torch.sort(t, dim=1).values.float()
            ref = torch.zeros(shape, dtype=torch.int8, device="cuda")
            ref.scatter_(1, idx, torch.nan_to_num(torch.sign(diff), nan=0.0).to(torch.int8))
            assert torch.equal(sign, ref) and torch.equal(sign, sign2)
            r_total = diff.abs().sum()
            if with_nan:
                assert torch.isnan(total) and torch.isnan(r_total) and torch.isnan(total2)
            else:
                assert abs(total.item() - r_total.item()) <= 1e-5 * abs(r_total.item())
                assert total.item() == total2.item()
            scale = torch.ones((), device="cuda") / s.numel()
            assert torch.equal(so.kernel_sorted_l1_bwd(sign, scale, dtype),
                               so._plain_sl1_bwd(ref, scale, dtype))
            assert so.LAUNCHES == {"sorted_l1_fwd": 2 * so.launches_per_call(n, 2),
                                   "sorted_l1_bwd": 1}


@pytest.mark.cuda
def test_attention_past_the_old_limits_on_card():
    """Rows 3 and 4 at [1, 47105, 64], a row past the bf16 kernels' old cap
    of 47,104 (the split route's backward): against the plain versions in
    1024-row query chunks (one head's [N, N] fp32 scores take 8.9 GB), 2e-2
    of the largest value, lse to 1e-3; two runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(47105)
    shape = (1, 1, 47105, 64)
    q, k = (1.5 * torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    v, do = (torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    at.reset_launches()
    o, lse = at.kernel_flash_fwd(q, k, v)
    grads = at.kernel_flash_bwd(q, k, v, o, lse, do)
    assert at.LAUNCHES == {("flash_fwd", 1): 1, ("flash_bwd", 1): 1}
    r_o, r_lse = at._plain_fwd_rows(q, k, v)
    _within(o, r_o)
    assert (lse - r_lse).abs().max().item() <= 1e-3
    o2, lse2 = at.kernel_flash_fwd(q, k, v)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, b, c in zip(grads, at._plain_bwd_rows(q, k, v, o, lse, do),
                       at.kernel_flash_bwd(q, k, v, o, lse, do)):
        _within(a, b)
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_past_65535_batch_heads_on_card():
    """Grids past 65,535 batch x heads, where gridDim.y would stop: rows 3 and
    4 at B*H = 65,537 (N = 8) and row 1 (the block forward, D = 192, 3
    heads) at B = 21,846 (B*H = 65,538), against their plain versions; two
    runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(65537)
    shape = (65537, 8, 64)
    q, k = (1.5 * torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    v, do = (torch.randn(shape, generator=g).cuda().bfloat16() for _ in range(2))
    o, lse = at.kernel_flash_fwd(q, k, v)
    r_o, r_lse = at._plain_fwd(q, k, v)
    _within(o, r_o)
    assert (lse - r_lse).abs().max().item() <= 1e-3
    assert torch.equal(o, at.kernel_flash_fwd(q, k, v)[0])
    for a, b in zip(at.kernel_flash_bwd(q, k, v, o, lse, do), at._plain_bwd(q, k, v, o, lse, do)):
        _within(a, b)
    params = _block_params(192, g)
    x = torch.randn(21846, 8, 192, generator=g).cuda().bfloat16()
    kw = dict(num_heads=3, scale_attn=torch.full((21846,), 1 / 0.9).cuda(),
              scale_mlp=torch.ones(21846).cuda())
    out, _ = fb.kernel_block_fwd(x, params, **kw)
    r_out, _ = fb.reference_vit_block(x, params, **kw)
    _within(out.float() - x.float(), r_out.float() - x.float())
    assert torch.equal(out, fb.kernel_block_fwd(x, params, **kw)[0])


def _mlp_operands(M, D, F=None):
    """x and dy in bf16, fp32 weights and biases (the model's parameters, as
    the model passes them), on the card; F = 4 D by default."""
    g = torch.Generator().manual_seed(M)
    F = F or 4 * D
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
    with pytest.raises(ValueError, match="fp32 x takes fp32 weights"):
        fm.kernel_fused_mlp(x.float(), w1.bfloat16(), b1, w2, b2)

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
@pytest.mark.parametrize("M", [37, 1000])
@pytest.mark.parametrize("D,F", [(192, 192), (192, 64), (384, 192), (384, 320), (768, 192),
                                 (192, 96), (192, 32), (384, 96), (768, 224)])
def test_mlp_forward_at_the_shard_widths_on_card(M, D, F):
    """A model rank's hidden shard of F = 4D under tensor parallelism, F a
    multiple of 64 but not of 128 (DeiT-Ti at a model axis of 4 and 12,
    DeiT-S at 8, DeiT-B at 16), F = 320, or an odd multiple of 32 (DeiT-Ti
    at 8, DeiT-S at 16: the plan's 32-wide tail chunk): one warpgroup's plan
    in D / 192 passes, against the plain version; two runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    x, w1, b1, w2, b2, _ = _mlp_operands(M, D, F)
    fm.reset_launches()
    out = fm.kernel_fused_mlp(x, w1, b1, w2, b2)
    assert fm.LAUNCHES == {("fused_mlp_fwd", D): 1}
    _within(out, fm._plain_fwd(x, w1, b1, w2, b2))
    assert torch.equal(out, fm.kernel_fused_mlp(x, w1, b1, w2, b2))


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


def _f32_within(a32, a16, ref, ratio=0.02, floor=1e-6):
    """chip_smoke.py phase 13's criterion: the fp32 kernel's largest error
    against the plain fp32 version, over the plain version's largest value,
    at most ``ratio`` of the bf16 kernel's on the same inputs (every fp32
    product is 3xTF32, about fp32 accuracy), or below ``floor``."""
    ref = ref.float()
    mx = ref.abs().max().item()
    e32 = (a32.float() - ref).abs().max().item() / mx
    e16 = (a16.float() - ref).abs().max().item() / mx
    assert e32 <= ratio * e16 or e32 <= floor, (e32, e16)


@pytest.fixture
def tf32_off():
    """The plain fp32 versions in full fp32: TF32 off in PyTorch's products
    and convolutions, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("need_feat", [False, True])
@pytest.mark.parametrize("width,heads,n_tok", [(192, 3, 198), (384, 6, 197)])
def test_fp32_block_kernels_match_plain_version_on_card(width, heads, n_tok, need_feat,
                                                        tf32_off):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(width + n_tok + need_feat)
    p = _block_params(width, g)
    x = torch.randn(8, n_tok, width, generator=g).cuda()
    keep = 0.9
    kw = dict(num_heads=heads,
              scale_attn=torch.tensor([0, 1 / keep, 1, 1, 1 / keep, 1, 0, 1]).cuda(),
              scale_mlp=torch.tensor([1 / keep, 0, 1, 1, 1, 1 / keep, 1, 0]).cuda())
    g_out = torch.randn(x.shape, generator=g).cuda()
    g_feat = torch.randn(x.shape, generator=g).cuda() if need_feat else None
    fb.reset_launches()
    out, feat = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)
    dx, dws = fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)
    assert fb.LAUNCHES == {("fused_block_fwd_f32", width): 1, ("fused_block_bwd_f32", width): 1}
    assert out.dtype == dx.dtype == torch.float32
    out16, feat16 = fb.kernel_block_fwd(x.bfloat16(), p, need_features=True, **kw)
    dx16, dws16 = fb.kernel_block_bwd(x.bfloat16(), p, g_out, g_feat, **kw)
    r_out, r_feat = fb.reference_vit_block(x, p, **kw)
    r_dx, r_dws = fb.reference_vit_block_bwd(x, p, g_out, g_feat, **kw)
    _f32_within(out - x, out16.float() - x, r_out - x)
    if need_feat:
        _f32_within(feat, feat16, r_feat)
    _f32_within(dx, dx16, r_dx)
    for name in fb.PARAM_NAMES:
        _f32_within(dws[name], dws16[name], r_dws[name])
    again, dx2 = fb.kernel_block_fwd(x, p, need_features=need_feat, **kw)[0], \
        fb.kernel_block_bwd(x, p, g_out, g_feat, **kw)[0]
    assert torch.equal(out, again) and torch.equal(dx, dx2)
    mixed = {n: t.bfloat16() if t.dim() == 2 else t for n, t in p.items()}
    with pytest.raises(ValueError, match="fp32 x takes fp32 weights"):
        fb.kernel_block_fwd(x, mixed, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1001, 1584, 50688])
@pytest.mark.parametrize("O,I", [(192, 768), (768, 192), (576, 192), (192, 192)])
def test_fp32_weight_grad_matches_plain_version_on_card(M, O, I, tf32_off):
    """The fp32 weight gradient alone (dk_weight_grad_sm90_f32: G and X read
    as they lie, their K-major TF32 operands made on chip) against the plain
    fp32 product with TF32 off, by phase 13's criterion beside the bf16
    kernel on G and X rounded to bf16; M not a multiple of the 32-row
    k-block; two runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(M + O + I)
    G = torch.randn(M, O, generator=g).cuda()
    X = torch.randn(M, I, generator=g).cuda()
    fb.reset_launches()
    dw = fb.kernel_weight_grad(G, X)
    assert fb.LAUNCHES == {("weight_grad_sm90_f32", O): 1}
    assert dw.dtype == torch.float32 and dw.shape == (O, I)
    _f32_within(dw, fb.kernel_weight_grad(G.bfloat16(), X.bfloat16()),
                fb.plain_weight_grad(G, X, torch.float32))
    assert torch.equal(dw, fb.kernel_weight_grad(G, X))
    with pytest.raises(ValueError):
        fb.kernel_weight_grad(G, X.bfloat16())


# The forward's four products (N / D, K / D) and the backward's four input
# gradients (on W^T: N = I, K = O), with the epilogue each chain gives it.
LINEAR_F32_CASES = [("qkv", 3, 1), ("proj", 1, 1), ("fc1", 4, 1), ("fc2", 1, 4),
                    ("dgrad fc2", 4, 1), ("dgrad fc1", 1, 4), ("dgrad proj", 1, 1),
                    ("dgrad qkv", 1, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1001, 50688])
@pytest.mark.parametrize("D", [192, 384])
@pytest.mark.parametrize("name,n_mult,k_mult", LINEAR_F32_CASES)
def test_fp32_linear_matches_plain_version_on_card(name, n_mult, k_mult, D, M, tf32_off):
    """The fp32 linear product alone (dk_linear_sm90_f32: the weight split
    once into TF32 hi and lo with permuted k-step columns, A split in
    registers) against its plain fp32 version with TF32 off, by phase 13's
    criterion beside the bf16 kernel on the same inputs rounded to bf16, with
    the chains' epilogues (qkv's column scale, proj's residual, fc1's GELU
    and gelu', fc2's fp32 residual; fc2's input gradient times gelu' with its
    128-row column sums); M ragged against the 128-row tile; two runs the
    same bits. The weight's split alone, forward and transposed, equals
    tf32_split's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    N, K = n_mult * D, k_mult * D
    g = torch.Generator().manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g).cuda()
    w = (torch.randn(N, K, generator=g) / K ** 0.5).cuda()
    bias = None if name.startswith("dgrad") else (0.1 * torch.randn(N, generator=g)).cuda()
    kw = {}
    if name == "qkv":
        kw = dict(scale_cols=D, col_scale=0.125)
    elif name == "fc1":
        kw = dict(gelu=True)
    elif name in ("proj", "fc2"):
        rps = 198 if M % 198 == 0 else 7
        s = (torch.rand(M // rps, generator=g) < 0.9).float() / 0.9
        kw = dict(residual=torch.randn(M, N, generator=g).cuda(), res_scale=s.cuda(),
                  rows_per_sample=rps)
    elif name == "dgrad fc2":
        kw = dict(mul=(1.2 * torch.rand(M, N, generator=g) - 0.1).cuda())
    parts = [torch.empty((M + 127) // 128, N, device="cuda") for _ in range(3)] \
        if "mul" in kw else [None] * 3
    fb.reset_launches()
    got = fb.kernel_linear(a, w, bias, col_part=parts[0], **kw)
    assert fb.LAUNCHES == {("linear_sm90_f32", N): 1}
    got16 = fb.kernel_linear(a.bfloat16(), w.bfloat16(), bias, col_part=parts[1], **kw)
    ref = fb.plain_linear(a, w, bias, dtype=torch.float32, **kw)
    for g32, g16, r in zip(got, got16, ref):
        if g32 is not None:
            assert g32.dtype == torch.float32
            _f32_within(g32, g16, r)
    if parts[0] is not None:
        rows = torch.zeros(parts[0].shape[0] * 128, N, device="cuda")
        rows[:M] = ref[0]
        _f32_within(parts[0], parts[1], rows.view(-1, 128, N).sum(1))
    again = fb.kernel_linear(a, w, bias, col_part=parts[2], **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, again) if x is not None)
    assert parts[0] is None or torch.equal(parts[0], parts[2])
    for transposed in (False, True):
        hi, lo = fb.kernel_tf32_split(w, transposed)
        r_hi, r_lo, _ = fb.tf32_split(w.t() if transposed else w)
        assert torch.equal(hi, r_hi) and torch.equal(lo, r_lo)
    with pytest.raises(ValueError):
        fb.kernel_linear(a, w.bfloat16(), bias, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 198, 64), (1, 2, 50, 64), (4, 65, 64),
                                   (1, 1, 578, 64), (1, 2, 656, 64), (2, 3, 64, 64),
                                   (1, 2, 65, 64), (1, 2, 786, 64), (1, 2, 1026, 64),
                                   # the warp-specialised forward's edges (chip_smoke.py 13b)
                                   (4, 8, 64), (4, 9, 64), (4, 128, 64), (4, 129, 64),
                                   (4, 200, 64), (1, 1, 198, 64)])
def test_fp32_attention_kernels_match_plain_version_on_card(shape, tf32_off):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(shape[-2] + 1)
    q, k = (1.5 * torch.randn(shape, generator=g).cuda() for _ in range(2))
    v, do = (torch.randn(shape, generator=g).cuda() for _ in range(2))
    lp = [t.bfloat16() for t in (q, k, v, do)]
    at.reset_launches()
    o, lse = at.kernel_flash_fwd(q, k, v)
    grads = at.kernel_flash_bwd(q, k, v, o, lse, do)
    bh = shape[0] * (shape[1] if len(shape) == 4 else 1)
    assert at.LAUNCHES == {("flash_fwd_f32", bh): 1, ("flash_bwd_f32", bh): 1}
    o16, lse16 = at.kernel_flash_fwd(*lp[:3])
    grads16 = at.kernel_flash_bwd(*lp[:3], o16, lse16, lp[3])
    r_o, r_lse = at._plain_fwd(q, k, v)
    _f32_within(o, o16, r_o)
    _f32_within(lse, lse16, r_lse)
    for a, b, c, d in zip(grads, grads16, at._plain_bwd(q, k, v, r_o, r_lse, do),
                          at.kernel_flash_bwd(q, k, v, o, lse, do)):
        _f32_within(a, b, c)
        assert a.dtype == torch.float32 and torch.equal(a, d)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1584, 1001])
@pytest.mark.parametrize("D", [192, 384, 768, 1024])
def test_fp32_mlp_forward_matches_plain_version_on_card(M, D, tf32_off):
    """The MLP forward's fp32 form (fp32 x and parameters) against its plain
    fp32 version, beside the bf16 kernel on x rounded to bf16; two runs the
    same bits; fused_mlp_train at fp32 launches the fp32 forward and the fp32
    backward once each (the name of the backward's form: the test below)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, w1, b1, w2, b2, _ = _mlp_operands(M, D)
    x = torch.randn(M, D, generator=torch.Generator().manual_seed(D)).cuda()
    fm.reset_launches()
    out = fm.kernel_fused_mlp(x, w1, b1, w2, b2)
    assert fm.LAUNCHES == {("fused_mlp_fwd_f32", D): 1} and out.dtype == torch.float32
    _f32_within(out, fm.kernel_fused_mlp(x.bfloat16(), w1, b1, w2, b2),
                fm._plain_fwd(x, w1, b1, w2, b2))
    assert torch.equal(out, fm.kernel_fused_mlp(x, w1, b1, w2, b2))
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    fm.fused_mlp_train(*leaves).sum().backward()
    assert all(t.grad.dtype == torch.float32 and bool(t.grad.isfinite().all())
               for t in leaves)
    assert fm.LAUNCHES == {("fused_mlp_fwd_f32", D): 3, ("fused_mlp_fwd", D): 1,
                           ("fused_mlp_bwd_f32", D): 1}


def _fp32_soft_step(device, block_pair=False):
    """One soft-KD train step of DeiT-Small -> DeiT-Tiny at 32 px, batch 4,
    from an fp32 TrainConfig through load_teacher_student: both models get
    the fused block, which runs its fp32 forms on the card (12 + 12 block
    forwards and 12 block backwards, no bf16 launch) and its plain fp32
    version on the CPU (no launch); with ``block_pair`` the student runs
    block pairs (6 fp32 pair forwards and 6 fp32 pair backwards on the
    card). Finite metrics and a changed student. Returns the metrics."""
    from deltakd_tpu_torch.ops.fused_block import fused_vit_block, fused_vit_block_pair
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
    teacher, student, aux = load_teacher_student(cfg, block_pair=block_pair, seed=0,
                                                 device=device)
    for model in (teacher, student):
        assert model.block_fn is fused_vit_block
    assert teacher.block_pair_fn is None
    assert student.block_pair_fn is (fused_vit_block_pair if block_pair else None)
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
    launches = {k: n for mod in (fb, at, fm, so) for k, n in mod.LAUNCHES.items()}
    assert launches == ({} if device == "cpu" else {
        ("fused_block_fwd_f32", 384): 12, ("fused_pair_fwd_f32", 192): 6,
        ("fused_pair_bwd_f32", 192): 6} if block_pair else {
        ("fused_block_fwd_f32", 384): 12, ("fused_block_fwd_f32", 192): 12,
        ("fused_block_bwd_f32", 192): 12})
    assert all(np.isfinite(v) for v in metrics.values())
    assert (state.params - before).abs().max().item() > 0
    return metrics


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_fp32_soft_kd_step_runs_without_kernels(device):
    """An fp32 config trains through the fused block: its fp32 kernels on the
    card, its plain fp32 version on the CPU, and no other kernel either way.
    The name is from before the fp32 forms, when an fp32 config ran no
    kernel."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.set_num_threads(1)
    _fp32_soft_step(device)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_fp32_paired_soft_kd_step(device):
    """An fp32 config with block_pair trains the student on the pair's fp32
    forms on the card (the JAX factory turns the pair on at any dtype), on
    its plain fp32 version on the CPU."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.set_num_threads(1)
    _fp32_soft_step(device, block_pair=True)


@pytest.mark.cuda
@pytest.mark.parametrize("nf1,nf2", [(False, False), (True, False), (False, True),
                                     (True, True)])
@pytest.mark.parametrize("width,heads", [(192, 3), (384, 6)])
def test_fp32_pair_kernels_match_plain_version_on_card(width, heads, nf1, nf2, tf32_off):
    """The pair's fp32 forms (x, weights, cotangents fp32) against the plain
    fp32 pair, beside the bf16 pair kernels on x rounded to bf16; sample 0
    with all four scales 0 comes back as x; two runs the same bits; fp32 x
    with a bf16 weight is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(width + 2 * nf1 + nf2)
    p1, p2 = _block_params(width, g), _block_params(width, g)
    x = torch.randn(8, 198, width, generator=g).cuda()
    keep = 0.9
    scales = tuple(torch.tensor(s).cuda() for s in (
        [0, 1 / keep, 1, 1, 1 / keep, 1, 0, 1], [0, 0, 1, 1, 1, 1 / keep, 1, 0],
        [0, 1, 0, 1, 1, 1, 1 / keep, 1], [0, 1, 1, 0, 1 / keep, 1, 1, 1]))
    g_out, g_f1, g_f2 = (torch.randn(x.shape, generator=g).cuda() for _ in range(3))
    g_f1, g_f2 = (g_f1 if nf1 else None), (g_f2 if nf2 else None)
    kw = dict(num_heads=heads, scales=scales)
    fkw = dict(need_features1=nf1, need_features2=nf2, **kw)
    fb.reset_launches()
    out, f1, f2 = fb.kernel_block_pair_fwd(x, p1, p2, **fkw)
    dx, dw1, dw2 = fb.kernel_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)
    assert fb.LAUNCHES == {("fused_pair_fwd_f32", width): 1, ("fused_pair_bwd_f32", width): 1}
    assert out.dtype == dx.dtype == torch.float32 and torch.equal(out[0], x[0])
    out16, f1_16, f2_16 = fb.kernel_block_pair_fwd(x.bfloat16(), p1, p2, **fkw)
    dx16, dw1_16, dw2_16 = fb.kernel_block_pair_bwd(x.bfloat16(), p1, p2, g_out, g_f1, g_f2,
                                                    **kw)
    r_out, r_f1, r_f2 = fb.reference_vit_block_pair(x, p1, p2, **kw)
    r_dx, r_dw1, r_dw2 = fb.reference_vit_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)
    _f32_within(out - x, out16.float() - x, r_out - x)
    for flag, a, b, c in ((nf1, f1, f1_16, r_f1), (nf2, f2, f2_16, r_f2)):
        assert (a is not None) == flag
        if flag:
            _f32_within(a, b, c)
    _f32_within(dx, dx16, r_dx)
    for dw, dw16, r_dw in ((dw1, dw1_16, r_dw1), (dw2, dw2_16, r_dw2)):
        for name in fb.PARAM_NAMES:
            _f32_within(dw[name], dw16[name], r_dw[name])
    assert torch.equal(out, fb.kernel_block_pair_fwd(x, p1, p2, **fkw)[0])
    assert torch.equal(dx, fb.kernel_block_pair_bwd(x, p1, p2, g_out, g_f1, g_f2, **kw)[0])
    mixed = {n: t.bfloat16() if t.dim() == 2 else t for n, t in p2.items()}
    with pytest.raises(ValueError, match="fp32 x takes fp32 weights"):
        fb.kernel_block_pair_fwd(x, p1, mixed, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1584, 1001])
@pytest.mark.parametrize("D", [192, 384, 768, 1024])
def test_fp32_mlp_backward_matches_plain_version_on_card(M, D, tf32_off):
    """The MLP backward's fp32 form (fp32 x, dy and parameters) against its
    plain fp32 version, beside the bf16 kernel on x and dy rounded to bf16;
    two runs the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    _, w1, b1, w2, _, _ = _mlp_operands(M, D)
    g = torch.Generator().manual_seed(D + 1)
    x, dy = (torch.randn(M, D, generator=g).cuda() for _ in range(2))
    fm.reset_launches()
    grads = fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy)
    assert fm.LAUNCHES == {("fused_mlp_bwd_f32", D): 1} and grads[0].dtype == torch.float32
    grads16 = fm.kernel_fused_mlp_bwd(x.bfloat16(), w1, b1, w2, dy.bfloat16())
    for a, b, c in zip(grads, grads16, fm._plain_bwd(x, w1, b1, w2, dy)):
        _f32_within(a, b, c)
    for a, b in zip(grads, fm.kernel_fused_mlp_bwd(x, w1, b1, w2, dy)):
        assert torch.equal(a, b)


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


# -----------------------------------------------------------------------------
# The feature objectives of the recipes that train the non-distilled student
# -----------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("recipe,epoch", [("wasskd-sinkhorn", 0), ("saliency_mgd", 0),
                                          ("lrkd", 0), ("diffkd", 0), ("curkd", 0),
                                          ("curkd", 120), ("curkd", 200), ("hard", 0)])
def test_recipe_objective_step_on_card(recipe, epoch):
    """One fused train step of each objective in its recipe's configuration
    (chip_smoke.OBJECTIVE_PATHS) at batch 8, 224 px: the DeiT-Ti student without a distillation token
    (N = 197; the distilled one for hard), 12 + 12 block forwards and 12
    block backwards, finite metrics, a positive distill loss, student and aux
    parameters changed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from deltakd_tpu_torch.configs.config import TrainConfig
    from deltakd_tpu_torch.data.augment import AugmentConfig
    from deltakd_tpu_torch.data.mixup import MixupConfig
    from deltakd_tpu_torch.kd.losses import KDSettings
    from deltakd_tpu_torch.models.factory import load_teacher_student
    from deltakd_tpu_torch.train.optim import make_optimizer
    from deltakd_tpu_torch.train.state import TrainState, trainable_parameters
    from chip_smoke import OBJECTIVE_PATHS, RECIPE_COMMON
    from deltakd_tpu_torch.train.step import build_train_step

    options = dict(RECIPE_COMMON, **dict((n, o) for n, o, _ in OBJECTIVE_PATHS)[recipe])
    cfg = TrainConfig(teacher_model="deit_small_distilled_patch16_224", batch_size=8,
                      dataset="cifar-100", aa="", color_jitter=0.0,
                      allow_random_teacher=True, **options)
    teacher, student, aux = load_teacher_student(cfg, seed=0, device="cuda")
    tx = make_optimizer(cfg, trainable_parameters(student, aux), 100)
    state = TrainState(student, tx=tx, aux=aux)
    kd = KDSettings.from_config(cfg, student_prefix=student.cfg.num_prefix_tokens,
                                teacher_prefix=teacher.cfg.num_prefix_tokens)
    step = build_train_step(cfg=cfg, kd=kd, student=student, teacher=teacher, aux=aux,
                            aug=AugmentConfig.from_config(cfg),
                            mixup=MixupConfig.from_config(cfg, 100), tx=tx)
    before = state.params.clone()
    n_student = sum(p.numel() for p in student.parameters())
    fb.reset_launches()
    metrics = {k: float(v) for k, v in
               step(state, _u8_batch(8, 32), torch.arange(8, device="cuda"),
                    torch.Generator(device="cuda").manual_seed(1), epoch=epoch).items()}
    assert fb.LAUNCHES == {("fused_block_fwd", 384): 12, ("fused_block_fwd", 192): 12,
                           ("fused_block_bwd", 192): 12}
    assert all(np.isfinite(v) for v in metrics.values()) and metrics["distill_loss"] > 0
    delta = (state.params - before).abs()
    assert delta[:n_student].max().item() > 0
    assert aux is None or delta[n_student:].max().item() > 0


@pytest.mark.cuda
def test_sinkhorn_ignores_tf32():
    """The divergence and its gradients have the same bits with TF32 on in
    the process as with it off, where a plain fp32 product of the same
    clouds does change."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deltakd_tpu_torch.kd.sinkhorn import batched_sinkhorn_divergence

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(6, 196, 384, device="cuda", generator=g) * 0.5
    y = torch.randn(6, 196, 384, device="cuda", generator=g) * 0.5

    def run():
        xg = x.clone().requires_grad_(True)
        div = batched_sinkhorn_divergence(xg, y)
        div.sum().backward()
        return div.detach(), xg.grad, torch.bmm(x, y.transpose(1, 2))

    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        div, grad, prod = run()
        torch.backends.cuda.matmul.allow_tf32 = True
        div_tf32, grad_tf32, prod_tf32 = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert not torch.equal(prod, prod_tf32)
    assert torch.equal(div, div_tf32) and torch.equal(grad, grad_tf32)
    assert torch.isfinite(div).all() and (div > 0).all()


# -----------------------------------------------------------------------------
# The runtime: run() on the card against run() on the CPU
# -----------------------------------------------------------------------------

@pytest.mark.cuda
def test_run_on_card_matches_cpu(tmp_path):
    """Two tiny epochs of run() (soft KD, 32 px, batch 8, 2 steps, the fused
    block on the card) against the same run with --device cpu on the same
    seed: 12 + 12 block forwards and 12 block backwards a train step and 12
    block forwards an eval batch on the card, none on the CPU; the losses of
    each epoch to chip_smoke's LOGIT_TOL, relative. The draws come from each
    device's own generator, so the two runs see other crops: the losses
    agree because two steps at the warmup's learning rate barely move the
    seeded weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    from chip_smoke import LOGIT_TOL, RunProbe
    from deltakd_tpu_torch.configs.config import parse_args
    from deltakd_tpu_torch.train import loop

    mods = (fb, so, at, fm)
    argv = ["--synthetic-data", "--dataset", "synthetic", "--input-size", "32",
            "--batch-size", "8", "--epochs", "2", "--steps-per-epoch", "2",
            "--eval-steps", "1", "--distillation-type", "soft",
            "--student-model", "deit_tiny_distilled_patch16_224",
            "--teacher-model", "deit_small_distilled_patch16_224",
            "--allow-random-teacher", "--seed", "5"]
    runs = {}
    for device in ("cuda", "cpu"):
        probe = RunProbe(mods)
        with probe:
            metrics = loop.run(parse_args(argv + [
                "--device", device, "--save-dir", str(tmp_path / device),
                "--log-file", str(tmp_path / "logs" / device)]))
        runs[device] = (metrics, probe)
    (card, card_probe), (cpu, cpu_probe) = runs["cuda"], runs["cpu"]
    fused = {("fused_block_fwd", 384): 12, ("fused_block_fwd", 192): 12,
             ("fused_block_bwd", 192): 12}
    assert card_probe.step_launches == [fused] * 4
    assert card_probe.eval_launches == [{("fused_block_fwd", 192): 12}] * 2
    assert cpu_probe.step_launches == [{}] * 4 and cpu_probe.eval_launches == [{}] * 2
    pairs = [(card["val_loss"], cpu["val_loss"])]
    for a, b in zip(card_probe.epoch_metrics, cpu_probe.epoch_metrics):
        pairs += [(a["train_loss"], b["train_loss"]), (a["base_loss"], b["base_loss"])]
    for a, b in pairs:
        assert np.isfinite(a) and abs(a - b) <= LOGIT_TOL * abs(b), (a, b)


@pytest.mark.cuda
def test_fused_route_learns_the_texture_task_on_card():
    """chip_smoke.py phase 16a's fused bf16 route: a DeiT-Tiny at full width
    and depth, fresh weights, 100 steps at B = 128 on the 224 px texture
    task; 24 block kernel launches a step and no plain version; train top-1
    at step 100 and held-out top-1 above 85% (chance 25%)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from chip_smoke import LEARN_BAR, learn_data, learn_route

    out = learn_route((fb, so, at, fm), "fused", "bfloat16", learn_data())
    assert out["ok"] and out["train"] > LEARN_BAR and out["heldout"] > LEARN_BAR, out
