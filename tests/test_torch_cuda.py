"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Run on a machine with an NVIDIA GPU (no JAX needed there):
    python -m pytest tests/test_torch_cuda.py -m cuda
Without a card the tests skip: a CUDA kernel has no CPU mode. The fused
block: small shape (D=64, 2 heads, N=18) with drop-path scales of 0 and
1/keep; bf16 operands, so the tolerance is 2e-2 of the largest reference
value. The sort kernels: inputs with ties; sorted values, signs and gradients
exactly, the loss to 1e-5 (fp32 sums in another order).
"""

import pytest
import torch

from deltakd_tpu_torch.ops import fused_block as fb
from deltakd_tpu_torch.ops import sort as so

B, N, D, H = 4, 18, 64, 2


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 196, 40), (2, 64, 33), (2, 2, 5), (1, 1024, 20)])
def test_sort_kernels_match_plain_version_on_card(shape, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(shape[1])
    s = torch.randn(shape, generator=g).bfloat16().to(dtype)
    t = torch.randn(shape, generator=g).bfloat16().to(dtype)
    s[:, 1] = s[:, 0]
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
    with pytest.raises(ValueError):
        so.sorted_l1(s.double(), t.double(), 1)
