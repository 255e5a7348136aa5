"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Run on a machine with an NVIDIA GPU (no JAX needed there):
    python -m pytest tests/test_torch_cuda.py -m cuda
Without a card the test skips: a CUDA kernel has no CPU mode. Small shape
(D=64, 2 heads, N=18) with drop-path scales of 0 and 1/keep; bf16 operands,
so the tolerance is 2e-2 of the largest reference value.
"""

import pytest
import torch

from deltakd_tpu_torch.ops import fused_block as fb

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
