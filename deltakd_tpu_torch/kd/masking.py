"""Token masking for the masked-generation objectives
(``deltakd_tpu/kd/masking.py``): MAE-style random masking by the argsort of
uniform noise, attention-guided (saliency) masking that keeps the least
salient tokens, and the fill / restore / grid helpers around the generation
head. Randomness comes from an explicit ``torch.Generator``; a caller may
hand in the noise, or the saliency scores, itself. Every argsort is stable,
as JAX's is.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deltakd_tpu_torch.kd import aux as aux_ops


def random_masking(generator: Optional[torch.Generator], x: torch.Tensor,
                   mask_ratio: float, *, noise: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample random token masking.

    x: [B, L, D]; ``noise`` [B, L] replaces the draw from ``generator``.
    Returns (x_keep [B, len_keep, D], mask [B, L] with 1 = removed,
    ids_restore, ids_masked), len_keep = int(L * (1 - mask_ratio)).
    """
    B, L, _ = x.shape
    len_keep = int(L * (1 - mask_ratio))
    if noise is None:
        noise = torch.rand(B, L, generator=generator, device=x.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    ids_masked = ids_shuffle[:, len_keep:]
    x_keep = x.gather(1, ids_keep[..., None].expand(-1, -1, x.shape[-1]))
    mask = torch.ones(B, L, dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0.0
    mask = mask.gather(1, ids_restore)
    return x_keep, mask, ids_restore, ids_masked


def _keep_lowest(scores: torch.Tensor, student_feat: torch.Tensor, len_keep: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the ``len_keep`` lowest-scoring tokens of ``student_feat``
    [B, L, D] (ascending argsort of ``scores`` [B, L]: the reference keeps
    the least salient tokens). Returns (x_keep, mask with 1 = removed,
    ids_restore)."""
    B, L = scores.shape
    ids_shuffle = torch.argsort(scores, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    x_keep = student_feat.gather(1, ids_keep[..., None].expand(-1, -1, student_feat.shape[-1]))
    mask = torch.ones(B, L, dtype=student_feat.dtype, device=student_feat.device)
    mask[:, :len_keep] = 0.0
    return x_keep, mask.gather(1, ids_restore), ids_restore


@torch.no_grad()
def saliency_scores(saliency_attn: torch.nn.Module, teacher_feat: torch.Tensor,
                    method: int, teacher_prefix: int = 2) -> torch.Tensor:
    """The attention score of each patch token [B, L_patch] that saliency
    masking sorts by, from ``teacher_feat`` with its prefix tokens (CLS, then
    DIST for a distilled teacher). Method 1: the self-attention diagonal over
    the patch tokens; 2: the CLS row of self-attention over CLS and the patch
    tokens, the CLS column dropped; 3: the CLS query's cross-attention over
    the patch keys. No gradient flows through the argsort that reads them, so
    none is taken."""
    patches = teacher_feat[:, teacher_prefix:]
    if method == 1:
        return aux_ops.simple_attention_scores(saliency_attn, patches)
    kept = torch.cat([teacher_feat[:, :1], patches], dim=1)   # CLS kept, DIST dropped
    if method == 2:
        return aux_ops.simple_attention_cls_row(saliency_attn, kept)[:, 1:]
    if method == 3:
        return aux_ops.cross_attention_scores(saliency_attn, kept[:, :1], kept[:, 1:])[:, 0]
    raise ValueError(f"Invalid saliency masking method: {method}")


def saliency_masking(saliency_attn: torch.nn.Module, teacher_feat: torch.Tensor,
                     student_feat: torch.Tensor, mask_ratio: float, method: int,
                     teacher_prefix: int = 2, *, scores: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention-guided masking: keep the int(L * (1 - mask_ratio)) least
    salient of the L patch tokens of ``student_feat`` [B, L, D] (patch
    tokens only). ``scores`` [B, L] replaces ``saliency_scores``. Returns
    (x_keep, mask with 1 = removed, ids_restore)."""
    if scores is None:
        scores = saliency_scores(saliency_attn, teacher_feat, method, teacher_prefix)
    len_keep = int(scores.shape[1] * (1 - mask_ratio))
    return _keep_lowest(scores, student_feat, len_keep)


def fill_and_restore(x_keep: torch.Tensor, ids_restore: torch.Tensor,
                     mask_token: torch.Tensor) -> torch.Tensor:
    """Append mask tokens for the removed positions and unshuffle back to the
    original token order."""
    B, L = ids_restore.shape
    n_masked = L - x_keep.shape[1]
    mask_tokens = mask_token.to(x_keep.dtype).expand(B, n_masked, -1)
    x_full = torch.cat([x_keep, mask_tokens], dim=1)
    return x_full.gather(1, ids_restore[..., None].expand(-1, -1, x_full.shape[-1]))


def tokens_to_grid(x: torch.Tensor) -> torch.Tensor:
    """[B, N, D] -> [B, hw, hw, D] with hw = isqrt(N) (NHWC, as in the JAX
    package)."""
    B, N, D = x.shape
    hw = math.isqrt(N)
    return x.reshape(B, hw, hw, D)


def grid_to_tokens(x: torch.Tensor) -> torch.Tensor:
    B, H, W, D = x.shape
    return x.reshape(B, H * W, D)
