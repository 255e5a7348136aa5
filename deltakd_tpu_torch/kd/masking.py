"""Token masking for the masked-generation objectives
(``deltakd_tpu/kd/masking.py``): MAE-style random masking by the argsort of
uniform noise, and the fill / restore / grid helpers around the generation
head. Randomness comes from an explicit ``torch.Generator``; a test may hand
in the noise itself.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


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
