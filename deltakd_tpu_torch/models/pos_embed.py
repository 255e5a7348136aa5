"""Position-embedding grid interpolation (``deltakd_tpu/models/pos_embed.py``):
the prefix (CLS/DIST) embeddings pass through, the patch part is resized
bicubically on its square grid as ``torch.nn.functional.interpolate`` does it
(a = -0.75, align_corners=False, edge pixels replicated, no antialias), which
is what the JAX package builds as explicit resize matrices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_grid_bicubic(grid, new_size: int):
    """[1, H, H, D] -> [1, new, new, D] in fp32."""
    if grid.shape[1] == new_size:
        return grid
    g = F.interpolate(grid.float().permute(0, 3, 1, 2), size=(new_size, new_size),
                      mode="bicubic", align_corners=False)
    return g.permute(0, 2, 3, 1)


def interpolate_pos_embed(pos_embed, num_prefix_tokens: int, new_num_patches: int):
    """[1, prefix + P_old, D] -> [1, prefix + P_new, D]; unchanged when the
    patch counts agree; a non-square grid raises ``ValueError``. A source
    with another prefix count is aligned by the caller first."""
    old_num_patches = pos_embed.shape[1] - num_prefix_tokens
    if old_num_patches == new_num_patches:
        return pos_embed
    old_size = int(round(old_num_patches ** 0.5))
    new_size = int(round(new_num_patches ** 0.5))
    if old_size * old_size != old_num_patches:
        raise ValueError(f"non-square patch grid: {old_num_patches} patches")
    dim = pos_embed.shape[-1]
    grid = pos_embed[:, num_prefix_tokens:].reshape(1, old_size, old_size, dim)
    grid = resize_grid_bicubic(grid, new_size)
    return torch.cat([pos_embed[:, :num_prefix_tokens].float(),
                      grid.reshape(1, new_size * new_size, dim)], dim=1)
