"""Model zoo: timm-compatible names -> ViTConfig (the DeiT/ViT patch-16
family of ``deltakd_tpu/models/registry.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict

from deltakd_tpu_torch.models.vit import ViTConfig

_DIMS = {
    "tiny": dict(embed_dim=192, depth=12, num_heads=3),
    "small": dict(embed_dim=384, depth=12, num_heads=6),
    "base": dict(embed_dim=768, depth=12, num_heads=12),
    "large": dict(embed_dim=1024, depth=24, num_heads=16),
}

MODEL_REGISTRY: Dict[str, ViTConfig] = {}


def _register_family() -> None:
    for size, dims in _DIMS.items():
        for distilled in (False, True):
            if distilled and size == "large":
                continue  # no distilled DeiT-Large exists upstream
            dist_tag = "distilled_" if distilled else ""
            for img in (224, 384):
                name = f"deit_{size}_{dist_tag}patch16_{img}"
                MODEL_REGISTRY[name] = ViTConfig(distilled=distilled,
                                                 img_size=img, **dims)
        for img in (224, 384):
            MODEL_REGISTRY[f"vit_{size}_patch16_{img}"] = ViTConfig(img_size=img,
                                                                    **dims)
        if size in ("base", "large"):
            MODEL_REGISTRY[f"vit_{size}_patch32_224"] = ViTConfig(patch_size=32,
                                                                  **dims)


_register_family()


def get_model_config(name: str, *, num_classes: int, img_size: int = 224,
                     drop_path_rate: float = 0.0) -> ViTConfig:
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model '{name}'. Available: {sorted(MODEL_REGISTRY)}")
    base = MODEL_REGISTRY[name]
    return dataclasses.replace(base, num_classes=num_classes, img_size=img_size,
                               drop_path_rate=drop_path_rate)
