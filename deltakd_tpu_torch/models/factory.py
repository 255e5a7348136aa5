"""Model construction (``deltakd_tpu/models/factory.py``): the DeiT teacher
and student with the fused block, and the aux heads of the distillation type,
randomly initialised from a seed.

A pretrained teacher needs a timm checkpoint, which loads by name into
``VisionTransformer.load_state_dict``; until one is available, distilling
against the random teacher must be asked for with ``allow_random_teacher``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deltakd_tpu_torch import resolve_device
from deltakd_tpu_torch.data.registry import DATASET_STATS
from deltakd_tpu_torch.kd.aux import AuxHeads
from deltakd_tpu_torch.kd.losses import FEATURE_TYPES, feature_indices
from deltakd_tpu_torch.models.registry import get_model_config
from deltakd_tpu_torch.models.vit import VisionTransformer, init_weights
from deltakd_tpu_torch.ops.fused_block import fused_vit_block


def create_model(name: str, *, num_classes: int, img_size: int = 224,
                 drop_path_rate: float = 0.0, dtype=torch.bfloat16,
                 collect_features=True, seed: int = 0,
                 device="cuda") -> VisionTransformer:
    """A model of the zoo with seeded random weights on ``device``. Each block
    runs through ``fused_vit_block``: the kernels on the card, their plain
    version on the CPU."""
    device = resolve_device(device)
    cfg = get_model_config(name, num_classes=num_classes, img_size=img_size,
                           drop_path_rate=drop_path_rate)
    model = VisionTransformer(cfg, dtype=dtype, block_fn=fused_vit_block,
                              collect_features=collect_features)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def load_teacher_student(config, *, seed: int = 0, device="cuda"
                         ) -> Tuple[VisionTransformer, VisionTransformer,
                                    Optional[AuxHeads]]:
    """(teacher, student, aux) for a TrainConfig; the teacher is frozen and
    ``aux`` holds the aux heads of a feature objective (None for
    none/soft/hard)."""
    if config.distillation_type != "none" and not config.allow_random_teacher:
        raise ValueError(
            f"distillation_type {config.distillation_type!r} needs a pretrained "
            f"teacher, and loading one is not ported yet; pass "
            f"allow_random_teacher=True to distill against a random teacher")
    num_classes = DATASET_STATS[config.dataset]["num_classes"]
    dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32

    def needed(name):
        depth = get_model_config(name, num_classes=num_classes).depth
        return feature_indices(config.distillation_type, depth)

    teacher = create_model(config.teacher_model, num_classes=num_classes,
                           img_size=config.input_size, dtype=dtype,
                           collect_features=needed(config.teacher_model),
                           seed=seed + 1, device=device)
    teacher.requires_grad_(False)
    student = create_model(config.student_model, num_classes=num_classes,
                           img_size=config.input_size,
                           drop_path_rate=config.drop_path_rate, dtype=dtype,
                           collect_features=needed(config.student_model),
                           seed=seed + 2, device=device)
    aux = None
    if config.distillation_type.lower() in FEATURE_TYPES:
        aux = AuxHeads(config.distillation_type, student.cfg.embed_dim,
                       teacher.cfg.embed_dim,
                       torch.Generator().manual_seed(seed + 3)).to(resolve_device(device))
    return teacher, student, aux
