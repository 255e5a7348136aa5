"""Model construction (``deltakd_tpu/models/factory.py``): the DeiT teacher
and student, with the fused block or on the unfused path with the attention
and MLP kernels, and the aux heads of the distillation type, randomly
initialised from a seed.

A pretrained teacher needs a timm checkpoint, which loads by name into
``VisionTransformer.load_state_dict``; until one is available, distilling
against the random teacher must be asked for with ``allow_random_teacher``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from deltakd_tpu_torch import resolve_device
from deltakd_tpu_torch.data.registry import DATASET_STATS
from deltakd_tpu_torch.kd.aux import AuxHeads
from deltakd_tpu_torch.kd.losses import FEATURE_TYPES, feature_indices
from deltakd_tpu_torch.models.import_timm import load_state_dict, timm_to_torch
from deltakd_tpu_torch.models.registry import get_model_config
from deltakd_tpu_torch.models.vit import VisionTransformer, init_weights
from deltakd_tpu_torch.ops.attention import best_attention_fn
from deltakd_tpu_torch.ops.fused_block import best_block_pair_fn, fused_vit_block
from deltakd_tpu_torch.ops.fused_mlp import best_mlp_fn

_FROM_CONFIG = object()


def create_model(name: str, *, num_classes: int, img_size: int = 224,
                 drop_path_rate: float = 0.0, dtype=torch.bfloat16,
                 attention_fn: Optional[Callable] = None,
                 mlp_fn: Optional[Callable] = None,
                 block_fn: Optional[Callable] = fused_vit_block,
                 block_pair_fn: Optional[Callable] = None,
                 collect_features=True, seed: int = 0,
                 device="cuda") -> VisionTransformer:
    """A model of the zoo with seeded random weights on ``device``. By default
    each block runs through ``fused_vit_block``; ``block_fn=None`` gives the
    unfused path with ``attention_fn`` and ``mlp_fn`` (or PyTorch's own ops);
    ``block_pair_fn=fused_vit_block_pair`` runs two consecutive blocks per
    call. Each of them runs its kernels on the card and its plain version on
    the CPU."""
    device = resolve_device(device)
    cfg = get_model_config(name, num_classes=num_classes, img_size=img_size,
                           drop_path_rate=drop_path_rate)
    model = VisionTransformer(cfg, dtype=dtype, attention_fn=attention_fn,
                              mlp_fn=mlp_fn, block_fn=block_fn,
                              block_pair_fn=block_pair_fn,
                              collect_features=collect_features)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def load_teacher_student(config, *, attention_fn=_FROM_CONFIG,
                         block_pair: bool = False, seed: int = 0, device="cuda"
                         ) -> Tuple[VisionTransformer, VisionTransformer,
                                    Optional[AuxHeads]]:
    """(teacher, student, aux) for a TrainConfig; the teacher is frozen and
    ``aux`` holds the aux heads of a feature objective (None for
    none/soft/hard).

    With ``config.teacher_checkpoint`` the teacher's weights are imported
    from that file (``timm_to_torch``: a head of another class count keeps
    its initialisation, the position embedding is interpolated to the input
    size); the skipped keys are printed, and the import's report is kept as
    ``teacher.import_report``. Without one, a distillation type other than
    'none' raises ``ValueError`` unless ``allow_random_teacher`` is set, as in
    the JAX factory.

    ``attention_fn`` defaults to ``best_attention_fn(config.flash_attention)``;
    None turns every kernel off (PyTorch's own ops throughout), as in the JAX
    factory. A config whose ``dtype`` is not bfloat16 turns them off too: the
    kernels take bf16 operands only (each wrapper raises on an fp32 CUDA
    tensor, and none converts), so an fp32 config runs both models on
    PyTorch's own ops, exactly as ``attention_fn=None`` does. The JAX
    package runs its kernels at fp32 as well; the port does not yet. With
    kernels on, both models run the fused block, unless
    ``config.mesh_shape`` has a model axis > 1: the fused block consumes whole
    weight matrices, so tensor parallelism takes the unfused path, the student
    with ``attention_fn`` and the forward-only teacher with ``attention_fn``
    and ``fused_mlp``. In the port ``mesh_shape`` so far only selects that
    path; nothing is placed over a model axis yet.

    ``block_pair`` stands for the JAX factory's environment variable
    ``DELTAKD_PAIR=1``: with kernels on and no model axis, the student (never
    the forward-only teacher) runs two consecutive blocks per call through
    ``fused_vit_block_pair``. Evaluate it on single blocks:
    ``student.view(block_pair_fn=None, collect_features=False)``."""
    if (not config.teacher_checkpoint and config.distillation_type != "none"
            and not config.allow_random_teacher):
        raise ValueError(
            f"distillation_type {config.distillation_type!r} requires "
            f"teacher_checkpoint (the reference always loads pretrained teacher "
            f"weights). Pass allow_random_teacher=True to override for "
            f"tests/ablations.")
    num_classes = DATASET_STATS[config.dataset]["num_classes"]
    dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32

    if attention_fn is _FROM_CONFIG:
        attention_fn = best_attention_fn(config.flash_attention)
    if dtype != torch.bfloat16:
        attention_fn = None
    kernels_on = attention_fn is not None
    mesh_shape = config.mesh_shape
    model_axis = int(mesh_shape[1]) if mesh_shape and len(mesh_shape) > 1 else 1
    block_fn = fused_vit_block if kernels_on and model_axis == 1 else None
    block_pair_fn = best_block_pair_fn(kernels_on and model_axis == 1 and block_pair)

    def needed(name):
        depth = get_model_config(name, num_classes=num_classes).depth
        return feature_indices(config.distillation_type, depth)

    teacher = create_model(config.teacher_model, num_classes=num_classes,
                           img_size=config.input_size, dtype=dtype,
                           attention_fn=attention_fn, mlp_fn=best_mlp_fn(kernels_on),
                           block_fn=block_fn,
                           collect_features=needed(config.teacher_model),
                           seed=seed + 1, device=device)
    teacher.requires_grad_(False)
    if config.teacher_checkpoint:
        teacher.import_report = timm_to_torch(load_state_dict(config.teacher_checkpoint),
                                              teacher)
        if teacher.import_report["skipped"]:
            print(f"[teacher import] reinitialized (shape mismatch): "
                  f"{teacher.import_report['skipped']}")
    elif config.distillation_type != "none":
        print("[teacher] WARNING: distilling against a RANDOMLY INITIALIZED "
              "teacher (allow_random_teacher); KD signal is noise")
    student = create_model(config.student_model, num_classes=num_classes,
                           img_size=config.input_size,
                           drop_path_rate=config.drop_path_rate, dtype=dtype,
                           attention_fn=attention_fn, block_fn=block_fn,
                           block_pair_fn=block_pair_fn,
                           collect_features=needed(config.student_model),
                           seed=seed + 2, device=device)
    aux = None
    if config.distillation_type.lower() in FEATURE_TYPES:
        aux = AuxHeads(config.distillation_type, student.cfg.embed_dim,
                       teacher.cfg.embed_dim,
                       torch.Generator().manual_seed(seed + 3)).to(resolve_device(device))
    return teacher, student, aux
