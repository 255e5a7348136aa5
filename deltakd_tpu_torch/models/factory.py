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
from deltakd_tpu_torch.ops import sort as _sort
from deltakd_tpu_torch.ops.attention import best_attention_fn
from deltakd_tpu_torch.ops.fused_block import best_block_pair_fn, fused_vit_block
from deltakd_tpu_torch.ops.fused_mlp import best_mlp_fn, forward_takes
from deltakd_tpu_torch.parallel.mesh import Mesh, ModelParallel
from deltakd_tpu_torch.parallel.tensor import shard_state_dict

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


def shard_model(model: VisionTransformer, tp: Optional[ModelParallel]
                ) -> VisionTransformer:
    """``model`` as model rank ``tp.rank`` holds it: a model on the same
    device with the same settings whose blocks hold that rank's Megatron
    shards of ``model``'s parameters (``parallel/tensor.py``); ``model``
    itself without a model axis."""
    if tp is None or not tp.active:
        return model
    device = model.head.weight.device
    with torch.device(device):
        sharded = VisionTransformer(model.cfg, dtype=model.dtype,
                                    attention_fn=model.attention_fn, mlp_fn=model.mlp_fn,
                                    collect_features=model.collect_features, tp=tp)
    sharded.load_state_dict(shard_state_dict(model.state_dict(), model.cfg.num_heads,
                                             tp.size, tp.rank))
    for (_, p), (_, q) in zip(model.named_parameters(), sharded.named_parameters()):
        q.requires_grad_(p.requires_grad)
    if hasattr(model, "import_report"):
        sharded.import_report = model.import_report
    return sharded


def check_mlp_shards(name: str, num_classes: int, size: int, dtype: torch.dtype) -> None:
    """Refuses, with a ValueError that names the model and F/M, a model axis
    of ``size`` that cuts the model's MLP hidden F into shards of a width the
    fused MLP forward (``ops.fused_mlp.forward_takes`` at ``dtype``) does not
    take where it takes F itself: the teacher, and the student's eval view,
    run that kernel on each rank's F/M hidden columns. A width the model
    axis does not divide is left to the shard cut, which refuses it."""
    cfg = get_model_config(name, num_classes=num_classes)
    D, F = cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio)
    if size > 1 and F % size == 0 and forward_takes(D, F, dtype) and not forward_takes(
            D, F // size, dtype):
        raise ValueError(
            f"{name}: a model axis of {size} leaves each rank F/M = {F}/{size} = "
            f"{F // size} hidden columns of its MLP, a width the fused MLP forward "
            f"kernel does not take at D={D} ({dtype}); choose a model axis whose F/M the "
            f"kernel takes (ops/fused_mlp.py forward_takes)")


def check_sequence_lengths(config, num_classes: int, kernels_on: bool) -> None:
    """Refuses, with a ValueError that names the input size, a config whose
    WassKD-l1 patch rows pass the sort kernels' limit
    (``ops.sort.KERNEL_MAX_N``, 2**30 rows: their padded column length,
    positions and rows are 32-bit ints; some 524,000 px at patch 16, far
    past what one card's memory holds). The JAX package takes any size, and
    so do the port's other kernels: the attention forward and backward take
    any sequence length and any batch x heads (``ops.attention``)."""
    if not kernels_on or config.distillation_type != "wasskd" or config.wasskd_type != "l1":
        return
    size = config.input_size
    for name in (config.teacher_model, config.student_model):
        cfg = get_model_config(name, num_classes=num_classes, img_size=size)
        if cfg.num_patches > _sort.KERNEL_MAX_N:
            raise ValueError(
                f"{name} at --input-size {size} has {cfg.num_patches} patch rows, above "
                f"the {_sort.KERNEL_MAX_N} the WassKD-l1 sort kernels take")


def load_teacher_student(config, *, attention_fn=_FROM_CONFIG,
                         block_pair: bool = False, seed: int = 0, device="cuda",
                         mesh: Optional[Mesh] = None
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
    factory. The route is the JAX factory's, whatever ``config.dtype`` is
    (its kernels run at the input's dtype; here bf16 takes the kernels' bf16
    forms and float32 their fp32 forms on TF32 tensor cores):

    * With kernels on and no model axis, both models run the fused block
      (``fused_vit_block``).
    * With a model axis > 1 in ``config.mesh_shape``, the unfused path: the
      fused block consumes whole weight matrices, so tensor parallelism runs
      the student with ``attention_fn`` and the forward-only teacher with
      ``attention_fn`` and ``fused_mlp`` (at float32 the MLP forward's fp32
      form). With ``mesh`` (``parallel.make_mesh``) over a model axis of
      several ranks, both models, the frozen teacher too, hold this rank's
      shards (``shard_model``), cut from the same seeded weights and
      imported teacher a one-rank run builds; at one rank ``mesh_shape``
      only selects the path. With kernels on, a model axis that leaves the
      fused MLP forward a hidden shard it does not take is refused before
      anything is built (``check_mlp_shards``).

    An input size whose WassKD-l1 patch rows pass the sort kernels' limit
    (2**30) is refused before anything is built (``check_sequence_lengths``).

    ``block_pair`` stands for the JAX factory's environment variable
    ``DELTAKD_PAIR=1``: with kernels on and no model axis, the student (never
    the forward-only teacher) runs two consecutive blocks per call through
    ``fused_vit_block_pair``. Evaluate it on single blocks:
    ``student.view(block_pair_fn=None, collect_features=False)``. At float32
    the pair runs its fp32 form, as the JAX factory turns the pair on at any
    dtype."""
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
    kernels_on = attention_fn is not None
    mesh_shape = config.mesh_shape
    model_axis = int(mesh_shape[1]) if mesh_shape and len(mesh_shape) > 1 else 1
    block_fn = fused_vit_block if kernels_on and model_axis == 1 else None
    pair_on = kernels_on and model_axis == 1 and block_pair
    block_pair_fn = best_block_pair_fn(pair_on)
    tp = mesh.model if mesh is not None else None
    if kernels_on and tp is not None and tp.active:
        for name in (config.teacher_model, config.student_model):
            check_mlp_shards(name, num_classes, tp.size, dtype)
    check_sequence_lengths(config, num_classes, kernels_on)

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
    teacher, student = shard_model(teacher, tp), shard_model(student, tp)
    aux = None
    if config.distillation_type.lower() in FEATURE_TYPES:
        aux = AuxHeads(config.distillation_type, student.cfg.embed_dim,
                       teacher.cfg.embed_dim, torch.Generator().manual_seed(seed + 3),
                       lrkd_rank=config.lrkd_rank,
                       saliency_method=config.saliency_method).to(resolve_device(device))
    return teacher, student, aux
