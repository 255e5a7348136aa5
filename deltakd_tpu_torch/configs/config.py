"""Training configuration: the fields of ``deltakd_tpu/configs/config.py``'s
``TrainConfig`` that the train and eval steps read, with the same names and
defaults.

Every augmentation flag of the JAX package's ``TrainConfig`` works, and
``aa`` is parsed when the config is made, so a policy string the JAX package
rejects raises here too. What the port does not have yet raises
``NotImplementedError`` instead of silently training another recipe:
optimizers other than AdamW, schedules other than cosine, and LR noise.
``cutmix_minmax`` raises as well, and an unknown ``mixup_mode`` raises
``ValueError`` (the JAX package ignores both).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

@dataclass(frozen=True)
class TrainConfig:
    # model
    teacher_model: str = "deit_small_distilled_patch16_224"
    student_model: str = "deit_tiny_patch16_224"
    input_size: int = 224

    # training
    batch_size: int = 256
    ema_decay: Optional[float] = None
    drop_path_rate: float = 0.1
    epochs: int = 300

    # optimizer
    opt: str = "adamw"
    opt_eps: float = 1e-8
    opt_betas: Optional[Tuple[float, ...]] = None
    clip_grad: Optional[float] = None
    weight_decay: float = 0.05

    # scheduler
    sched: str = "cosine"
    lr: float = 5e-4
    lr_noise: Optional[Tuple[float, ...]] = None
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    warmup_epochs: int = 5

    # distillation
    distillation_type: str = "none"
    alpha: float = 0.1
    tau: float = 3.0
    lrkd_rank: int = 32
    lrkd_alpha: float = 0.1
    lrkd_beta: float = 0.1
    lrkd_gamma: float = 0.1
    saliency_method: int = 1
    saliency_mask_ratio: float = 0.5
    wasskd_type: str = "l1"
    sinkhorn_iters: int = 20
    mgd_alpha: float = 7e-5
    mgd_mask_ratio: float = 0.5

    # data
    dataset: str = "imagenet-1k"
    eval_crop_ratio: float = 0.875

    # augmentation
    mixup: float = 0.8
    cutmix: float = 1.0
    cutmix_minmax: Optional[Tuple[float, ...]] = None
    mixup_prob: float = 1.0
    mixup_switch_prob: float = 0.5
    mixup_mode: str = "batch"
    reprob: float = 0.25
    remode: str = "pixel"
    recount: int = 1
    color_jitter: float = 0.3
    aa: Optional[str] = "rand-m9-mstd0.5-inc1"
    smoothing: float = 0.1
    interpolation: str = "bicubic"
    ThreeAugment: bool = False
    src: bool = False

    # misc
    seed: int = 42
    dtype: str = "bfloat16"
    # False turns the attention, MLP and fused-block kernels off (PyTorch's
    # own ops throughout)
    flash_attention: bool = True
    # (data, model) device mesh. In the port it so far only selects the module
    # path: a model axis > 1 takes the unfused path (attention and MLP
    # kernels) instead of the fused block, as tensor parallelism does in the
    # JAX package; nothing is placed over a model axis yet.
    mesh_shape: Optional[Tuple[int, ...]] = None
    grad_accum_steps: int = 1
    aug_pixel_bf16: bool = True
    # a local timm/DeiT state_dict (.pth, .npz or .npy) for the teacher
    teacher_checkpoint: Optional[str] = None
    allow_random_teacher: bool = False

    def __post_init__(self):
        from deltakd_tpu_torch.data.augment import parse_aa_spec
        from deltakd_tpu_torch.data.mixup import MODES

        if self.aa:
            parse_aa_spec(self.aa)
        if self.remode not in ("pixel", "const", "rand"):
            raise NotImplementedError(f"remode {self.remode!r} is not implemented "
                                      f"('pixel', 'const', 'rand' are)")
        if self.recount < 1:
            raise ValueError("recount must be >= 1")
        if self.opt != "adamw" or self.sched != "cosine" or self.lr_noise:
            raise NotImplementedError(
                "only opt='adamw' with sched='cosine' and no lr_noise is ported")
        if self.mixup_mode not in MODES:
            raise ValueError(f"mixup_mode {self.mixup_mode!r} is not one of {MODES}")
        if self.cutmix_minmax is not None:
            raise NotImplementedError("cutmix_minmax is not implemented (the JAX "
                                      "package accepts it and ignores it)")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be bfloat16 or float32, got {self.dtype!r}")

    @property
    def mixup_active(self) -> bool:
        return self.mixup > 0 or self.cutmix > 0.0 or self.cutmix_minmax is not None

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
