"""Training configuration (``deltakd_tpu/configs/config.py``): a frozen
dataclass with every field of the JAX package's ``TrainConfig``, under the
same names and defaults, and the same argparse surface, so that every
``exp/*.sh`` recipe parses to the same values in both packages.

Every augmentation flag of the JAX package works, and ``aa`` is parsed when
the config is made, so a policy string the JAX package rejects raises here
too. Every optimizer (``adamw``, ``sgd`` / ``momentum``, ``adam``), schedule
(``cosine``, ``step``, ``plateau``) and LR-noise setting of the JAX package
trains; another ``opt`` or ``sched`` raises ``NotImplementedError`` when the
config is made, where the JAX package raises it when it builds the
optimizer. ``cutmix_minmax`` is accepted and, as in the JAX package, turns
mixup on and changes nothing else (``validate`` warns); an unknown
``mixup_mode`` raises ``ValueError`` (the JAX package ignores it).

The switches of the JAX package's TPU runtime are accepted and mean here:
``device`` picks the port's device (None: the card; 'cpu' runs the plain
PyTorch path on the CPU); ``--fp16`` / ``--amp`` map to bf16 compute, as in
the JAX package; ``gpus``, ``dist_url``, ``param_dtype`` (parameters are
kept in fp32), ``donate_state`` and ``prng_impl`` (the draws come from a
``torch.Generator``) change nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class TrainConfig:
    # model
    teacher_model: str = "deit_small_distilled_patch16_224"
    student_model: str = "deit_tiny_patch16_224"
    fp16: bool = False
    input_size: int = 224

    # training
    batch_size: int = 256
    amp: bool = False
    ema_decay: Optional[float] = None
    label_smoothing: float = 0.1
    drop_path_rate: float = 0.1
    num_workers: int = 10
    epochs: int = 300
    pin_mem: bool = True

    # optimizer
    opt: str = "adamw"
    opt_eps: float = 1e-8
    opt_betas: Optional[Tuple[float, ...]] = None
    clip_grad: Optional[float] = None
    momentum: float = 0.9
    weight_decay: float = 0.05

    # scheduler
    sched: str = "cosine"
    lr: float = 5e-4
    lr_noise: Optional[Tuple[float, ...]] = None
    lr_noise_pct: float = 0.67
    lr_noise_std: float = 1.0
    warmup_lr: float = 1e-6
    min_lr: float = 1e-5
    decay_epochs: float = 30
    warmup_epochs: int = 5
    cooldown_epochs: int = 10
    patience_epochs: int = 10
    decay_rate: float = 0.1

    # distributed (accepted for recipe compatibility)
    gpus: Optional[str] = None
    dist_url: str = "env://"

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

    # saving and logging
    log_file: str = "logs/train.log"
    save_dir: str = "checkpoints"
    wandb: bool = False
    wandb_project: str = "distill-vit"

    # data
    data_path: str = "dataset"
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
    resplit: bool = False
    color_jitter: float = 0.3
    aa: Optional[str] = "rand-m9-mstd0.5-inc1"
    smoothing: float = 0.1
    interpolation: str = "bicubic"
    # the RASampler; it engages only with more than one process
    repeated_aug: bool = True
    ThreeAugment: bool = False
    src: bool = False

    # misc
    resume: bool = False
    finetune: bool = False
    checkpoint: Optional[str] = None
    seed: int = 42
    # None: the card; 'cpu' only when asked
    device: Optional[str] = None

    # additions of the JAX package (no reference equivalent)
    # a local timm/DeiT state_dict (.pth, .npz or .npy) for the teacher
    teacher_checkpoint: Optional[str] = None
    # (data, model) device mesh. In the port it so far only selects the module
    # path: a model axis > 1 takes the unfused path (attention and MLP
    # kernels) instead of the fused block, as tensor parallelism does in the
    # JAX package; nothing is placed over a model axis yet.
    mesh_shape: Optional[Tuple[int, ...]] = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    steps_per_epoch: Optional[int] = None
    eval_steps: Optional[int] = None
    synthetic_data: bool = False
    log_every: int = 10
    # False turns the attention, MLP and fused-block kernels off (PyTorch's
    # own ops throughout)
    flash_attention: bool = True
    donate_state: bool = True
    prng_impl: str = "rbg"
    # torch.profiler trace of the first epoch
    profile_dir: Optional[str] = None
    # 'python' (Loader) or 'tfdata' (TorchDataLoader on file-backed sources)
    data_loader: str = "python"
    grad_accum_steps: int = 1
    aug_pixel_bf16: bool = True
    allow_random_teacher: bool = False

    def __post_init__(self):
        from deltakd_tpu_torch.data.augment import parse_aa_spec
        from deltakd_tpu_torch.data.mixup import MODES
        from deltakd_tpu_torch.train.optim import OPTIMIZERS, SCHEDULES

        if self.aa:
            parse_aa_spec(self.aa)
        if self.remode not in ("pixel", "const", "rand"):
            raise NotImplementedError(f"remode {self.remode!r} is not implemented "
                                      f"('pixel', 'const', 'rand' are)")
        if self.recount < 1:
            raise ValueError("recount must be >= 1")
        if self.opt not in OPTIMIZERS:
            raise NotImplementedError(f"optimizer {self.opt!r} not implemented "
                                      f"({', '.join(OPTIMIZERS)} are)")
        if self.sched not in SCHEDULES:
            raise NotImplementedError(f"scheduler {self.sched!r} not implemented "
                                      f"({', '.join(SCHEDULES)} are)")
        if self.mixup_mode not in MODES:
            raise ValueError(f"mixup_mode {self.mixup_mode!r} is not one of {MODES}")
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype must be bfloat16 or float32, got {self.dtype!r}")

    @property
    def mixup_active(self) -> bool:
        return self.mixup > 0 or self.cutmix > 0.0 or self.cutmix_minmax is not None

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "TrainConfig":
        """The JAX package's check of flags it accepts but does not honour.
        What it raises for, ``__post_init__`` raises for already; ``resplit``
        is an accepted no-op with a warning, as in the reference, which parses
        it and never passes it on (reference dataset/datasets.py:56-64), and
        so is ``cutmix_minmax``, which the JAX package's mixup never reads."""
        if self.resplit:
            warnings.warn(
                "--resplit is accepted but has no effect, matching the "
                "reference, which parses it and never passes it to "
                "create_transform (dataset/datasets.py:56-64)")
        if self.cutmix_minmax is not None:
            warnings.warn("--cutmix-minmax is accepted but changes nothing but turning "
                          "mixup on, as in the JAX package, whose mixup never reads it")
        return self


def add_train_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The JAX package's flag surface (the reference's tools/train.py:22-212
    and the JAX package's additions), with the same names and defaults."""
    d = TrainConfig()

    # Model
    parser.add_argument("--teacher-model", type=str, default=d.teacher_model)
    parser.add_argument("--student-model", type=str, default=d.student_model)
    parser.add_argument("--fp16", action="store_true")
    parser.add_argument("--input-size", type=int, default=d.input_size)

    # Training
    parser.add_argument("--batch-size", type=int, default=d.batch_size)
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--ema-decay", type=float, default=None)
    parser.add_argument("--label-smoothing", type=float, default=d.label_smoothing)
    parser.add_argument("--drop-path-rate", type=float, default=d.drop_path_rate)
    parser.add_argument("--num-workers", type=int, default=d.num_workers)
    parser.add_argument("--epochs", type=int, default=d.epochs)
    parser.add_argument("--pin-mem", action="store_true", default=True)

    # Optimizer
    parser.add_argument("--opt", type=str, default=d.opt)
    parser.add_argument("--opt-eps", type=float, default=d.opt_eps)
    parser.add_argument("--opt-betas", type=float, nargs="+", default=None)
    parser.add_argument("--clip-grad", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=d.momentum)
    parser.add_argument("--weight-decay", type=float, default=d.weight_decay)

    # Scheduler
    parser.add_argument("--sched", type=str, default=d.sched)
    parser.add_argument("--lr", type=float, default=d.lr)
    parser.add_argument("--lr-noise", type=float, nargs="+", default=None)
    parser.add_argument("--lr-noise-pct", type=float, default=d.lr_noise_pct)
    parser.add_argument("--lr-noise-std", type=float, default=d.lr_noise_std)
    parser.add_argument("--warmup-lr", type=float, default=d.warmup_lr)
    parser.add_argument("--min-lr", type=float, default=d.min_lr)
    parser.add_argument("--decay-epochs", type=float, default=d.decay_epochs)
    parser.add_argument("--warmup-epochs", type=int, default=d.warmup_epochs)
    parser.add_argument("--cooldown-epochs", type=int, default=d.cooldown_epochs)
    parser.add_argument("--patience-epochs", type=int, default=d.patience_epochs)
    parser.add_argument("--decay-rate", "--dr", type=float, default=d.decay_rate)

    # Distributed (accepted for recipe compatibility)
    parser.add_argument("--gpus", type=str, default=None)
    parser.add_argument("--dist-url", type=str, default=d.dist_url)

    # Distillation (the reference's unimplemented vitkd_w_logit / aaakd /
    # aaakd_w_logit are left out of the choices, as in the JAX package)
    parser.add_argument(
        "--distillation-type", type=str, default=d.distillation_type,
        choices=["none", "soft", "hard", "vitkd", "lrkd", "diffkd",
                 "saliency_mgd", "curkd", "wasskd", "mgd"])
    parser.add_argument("--alpha", type=float, default=d.alpha)
    parser.add_argument("--tau", type=float, default=d.tau)
    parser.add_argument("--lrkd-rank", type=int, default=d.lrkd_rank)
    parser.add_argument("--lrkd-alpha", type=float, default=d.lrkd_alpha)
    parser.add_argument("--lrkd-beta", type=float, default=d.lrkd_beta)
    parser.add_argument("--lrkd-gamma", type=float, default=d.lrkd_gamma)
    parser.add_argument("--saliency-method", type=int, default=d.saliency_method)
    parser.add_argument("--saliency-mask-ratio", type=float, default=d.saliency_mask_ratio)
    parser.add_argument("--wasskd-type", type=str, default=d.wasskd_type)
    parser.add_argument("--sinkhorn-iters", type=int, default=d.sinkhorn_iters)
    parser.add_argument("--mgd-alpha", type=float, default=d.mgd_alpha)
    parser.add_argument("--mgd-mask-ratio", type=float, default=d.mgd_mask_ratio)

    # Saving / logging
    parser.add_argument("--log-file", type=str, default=d.log_file)
    parser.add_argument("--save-dir", type=str, default=d.save_dir)
    parser.add_argument("--wandb", action="store_true")
    parser.add_argument("--wandb-project", type=str, default=d.wandb_project)

    # Data
    parser.add_argument("--data-path", type=str, default=d.data_path)
    parser.add_argument("--dataset", type=str, default=d.dataset)
    parser.add_argument("--eval-crop-ratio", type=float, default=d.eval_crop_ratio)

    # Augmentation
    parser.add_argument("--mixup", type=float, default=d.mixup)
    parser.add_argument("--cutmix", type=float, default=d.cutmix)
    parser.add_argument("--cutmix-minmax", type=float, nargs="+", default=None)
    parser.add_argument("--mixup-prob", type=float, default=d.mixup_prob)
    parser.add_argument("--mixup-switch-prob", type=float, default=d.mixup_switch_prob)
    parser.add_argument("--mixup-mode", type=str, default=d.mixup_mode)
    parser.add_argument("--reprob", type=float, default=d.reprob)
    parser.add_argument("--remode", type=str, default=d.remode)
    parser.add_argument("--recount", type=int, default=d.recount)
    parser.add_argument("--resplit", action="store_true", default=False)
    parser.add_argument("--color-jitter", type=float, default=d.color_jitter)
    parser.add_argument("--aa", type=str, default=d.aa)
    parser.add_argument("--smoothing", type=float, default=d.smoothing)
    parser.add_argument("--interpolation", type=str, default=d.interpolation)
    parser.add_argument("--repeated-aug", action="store_true", dest="repeated_aug",
                        default=True)
    parser.add_argument("--no-repeated-aug", action="store_false", dest="repeated_aug")
    parser.add_argument("--ThreeAugment", action="store_true", default=False)
    parser.add_argument("--src", action="store_true", default=False)

    # Misc
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--finetune", action="store_true")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--device", type=str, default=None)

    # the JAX package's additions
    parser.add_argument("--teacher-checkpoint", type=str, default=None)
    parser.add_argument("--mesh-shape", type=int, nargs="+", default=None)
    parser.add_argument("--dtype", type=str, default=d.dtype,
                        choices=["bfloat16", "float32"])
    parser.add_argument("--param-dtype", type=str, default=d.param_dtype)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--eval-steps", type=int, default=None)
    parser.add_argument("--synthetic-data", action="store_true", default=False)
    parser.add_argument("--log-every", type=int, default=d.log_every)
    parser.add_argument("--no-flash-attention", action="store_false",
                        dest="flash_attention", default=True)
    parser.add_argument("--prng-impl", type=str, default=d.prng_impl,
                        choices=["rbg", "threefry2x32"])
    parser.add_argument("--profile-dir", type=str, default=None)
    parser.add_argument("--data-loader", type=str, default=d.data_loader,
                        choices=["python", "tfdata"])
    parser.add_argument("--grad-accum-steps", type=int, default=d.grad_accum_steps)
    parser.add_argument("--aug-pixel-bf16", action=argparse.BooleanOptionalAction,
                        default=d.aug_pixel_bf16)
    parser.add_argument("--allow-random-teacher", action="store_true", default=False)
    return parser


def parse_args(argv=None) -> TrainConfig:
    parser = argparse.ArgumentParser(
        description="ViT knowledge-distillation training (PyTorch/CUDA)")
    add_train_args(parser)
    return config_from_namespace(parser.parse_args(argv))


def config_from_namespace(ns: argparse.Namespace) -> TrainConfig:
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    kw = {k: v for k, v in vars(ns).items() if k in fields}
    for tup_field in ("opt_betas", "lr_noise", "cutmix_minmax", "mesh_shape"):
        if kw.get(tup_field) is not None:
            kw[tup_field] = tuple(kw[tup_field])
    # --fp16 / --amp map to bf16 compute, as in the JAX package (bf16 keeps
    # fp32's exponent range, so no loss scaler)
    if kw.get("fp16") or kw.get("amp"):
        kw["dtype"] = "bfloat16"
    return TrainConfig(**kw).validate()
