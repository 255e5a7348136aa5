#!/usr/bin/env python3
"""Outcome-level accuracy equivalence on the card: the port's production
``run()`` against an independent PyTorch stack, trained to convergence on
the same recipe (a port of ``benchmarks/equivalence_run.py``, whose table
holds the JAX package's ``run()`` to the same stack on the CPU).

* **torch stack**: host PIL transforms (RandomResizedCrop bicubic + flip +
  ColorJitter + Normalize + RandomErasing, written on PIL, the layer
  torchvision wraps), timm-semantic mixup/cutmix and RandAugment, the
  timm-compatible ``TorchViT`` of ``tests/torch_ref.py``, AdamW + the timm
  cosine schedule and the reference's rules for combining the losses
  (reference dataset/datasets.py:53-84, tools/engine.py:8-76,
  tools/train.py:215-367). It runs on the same device as "ours", in fp32
  with TF32 off and cuDNN deterministic, the fp32 reference the JAX table
  had on the CPU.
* **ours**: the port's ``run()`` end to end: host PNG decode
  (``FolderSource`` + ``Loader``), the transform and mixup on the card, the
  KD step on the fused block kernels, the masked eval. The launches of every
  train step and eval batch are counted and held to the fused route's
  (``scripts/run_probe.py``), and no kernel's plain version may run: there
  is no fallback. ``--dtype bfloat16``, the dtype every recipe runs, takes
  the kernels' bf16 forms (rows 1 and 2 of PERF.md's table, rows 10 and 11
  as well for wasskd); the default ``float32`` (the JAX script's) their fp32
  forms.

Both stacks read the same ImageFolder tree (8 procedural texture classes at
256 px, the JAX script's bytes), distil from the same teacher, which the
torch stack trains once (``--teacher-checkpoint``), and take their
hyperparameters from one parsed ``TrainConfig``.

The models keep the JAX harness's depths, patch 8 and 64 px input (N = 66
tokens), at DeiT widths: student ``deit_eqtiny_*_patch8_64`` D = 192, 3
heads, depth 4; teacher ``deit_eqsmall_distilled_patch8_64`` D = 384, 6
heads, depth 6. The JAX harness's D = 64 / 128 with 4 heads have head dims
16 and 32, and the port's kernels take head dim 64 only: at those widths
the port would run no kernel.

Recipes (``--recipe``): ``base`` (RRC + flip + jitter + erasing), ``ra``
(the reference's default ``--aa rand-m9-mstd0.5-inc1``, jitter off as timm
does), ``3aug`` (``--ThreeAugment --src``). ``--ours-pixel-bf16`` turns the
port's bf16 pixel stage on (ours only).

Usage:
    python3 scripts/equivalence_run.py [--objective all] [--seeds 0 1 2]
        [--recipe base|ra|3aug] [--dtype bfloat16|float32] [--quick]
    python3 scripts/equivalence_run.py --device cpu ...   # on the CPU

A finished (stack, objective, seed) row is kept in the workdir's results
cache, keyed by everything that changes it (the device, the teacher's
bytes, and ours' dtype and pixel stage), so that the tables of one
workdir share their torch rows. Each table is written into its own
section of ``--out`` (default docs/EQUIVALENCE_TORCH.md), with the card's
name and power limit, the date and the commit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.join(REPO, "scripts"))

IMG_SRC = 256         # generated image size (both stacks crop/resize to 64); the
                      # port's FolderSource canvas, so ours applies no host resample
INPUT = 64
NUM_CLASSES = 8
MEAN = (0.5, 0.5, 0.5)
STD = (0.25, 0.25, 0.25)

# harness-scale models, registered at runtime into the port's registries
STUDENT_SOFT = "deit_eqtiny_distilled_patch8_64"
STUDENT_PLAIN = "deit_eqtiny_patch8_64"
TEACHER = "deit_eqsmall_distilled_patch8_64"
HARNESS_MODELS = {
    STUDENT_SOFT: dict(embed_dim=192, depth=4, num_heads=3, distilled=True),
    STUDENT_PLAIN: dict(embed_dim=192, depth=4, num_heads=3, distilled=False),
    TEACHER: dict(embed_dim=384, depth=6, num_heads=6, distilled=True),
}
OBJECTIVES = {"both": ["soft", "mgd"], "all": ["soft", "mgd", "wasskd", "vitkd"]}
DEFAULT_OUT = os.path.join(REPO, "docs", "EQUIVALENCE_TORCH.md")


# ---------------------------------------------------------------------------
# Dataset: 8 procedural texture classes = 4 patterns x 2 frequency bands,
# with per-image phase/scale/brightness/noise variation so val accuracy sits
# below the ceiling and pipeline differences have room to show.
# ---------------------------------------------------------------------------

def _texture(rng: np.random.RandomState, cls: int) -> np.ndarray:
    pattern, band = cls % 4, cls // 4
    # periods scale with the canvas so angular frequency at the final 64px
    # input is source-size-invariant
    scale = IMG_SRC / 96.0
    period = (rng.uniform(6, 9) if band == 0 else rng.uniform(14, 20)) * scale
    phase = rng.uniform(0, 2 * math.pi)
    yy, xx = np.meshgrid(np.arange(IMG_SRC), np.arange(IMG_SRC), indexing="ij")
    theta = rng.uniform(-0.25, 0.25)  # small rotation jitter
    yr = yy * math.cos(theta) - xx * math.sin(theta)
    xr = yy * math.sin(theta) + xx * math.cos(theta)
    if pattern == 0:
        v = np.sin(2 * math.pi * yr / period + phase)
    elif pattern == 1:
        v = np.sin(2 * math.pi * xr / period + phase)
    elif pattern == 2:
        v = np.sin(2 * math.pi * yr / period + phase) * \
            np.sin(2 * math.pi * xr / period + phase)
    else:
        r = np.sqrt((yr - IMG_SRC / 2) ** 2 + (xr - IMG_SRC / 2) ** 2)
        v = np.sin(2 * math.pi * r / period + phase)
    base = rng.uniform(90, 165)
    amp = rng.uniform(45, 80)
    img = base + amp * v[..., None] * rng.uniform(0.7, 1.3, (1, 1, 3))
    img = img + rng.normal(0, 18, (IMG_SRC, IMG_SRC, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def generate_dataset(root: str, n_train_per_class: int, n_val_per_class: int,
                     seed: int = 0) -> None:
    from PIL import Image

    rng = np.random.RandomState(seed)
    for split, n in (("train", n_train_per_class), ("val", n_val_per_class)):
        for cls in range(NUM_CLASSES):
            d = os.path.join(root, split, f"class_{cls:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                Image.fromarray(_texture(rng, cls)).save(
                    os.path.join(d, f"{i:04d}.png"))
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump({"img_src": IMG_SRC, "n_train": n_train_per_class,
                   "n_val": n_val_per_class, "seed": seed}, f)


def dataset_matches(root: str, n_train: int, n_val: int) -> bool:
    """Refuse to silently reuse a stale workdir generated with different
    sizes/canvas (the harness caches the dataset AND the teacher on disk)."""
    meta_path = os.path.join(root, "meta.json")
    if not os.path.isfile(meta_path):
        return False
    with open(meta_path) as f:
        meta = json.load(f)
    return (meta.get("img_src") == IMG_SRC and meta.get("n_train") == n_train
            and meta.get("n_val") == n_val)


# ---------------------------------------------------------------------------
# torch stack
# ---------------------------------------------------------------------------

class HostRandAugment:
    """timm-semantic RandAugment (``rand-m9-mstd0.5-inc1``) written directly
    on PIL/ImageOps, the layer timm wraps. Semantics follow timm
    auto_augment.py: ``num_layers`` draws, each op uniform over the
    15-entry increasing-transform table, gated by ``prob``, magnitude
    ``gauss(m, mstd)`` clipped to [0, 10], increasing level->arg maps,
    bicubic resampling for geometric ops (the recipe's --interpolation),
    dataset-mean fill."""

    def __init__(self, rng: np.random.RandomState, magnitude=9.0, mstd=0.5,
                 num_layers=2, prob=0.5):
        self.rng = rng
        self.m, self.mstd = magnitude, mstd
        self.num_layers, self.prob = num_layers, prob
        self.fill = tuple(min(255, round(255 * m)) for m in MEAN)

    def _neg(self, v):
        return -v if self.rng.rand() < 0.5 else v

    def _enhance(self, img, enhancer, m):
        from PIL import ImageEnhance

        factor = max(0.1, 1.0 + self._neg(m / 10.0 * 0.9))
        return getattr(ImageEnhance, enhancer)(img).enhance(factor)

    def _affine(self, img, data):
        from PIL import Image

        return img.transform(img.size, Image.AFFINE, data, Image.BICUBIC,
                             fillcolor=self.fill)

    def _apply_op(self, img, op, m):
        from PIL import Image, ImageOps

        W, H = img.size
        if op == 0:
            return ImageOps.autocontrast(img)
        if op == 1:
            return ImageOps.equalize(img)
        if op == 2:
            return ImageOps.invert(img)
        if op == 3:  # Rotate
            return img.rotate(self._neg(m / 10.0 * 30.0), Image.BICUBIC,
                              fillcolor=self.fill)
        if op == 4:  # PosterizeIncreasing; clamped to >= 1 bit
            return ImageOps.posterize(img, max(1, 4 - int(m / 10.0 * 4)))
        if op == 5:  # SolarizeIncreasing
            return ImageOps.solarize(img, 256 - int(m / 10.0 * 256))
        if op == 6:  # SolarizeAdd (threshold 128)
            arr = np.asarray(img, np.int16)
            add = int(m / 10.0 * 110)
            arr = np.where(arr < 128, np.clip(arr + add, 0, 255), arr)
            return Image.fromarray(arr.astype(np.uint8))
        if op == 7:
            return self._enhance(img, "Color", m)
        if op == 8:
            return self._enhance(img, "Contrast", m)
        if op == 9:
            return self._enhance(img, "Brightness", m)
        if op == 10:
            return self._enhance(img, "Sharpness", m)
        if op == 11:  # ShearX
            return self._affine(img, (1, self._neg(m / 10.0 * 0.3), 0,
                                      0, 1, 0))
        if op == 12:  # ShearY
            return self._affine(img, (1, 0, 0,
                                      self._neg(m / 10.0 * 0.3), 1, 0))
        if op == 13:  # TranslateXRel (pct 0.45)
            return self._affine(img, (1, 0, self._neg(m / 10.0 * 0.45 * W),
                                      0, 1, 0))
        # 14: TranslateYRel
        return self._affine(img, (1, 0, 0,
                                  0, 1, self._neg(m / 10.0 * 0.45 * H)))

    def __call__(self, img):
        for _ in range(self.num_layers):
            op = self.rng.randint(0, 15)
            if self.rng.rand() > self.prob:
                continue
            m = float(np.clip(self.rng.normal(self.m, self.mstd), 0.0, 10.0))
            img = self._apply_op(img, op, m)
        return img


class HostPipeline:
    """The torchvision/timm host transform stack, written directly on PIL
    (torchvision wraps exactly these PIL calls). Semantics follow
    torchvision's documented algorithms: RandomResizedCrop (scale (0.08,1),
    log-ratio (3/4,4/3), 10 tries then center fallback),
    RandomHorizontalFlip, ColorJitter via ImageEnhance in random order,
    Normalize, RandomErasing(value='random'). ``recipe`` picks the aug stack
    between RRC+flip and normalize: 'base' = ColorJitter; 'ra' =
    HostRandAugment, jitter off (timm drops jitter when --aa is set, timm
    transforms_factory.py); '3aug' = reference tools/augment.py:84-117
    (resize + reflect-pad RandomCrop + flip + RandomChoice{gray, solarize,
    blur} + jitter, no erasing)."""

    def __init__(self, train: bool, rng: np.random.RandomState,
                 recipe: str = "base"):
        self.train = train
        self.rng = rng
        self.recipe = recipe
        self.ra = HostRandAugment(rng) if (train and recipe == "ra") else None

    def _rrc(self, img):
        from PIL import Image

        W, H = img.size
        area = H * W
        for _ in range(10):
            target = area * self.rng.uniform(0.08, 1.0)
            ar = math.exp(self.rng.uniform(math.log(3 / 4), math.log(4 / 3)))
            w = int(round(math.sqrt(target * ar)))
            h = int(round(math.sqrt(target / ar)))
            if 0 < w <= W and 0 < h <= H:
                top = self.rng.randint(0, H - h + 1)
                left = self.rng.randint(0, W - w + 1)
                return img.resize((INPUT, INPUT), Image.BICUBIC,
                                  box=(left, top, left + w, top + h))
        side = min(H, W)
        top, left = (H - side) // 2, (W - side) // 2
        return img.resize((INPUT, INPUT), Image.BICUBIC,
                          box=(left, top, left + side, top + side))

    def _jitter(self, img, j=0.4):
        from PIL import ImageEnhance

        ops = [ImageEnhance.Brightness, ImageEnhance.Contrast,
               ImageEnhance.Color]
        order = self.rng.permutation(3)
        for i in order:
            f = self.rng.uniform(max(0.0, 1 - j), 1 + j)
            img = ops[i](img).enhance(f)
        return img

    def _src_crop(self, img):
        """reference tools/augment.py:91-96 (--src): Resize(S, bicubic) +
        RandomCrop(S, padding=4, padding_mode='reflect')."""
        from PIL import Image

        W, H = img.size
        scale = INPUT / min(W, H)
        img = img.resize((round(W * scale), round(H * scale)), Image.BICUBIC)
        arr = np.pad(np.asarray(img), ((4, 4), (4, 4), (0, 0)),
                     mode="reflect")
        top = self.rng.randint(0, arr.shape[0] - INPUT + 1)
        left = self.rng.randint(0, arr.shape[1] - INPUT + 1)
        return Image.fromarray(arr[top:top + INPUT, left:left + INPUT])

    def _three_aug_choice(self, img):
        """RandomChoice{Grayscale(3), Solarization(128), GaussianBlur} -
        reference tools/augment.py:18-64,105-107."""
        from PIL import ImageFilter, ImageOps

        pick = self.rng.randint(0, 3)
        if pick == 0:
            return img.convert("L").convert("RGB")
        if pick == 1:
            return ImageOps.solarize(img)
        return img.filter(ImageFilter.GaussianBlur(
            radius=self.rng.uniform(0.1, 2.0)))

    def __call__(self, img):
        import torch
        from PIL import Image

        if self.train:
            if self.recipe == "3aug":
                img = self._src_crop(img)
                if self.rng.rand() < 0.5:
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
                img = self._three_aug_choice(img)
                img = self._jitter(img)
            else:
                img = self._rrc(img)
                if self.rng.rand() < 0.5:
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
                if self.ra is not None:
                    img = self.ra(img)
                else:
                    img = self._jitter(img)
        else:
            W, H = img.size
            size = int(INPUT / 0.875)
            scale = size / min(W, H)
            img = img.resize((round(W * scale), round(H * scale)),
                             Image.BICUBIC)
            W, H = img.size
            top, left = (H - INPUT) // 2, (W - INPUT) // 2
            img = img.crop((left, top, left + INPUT, top + INPUT))
        x = torch.from_numpy(
            np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0)
        x = (x - torch.tensor(MEAN)[:, None, None]) / torch.tensor(STD)[:, None, None]
        # no RandomErasing under 3-Augment (the reference swaps the whole
        # transform for new_data_aug_generator, which has none)
        if self.train and self.recipe != "3aug" and self.rng.rand() < 0.25:
            # RandomErasing: scale (0.02, 1/3), log-ratio (0.3, 3.3), noise fill
            for _ in range(10):
                target = INPUT * INPUT * self.rng.uniform(0.02, 1 / 3)
                ar = math.exp(self.rng.uniform(math.log(0.3), math.log(3.3)))
                h = int(round(math.sqrt(target * ar)))
                w = int(round(math.sqrt(target / ar)))
                if 0 < h <= INPUT and 0 < w <= INPUT:
                    top = self.rng.randint(0, INPUT - h + 1)
                    left = self.rng.randint(0, INPUT - w + 1)
                    x[:, top:top + h, left:left + w] = torch.from_numpy(
                        self.rng.randn(3, h, w).astype(np.float32))
                    break
        return x


class FolderDataset:
    """Minimal ImageFolder (torchvision is not a dependency). Each file is
    decoded once and kept (the transforms never change their input), so
    that the host's time goes to the transforms."""

    def __init__(self, root: str, pipeline: HostPipeline):
        self.samples = []
        for ci, cls in enumerate(sorted(os.listdir(root))):
            d = os.path.join(root, cls)
            for f in sorted(os.listdir(d)):
                self.samples.append((os.path.join(d, f), ci))
        self.pipeline = pipeline
        self.decoded = {}

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image

        path, label = self.samples[i]
        img = self.decoded.get(i)
        if img is None:
            img = self.decoded[i] = Image.open(path).convert("RGB")
        return self.pipeline(img), label


class TorchMixup:
    """timm Mixup 'batch' mode semantics (what the reference configures,
    tools/train.py:288-295), on the host."""

    def __init__(self, mixup_alpha, cutmix_alpha, prob, switch_prob,
                 smoothing, num_classes, rng):
        self.ma, self.ca, self.prob = mixup_alpha, cutmix_alpha, prob
        self.sp, self.sm, self.nc = switch_prob, smoothing, num_classes
        self.rng = rng

    def _one_hot(self, labels):
        import torch

        on = 1.0 - self.sm + self.sm / self.nc
        off = self.sm / self.nc
        t = torch.full((labels.shape[0], self.nc), off)
        t.scatter_(1, labels[:, None], on)
        return t

    def __call__(self, images, labels):
        targets = self._one_hot(labels)
        if self.rng.rand() >= self.prob:
            return images, targets
        use_cutmix = self.ca > 0 and (self.ma <= 0 or self.rng.rand() < self.sp)
        if use_cutmix:
            lam = float(self.rng.beta(self.ca, self.ca))
            H, W = images.shape[2:]
            ratio = math.sqrt(1.0 - lam)
            ch, cw = int(H * ratio), int(W * ratio)
            cy, cx = self.rng.randint(H), self.rng.randint(W)
            y0, y1 = max(cy - ch // 2, 0), min(cy + ch // 2, H)
            x0, x1 = max(cx - cw // 2, 0), min(cx + cw // 2, W)
            images = images.clone()
            images[:, :, y0:y1, x0:x1] = images.flip(0)[:, :, y0:y1, x0:x1]
            lam = 1.0 - (y1 - y0) * (x1 - x0) / float(H * W)
        else:
            lam = float(self.rng.beta(self.ma, self.ma))
            images = lam * images + (1.0 - lam) * images.flip(0)
        targets = lam * targets + (1.0 - lam) * targets.flip(0)
        return images, targets


def _cosine_lr(cfg, epoch: int) -> float:
    """timm CosineLRScheduler at integer epochs."""
    if epoch < cfg.warmup_epochs:
        return cfg.warmup_lr + epoch * (cfg.lr - cfg.warmup_lr) / max(
            cfg.warmup_epochs, 1)
    if epoch >= cfg.epochs:
        return cfg.min_lr
    t = min(max(epoch, 0), cfg.epochs)
    return cfg.min_lr + 0.5 * (cfg.lr - cfg.min_lr) * (
        1.0 + math.cos(math.pi * t / cfg.epochs))


def _adamw_groups(model_params, extra_params=()):
    """timm-style decay split: no weight decay for 1-D params (LN, biases)."""
    decay, no_decay = [], []
    for p in list(model_params) + list(extra_params):
        (decay if p.ndim >= 2 else no_decay).append(p)
    return decay, no_decay


def _soft_ce(logits, targets):
    import torch.nn.functional as F

    return (-targets * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()


def _torch_eval(model, loader, device):
    import torch

    model.eval()
    correct = total = 0
    with torch.no_grad():
        for x, y in loader:
            logits = model(x.to(device))
            correct += (logits.argmax(-1).cpu() == y).sum().item()
            total += y.shape[0]
    model.train()
    return 100.0 * correct / total


@contextlib.contextmanager
def fp32_reference():
    """The torch stack's numerics on the card: fp32 products without TF32,
    cuDNN's deterministic algorithms; the flags are restored after."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def torch_vit(name: str):
    """The torch stack's TorchViT of a registered harness model, built on the
    CPU from the global generator."""
    from torch_ref import TorchViT

    from deltakd_tpu_torch.models.registry import MODEL_REGISTRY

    c = MODEL_REGISTRY[name]
    return TorchViT(img_size=INPUT, patch=c.patch_size, dim=c.embed_dim, depth=c.depth,
                    num_heads=c.num_heads, num_classes=NUM_CLASSES, distilled=c.distilled)


def _loaders(cfg, root, train_pipeline, seed):
    import torch

    train_ds = FolderDataset(os.path.join(root, "train"), train_pipeline)
    val_ds = FolderDataset(os.path.join(root, "val"),
                           HostPipeline(False, np.random.RandomState(0)))
    g = torch.Generator().manual_seed(seed)
    train_ld = torch.utils.data.DataLoader(
        train_ds, batch_size=cfg.batch_size, shuffle=True, generator=g,
        num_workers=0, drop_last=True)
    val_ld = torch.utils.data.DataLoader(val_ds, batch_size=cfg.batch_size,
                                         num_workers=0)
    return train_ld, val_ld


def _finite(what, value):
    if not math.isfinite(float(value)):
        raise FloatingPointError(f"{what}: non-finite value {value}")


def torch_train_teacher(cfg, root: str, out_path: str, epochs: int,
                        device: str = "cuda") -> float:
    """Supervised pretraining of the teacher (both stacks then import these
    exact weights)."""
    import torch

    with fp32_reference():
        torch.manual_seed(1234)
        train_ld, val_ld = _loaders(cfg, root, HostPipeline(True, np.random.RandomState(1234)),
                                    1234)
        model = torch_vit(TEACHER).to(device)
        decay, no_decay = _adamw_groups(model.parameters())
        opt = torch.optim.AdamW(
            [{"params": decay, "weight_decay": cfg.weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=cfg.lr, betas=(0.9, 0.999), eps=cfg.opt_eps)
        mixup = TorchMixup(cfg.mixup, cfg.cutmix, cfg.mixup_prob,
                           cfg.mixup_switch_prob, cfg.smoothing, NUM_CLASSES,
                           np.random.RandomState(1234))
        for epoch in range(epochs):
            lr = _cosine_lr(cfg.replace(epochs=epochs), epoch)
            for grp in opt.param_groups:
                grp["lr"] = lr
            for x, y in train_ld:
                x, targets = mixup(x, y)
                x, targets = x.to(device), targets.to(device)
                cls_logits, dist_logits, _ = model.forward_with_features(x)
                loss = 0.5 * (_soft_ce(cls_logits, targets)
                              + _soft_ce(dist_logits, targets))
                opt.zero_grad()
                loss.backward()
                opt.step()
        _finite("the torch teacher's last loss", loss.item())
        acc = _torch_eval(model, val_ld, device)
    torch.save({"model": {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               out_path)
    return acc


def _timm_init(model) -> None:
    """The reference creates its student via timm ``create_model`` (reference
    model/models.py), whose DeiT init is trunc_normal(std=.02) on every
    Linear/Conv weight with zeroed biases - NOT torch's kaiming_uniform
    defaults. The port's models implement exactly that, so the harness's
    torch student must too; otherwise the two stacks train from different
    init distributions (wasskd's x5 feature term makes the early trajectory
    init-sensitive)."""
    import torch.nn as nn

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            nn.init.trunc_normal_(m.weight, std=0.02)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    for tok in ("cls_token", "dist_token", "pos_embed"):
        if hasattr(model, tok):
            nn.init.trunc_normal_(getattr(model, tok), std=0.02)


def torch_train_student(cfg, root: str, teacher_path: str, objective: str,
                        seed: int, recipe: str = "base", device: str = "cuda") -> dict:
    """The torch analogue of run(): host transforms -> TorchViT -> reference
    loss combine -> AdamW/cosine -> center-crop eval. Every draw comes from
    the CPU's generators, as on the CPU; tensors then move to ``device``."""
    import torch
    import torch.nn as nn
    from torch_ref import torch_mgd, torch_soft_kd, torch_vitkd, torch_wasskd_l1

    with fp32_reference():
        torch.manual_seed(seed)
        train_ld, val_ld = _loaders(
            cfg, root, HostPipeline(True, np.random.RandomState(seed), recipe), seed)

        teacher = torch_vit(TEACHER)
        teacher.load_state_dict(torch.load(teacher_path)["model"])
        teacher.to(device).eval()
        dt = teacher.norm.normalized_shape[0]

        student = torch_vit(STUDENT_SOFT if objective == "soft" else STUDENT_PLAIN)
        ds = student.norm.normalized_shape[0]
        n_patches = student.pos_embed.shape[1] - (2 if student.distilled else 1)
        _timm_init(student)  # reference init (timm create_model), see helper
        # the aux heads draw their initial weights in the reference's order;
        # mask_token starts at zero (no draw)
        aux_mods = []
        if objective == "mgd":
            align = nn.Linear(ds, dt)
            mask_token = nn.Parameter(torch.zeros(1, 1, dt, device=device))
            gen1 = nn.Conv2d(dt, dt, 3, padding=1)
            gen2 = nn.Conv2d(dt, dt, 3, padding=1)
            aux_mods = [align, gen1, gen2]
        elif objective == "wasskd":
            # reference model/loss.py:187-199 - one align linear per block 0-2
            wass_aligns = [nn.Linear(ds, dt) for _ in range(3)]
            aux_mods = list(wass_aligns)
        elif objective == "vitkd":
            # reference model/models.py:76-88 - blocks 0,1 mimicking aligns +
            # the last block's generation head (mask_token fill + 2 convs)
            align2 = [nn.Linear(ds, dt) for _ in range(2)]
            align = nn.Linear(ds, dt)
            mask_token = nn.Parameter(torch.zeros(1, 1, dt, device=device))
            gen1 = nn.Conv2d(dt, dt, 3, padding=1)
            gen2 = nn.Conv2d(dt, dt, 3, padding=1)
            aux_mods = align2 + [align, gen1, gen2]
        student.to(device)
        for m in aux_mods:
            m.to(device)
        aux_params = [p for m in aux_mods for p in m.parameters()]
        if objective in ("mgd", "vitkd"):
            aux_params.append(mask_token)

        decay, no_decay = _adamw_groups(student.parameters(), aux_params)
        opt = torch.optim.AdamW(
            [{"params": decay, "weight_decay": cfg.weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=cfg.lr, betas=(0.9, 0.999), eps=cfg.opt_eps)
        mixup = TorchMixup(cfg.mixup, cfg.cutmix, cfg.mixup_prob,
                           cfg.mixup_switch_prob, cfg.smoothing, NUM_CLASSES,
                           np.random.RandomState(seed))

        best = 0.0
        for epoch in range(cfg.epochs):
            lr = _cosine_lr(cfg, epoch)
            for grp in opt.param_groups:
                grp["lr"] = lr
            for x, y in train_ld:
                x, targets = mixup(x, y)
                noise = None
                if objective in ("mgd", "vitkd"):   # one draw per patch token
                    noise = torch.rand(x.shape[0], n_patches).to(device)
                x, targets = x.to(device), targets.to(device)
                # torch_ref's masking makes its mask with torch.ones: on ``device``
                with torch.device(device):
                    with torch.no_grad():
                        t_logits = teacher(x)
                        if objective in ("mgd", "wasskd", "vitkd"):
                            _, _, t_feats = teacher.forward_with_features(x)
                    cls_logits, dist_logits, s_feats = student.forward_with_features(x)
                    base = _soft_ce(cls_logits, targets)
                    if objective == "soft":
                        distill = torch_soft_kd(dist_logits, t_logits, cfg.tau)
                        loss = base * (1.0 - cfg.alpha) + distill * cfg.alpha
                    elif objective == "wasskd":
                        distill = torch_wasskd_l1(s_feats, t_feats, wass_aligns)
                        loss = base + distill * 5.0  # reference loss.py:226
                    elif objective == "vitkd":
                        distill = torch_vitkd(s_feats, t_feats, align2, align,
                                              mask_token, gen1, gen2, noise)
                        loss = base + distill  # additive early-return, loss.py:78
                    else:
                        distill = torch_mgd(s_feats[-1], t_feats[-1], align,
                                            mask_token, gen1, gen2, noise,
                                            cfg.mgd_mask_ratio, cfg.mgd_alpha)
                        loss = base + distill
                opt.zero_grad()
                loss.backward()
                opt.step()
            _finite(f"torch {objective} seed {seed} epoch {epoch} loss", loss.item())
            acc = _torch_eval(student, val_ld, device)
            best = max(best, acc)
    return {"final_acc": acc, "best_acc": best}


# ---------------------------------------------------------------------------
# our stack (the port's run())
# ---------------------------------------------------------------------------

def register_harness_entries() -> None:
    """The texture dataset's statistics and the harness's models, put into the
    port's registries at runtime (never into the package's own lists)."""
    from deltakd_tpu_torch.data.registry import DATASET_STATS
    from deltakd_tpu_torch.models.registry import MODEL_REGISTRY
    from deltakd_tpu_torch.models.vit import ViTConfig

    DATASET_STATS.setdefault("texture8", {
        "mean": MEAN, "std": STD, "num_classes": NUM_CLASSES})
    for name, dims in HARNESS_MODELS.items():
        MODEL_REGISTRY.setdefault(name, ViTConfig(img_size=INPUT, patch_size=8, **dims))


def make_cfg(root: str, teacher_path: str, objective: str, seed: int,
             epochs: int, workdir: str, recipe: str = "base",
             pixel_bf16: bool = False, dtype: str = "float32", device=None,
             batch_size: int = 64):
    from deltakd_tpu_torch.configs.config import parse_args

    student = STUDENT_SOFT if objective == "soft" else STUDENT_PLAIN
    run_id = f"ours_{objective}_{seed}" + \
        ("" if recipe == "base" else f"_{recipe}") + \
        ("_bf16" if pixel_bf16 else "") + \
        ("" if dtype == "float32" else f"_{dtype}")
    argv = [
        "--dataset", "texture8", "--data-path", root,
        "--input-size", str(INPUT), "--batch-size", str(batch_size),
        "--epochs", str(epochs), "--warmup-epochs", "3",
        "--lr", "5e-4", "--min-lr", "1e-5", "--warmup-lr", "1e-6",
        "--weight-decay", "0.05", "--dtype", dtype,
        "--prng-impl", "threefry2x32",
        "--drop-path-rate", "0.0",
        # recipe: 'ra' = the reference's default --aa (timm then ignores
        # --color-jitter); '3aug' swaps the transform like reference
        # train.py:261-262 (from_config ignores --aa/--reprob under it)
        "--aa", "rand-m9-mstd0.5-inc1" if recipe == "ra" else "",
        "--color-jitter", "0.4", "--reprob", "0.25",
        "--mixup", "0.8", "--cutmix", "1.0", "--smoothing", "0.1",
        "--interpolation", "bicubic", "--no-repeated-aug",
        "--distillation-type", objective,
        "--student-model", student, "--teacher-model", TEACHER,
        "--teacher-checkpoint", teacher_path,
        "--seed", str(seed),
        "--log-file", os.path.join(workdir, f"{run_id}.log"),
        "--save-dir", os.path.join(workdir, run_id)]
    if recipe == "3aug":
        argv += ["--ThreeAugment", "--src"]
    # Pin the pixel-stage dtype explicitly: the torch side is fp32, so the
    # default comparison runs ours' pixel stage in fp32 too regardless of the
    # production default (bf16); the bf16 probe opts in deliberately.
    argv += ["--aug-pixel-bf16" if pixel_bf16 else "--no-aug-pixel-bf16"]
    if device is not None:
        argv += ["--device", device]
    return parse_args(argv)


def ours_train_student(root: str, teacher_path: str, objective: str,
                       seed: int, epochs: int, workdir: str,
                       recipe: str = "base", pixel_bf16: bool = False,
                       dtype: str = "float32", device: str = "cuda",
                       batch_size: int = 64) -> dict:
    """The port's run() on ``device``, its launches counted around it: on the
    card each train step and eval batch must launch the fused route's
    kernels and no plain version may run."""
    import torch

    from run_probe import RunLaunches, fused_route_launches, launch_names

    from deltakd_tpu_torch.train import loop

    cfg = make_cfg(root, teacher_path, objective, seed, epochs, workdir, recipe,
                   pixel_bf16, dtype, device, batch_size)
    with RunLaunches() as probe:
        metrics = loop.run(cfg)
    totals = probe.check(f"ours {objective} seed {seed}", *fused_route_launches(cfg),
                         torch.device(device).type == "cuda")
    for k in ("val_acc1", "val_loss"):
        _finite(f"ours {objective} seed {seed} {k}", metrics[k])
    return {"final_acc": metrics["val_acc1"], "best_acc": metrics["best_val_acc"],
            "launches": launch_names(totals), "steps": len(probe.steps)}


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def band_verdict(torch_accs, ours_accs):
    """(|mean delta|, band, 'WITHIN' or 'OUTSIDE'): the band is the seed noise,
    max(2.0, min(1.5 x the larger seed spread, 3.0)) points."""
    delta = abs(float(np.mean(ours_accs)) - float(np.mean(torch_accs)))
    spread = max(float(np.ptp(torch_accs)), float(np.ptp(ours_accs)))
    # capped at 3 points: with 2 seeds a spread-scaled band inflates to ~6,
    # wide enough to miss a real regression
    band = max(2.0, min(1.5 * spread, 3.0))
    return delta, band, "WITHIN" if delta <= band else "OUTSIDE"


def _teacher_fingerprint(teacher_path: str) -> str:
    """Cheap content fingerprint so cached student results are invalidated if
    the cached teacher checkpoint is ever regenerated (both sides distill from
    these exact weights)."""
    import hashlib

    h = hashlib.sha1()
    with open(teacher_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:16]


def _load_cache(path: str) -> dict:
    if os.path.isfile(path):
        with open(path) as f:
            return json.load(f)
    return {}


def card_line(device: str) -> str:
    """nvidia-smi's name and power limit of the card, or what ran instead."""
    if not device.startswith("cuda"):
        return f"no card: device {device}"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _commit(given):
    if given:
        return given
    try:
        out = subprocess.run(["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10)
        dirty = subprocess.run(["git", "-C", REPO, "status", "--porcelain"],
                               capture_output=True, text=True, timeout=10).stdout
    except OSError:
        return "not a git checkout"
    if out.returncode:
        return "not a git checkout"
    return out.stdout.strip() + (" with uncommitted changes" if dirty.strip() else "")


def table_key(recipe, dtype, pixel_bf16):
    return f"recipe {recipe}, ours {dtype}" + (", ours pixel stage bf16" if pixel_bf16 else "")


HEADER = ("# Outcome-level equivalence on the card: the port's run() against an "
          "independent PyTorch stack\n\n"
          "Written by `scripts/equivalence_run.py`, one section a table (recipe, ours' "
          "dtype, ours' pixel stage). Each row trains the same recipe to convergence on "
          "both stacks from the same teacher; a verdict is WITHIN when the mean final val "
          "top-1 of the seeds differs by no more than the band, max(2.0, min(1.5 x the "
          "larger seed spread, 3.0)) points.\n")


def put_section(path: str, key: str, lines) -> None:
    """Writes ``lines`` as the section ``key`` of the markdown file ``path``,
    replacing a section of that key and keeping the others."""
    begin, end = f"<!-- table: {key} -->", f"<!-- end: {key} -->"
    text = HEADER
    if os.path.isfile(path):
        with open(path) as f:
            text = f.read()
    block = "\n".join([begin] + list(lines) + [end])
    if begin in text and end in text:
        head, rest = text.split(begin, 1)
        text = head + block + rest.split(end, 1)[1]
    else:
        text = text.rstrip("\n") + "\n\n" + block + "\n"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def parse_cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="32/16 images a class, 6 epochs, a teacher of 4 epochs")
    ap.add_argument("--objective",
                    choices=["soft", "mgd", "wasskd", "vitkd", "both", "all"],
                    default="both",
                    help="'both' = soft+mgd; 'all' adds wasskd (l1: the sorted_l1 "
                         "kernels) and vitkd (random masking + mask_token fill + conv "
                         "generation head)")
    ap.add_argument("--recipe", choices=["base", "ra", "3aug"], default="base",
                    help="augmentation recipe on BOTH stacks: base = RRC+flip+jitter+"
                         "erasing; ra = the reference default --aa rand-m9-mstd0.5-inc1; "
                         "3aug = --ThreeAugment --src")
    ap.add_argument("--ours-pixel-bf16", action="store_true",
                    help="run ours with --aug-pixel-bf16 (torch side stays fp32)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                    help="ours' dtype: float32 takes the kernels' fp32 forms, bfloat16 "
                         "(every recipe's) their bf16 forms")
    ap.add_argument("--device", default="cuda",
                    help="both stacks' device (cpu: the plain PyTorch path)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--train-per-class", type=int, default=None)
    ap.add_argument("--val-per-class", type=int, default=None)
    ap.add_argument("--teacher-epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--workdir",
                    default=os.path.join(tempfile.gettempdir(), "deltakd_torch_equivalence"))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--commit", default=None,
                    help="the commit named in the table (default: git's, where the "
                         "checkout has .git)")
    ap.add_argument("--prepare", action="store_true",
                    help="only write the dataset and train the teacher")
    return ap.parse_args(argv)


def compare(argv=None) -> dict:
    """Runs the tables' rows (cached ones are read back) and writes the
    table. Returns the rows, each objective's (delta, band, verdict), the
    teacher's val top-1 and ``ok``: every objective WITHIN its band."""
    args = parse_cli(argv)
    register_harness_entries()

    n_train = args.train_per_class or (32 if args.quick else 128)
    n_val = args.val_per_class or (16 if args.quick else 32)
    epochs = args.epochs or (6 if args.quick else 40)
    teacher_epochs = args.teacher_epochs or (4 if args.quick else 30)
    objectives = OBJECTIVES.get(args.objective, [args.objective])

    root = os.path.join(args.workdir, "data")
    os.makedirs(args.workdir, exist_ok=True)
    teacher_path = os.path.join(args.workdir, "teacher.pth")
    teacher_acc_path = os.path.join(args.workdir, "teacher_acc.json")
    if not dataset_matches(root, n_train, n_val):
        if os.path.isdir(root):
            import shutil

            print(f"stale/mismatched dataset under {root} - regenerating (and discarding "
                  f"the cached teacher, which was trained on it)")
            shutil.rmtree(root)
            if os.path.isfile(teacher_path):
                os.remove(teacher_path)
        print(f"generating dataset under {root} ...", flush=True)
        t0 = time.time()
        generate_dataset(root, n_train, n_val, seed=0)
        print(f"dataset: {time.time() - t0:.1f} s", flush=True)

    # one parsed config is the single source of hyperparameters for BOTH sides
    ref_cfg = make_cfg(root, "", "soft", 0, epochs, args.workdir, args.recipe,
                       batch_size=args.batch_size)

    if not os.path.isfile(teacher_path):
        t0 = time.time()
        teacher_acc = torch_train_teacher(ref_cfg, root, teacher_path, teacher_epochs,
                                          args.device)
        with open(teacher_acc_path, "w") as f:
            json.dump({"val_acc1": teacher_acc}, f)
        print(f"teacher pretrained: val top-1 {teacher_acc:.2f}% "
              f"({time.time() - t0:.0f}s)", flush=True)
    elif os.path.isfile(teacher_acc_path):
        with open(teacher_acc_path) as f:
            teacher_acc = json.load(f)["val_acc1"]
    else:
        teacher_acc = None
    if args.prepare:
        return {"teacher_acc": teacher_acc, "teacher": teacher_path}

    # results cache: keyed per stack by everything that changes the outcome,
    # the teacher's bytes and the device too, and ours' dtype and pixel stage;
    # the torch rows do not depend on ours' settings and are shared between
    # the tables of one workdir
    cache_path = os.path.join(args.workdir, "results_cache.json")
    cache = _load_cache(cache_path)
    tfp = _teacher_fingerprint(teacher_path)
    device_kind = args.device.split(":")[0]

    def _one(stack: str, objective: str, seed: int) -> dict:
        tag = (f"|seed{seed}|ep{epochs}|n{n_train}x{n_val}|teacher:{tfp}|{device_kind}"
               + ("" if args.batch_size == 64 else f"|b{args.batch_size}"))
        rec = "" if args.recipe == "base" else f"|{args.recipe}"
        ours = ""
        if stack == "ours":
            ours = ("|bf16" if args.ours_pixel_bf16 else "") + f"|{args.dtype}"
        key = ("torch2|" if stack == "torch" else "ours|") + objective + rec + ours + tag
        if key in cache:
            print(f"[{objective} seed {seed}] {stack} cached: "
                  f"{cache[key]['final_acc']:.2f}%", flush=True)
            return cache[key]
        t0 = time.time()
        if stack == "torch":
            r = torch_train_student(ref_cfg.replace(epochs=epochs), root, teacher_path,
                                    objective, seed, args.recipe, args.device)
        else:
            r = ours_train_student(root, teacher_path, objective, seed, epochs,
                                   args.workdir, args.recipe, args.ours_pixel_bf16,
                                   args.dtype, args.device, args.batch_size)
        r["seconds"] = round(time.time() - t0, 1)
        print(f"[{objective} seed {seed}] {stack} {r['final_acc']:.2f}% "
              f"({r['seconds']:.0f}s)" + (f"; launches {r['launches']} over "
                                          f"{r['steps']} train steps"
                                          if stack == "ours" else ""), flush=True)
        cache[key] = r
        with open(cache_path, "w") as f:
            json.dump(cache, f, indent=1)
        return r

    card = card_line(args.device)
    commit = _commit(args.commit)
    recipe_desc = {
        "base": "RRC(bicubic) + flip + jitter 0.4 + erasing 0.25 (RandAugment off)",
        "ra": "RRC(bicubic) + flip + RandAugment rand-m9-mstd0.5-inc1 (the reference's "
              "default --aa; jitter off per timm) + erasing 0.25; the torch side runs a "
              "timm-semantic PIL RandAugment (HostRandAugment), ours the on-device "
              "composed-warp RA",
        "3aug": "--ThreeAugment --src: resize + reflect-pad RandomCrop + flip + "
                "RandomChoice{gray, solarize, blur} + jitter 0.4, no erasing (reference "
                "tools/augment.py)",
    }[args.recipe]
    route = (f"the fused block kernels' {'fp32' if args.dtype == 'float32' else 'bf16'} "
             "forms (rows 1, 2" + (", and 10, 11 for wasskd" if "wasskd" in objectives
                                   and args.dtype == "bfloat16" else "") + ")")

    def _verdicts(results, done):
        out = {}
        for objective in done:
            out[objective] = band_verdict(
                [results[(objective, s)]["torch"]["final_acc"] for s in args.seeds],
                [results[(objective, s)]["ours"]["final_acc"] for s in args.seeds])
        return out

    def _write_table(results, done, partial: bool):
        """Called after every completed objective, so that a long run cut
        short still leaves the objectives it finished."""
        key = table_key(args.recipe, args.dtype, args.ours_pixel_bf16)
        from deltakd_tpu_torch.models.registry import MODEL_REGISTRY

        t_cfg, s_cfg = MODEL_REGISTRY[TEACHER], MODEL_REGISTRY[STUDENT_SOFT]
        lines = [f"## {key}", "",
                 f"Card: {card}. Date: {time.strftime('%Y-%m-%d')}. Commit: {commit}. "
                 f"Ours: `run()` at {args.dtype}"
                 + (" with the bf16 pixel stage (--aug-pixel-bf16; the torch side "
                    "stays fp32)" if args.ours_pixel_bf16 else
                    " with the fp32 pixel stage (--no-aug-pixel-bf16)")
                 + f" on {route}. Torch stack: fp32, TF32 off, cuDNN deterministic, "
                 f"on the same device.", "",
                 f"Dataset: {NUM_CLASSES}-class procedural textures, {n_train}/{n_val} "
                 f"imgs/class train/val at {IMG_SRC}px, input {INPUT}px (N = "
                 f"{s_cfg.num_patches + 2} tokens). Teacher: D = {t_cfg.embed_dim}, "
                 f"{t_cfg.num_heads} heads, depth {t_cfg.depth}, distilled, "
                 f"torch-pretrained for {teacher_epochs} epochs (shared through "
                 f"--teacher-checkpoint). Student: D = {s_cfg.embed_dim}, "
                 f"{s_cfg.num_heads} heads, depth {s_cfg.depth}. {epochs} epochs, "
                 f"recipe: {recipe_desc} + mixup 0.8/cutmix 1.0 + smoothing 0.1, AdamW "
                 f"lr 5e-4 cosine, batch {args.batch_size}.", ""]
        if teacher_acc is not None:
            lines += [f"Teacher val top-1: {teacher_acc:.2f}% (fingerprint {tfp}).", ""]
        lines += ["| objective | seed | torch final | ours final | torch best | ours best |",
                  "|---|---|---|---|---|---|"]
        verdicts = _verdicts(results, done)
        for objective in done:
            for s in args.seeds:
                r = results[(objective, s)]
                lines.append(
                    f"| {objective} | {s} | {r['torch']['final_acc']:.2f} "
                    f"| {r['ours']['final_acc']:.2f} | {r['torch']['best_acc']:.2f} "
                    f"| {r['ours']['best_acc']:.2f} |")
            delta, band, verdict = verdicts[objective]
            t_mean = np.mean([results[(objective, s)]["torch"]["final_acc"]
                              for s in args.seeds])
            o_mean = np.mean([results[(objective, s)]["ours"]["final_acc"]
                              for s in args.seeds])
            lines.append(f"| {objective} | mean | {t_mean:.2f} | {o_mean:.2f} "
                         f"| Δ={delta:.2f} | {verdict} band {band:.2f} |")
        lines += ["", f"Seeds: {args.seeds}. Recipe: --recipe {args.recipe}, ours "
                      f"--dtype {args.dtype}"
                      + (" --ours-pixel-bf16" if args.ours_pixel_bf16 else "") + "."]
        if partial:
            pending = [o for o in objectives if o not in done]
            lines.append(f"PARTIAL: objectives still running: {pending}.")
        put_section(args.out, key, lines)
        if not partial:
            print("\n".join(lines), flush=True)
        return verdicts

    results = {}
    for i, objective in enumerate(objectives):
        for seed in args.seeds:
            results[(objective, seed)] = {"torch": _one("torch", objective, seed),
                                          "ours": _one("ours", objective, seed)}
        done = objectives[:i + 1]
        if len(done) < len(objectives):
            _write_table(results, done, partial=True)

    verdicts = _write_table(results, objectives, partial=False)
    for objective, (delta, band, verdict) in verdicts.items():
        print(f"[verdict] {objective}: torch mean "
              f"{np.mean([results[(objective, s)]['torch']['final_acc'] for s in args.seeds]):.2f}"
              f", ours mean "
              f"{np.mean([results[(objective, s)]['ours']['final_acc'] for s in args.seeds]):.2f}"
              f", delta {delta:.2f}, {verdict} band {band:.2f}", flush=True)
    print(f"\nwritten: {args.out}")
    return {"results": results, "verdicts": verdicts, "teacher_acc": teacher_acc,
            "ok": all(v[2] == "WITHIN" for v in verdicts.values())}


def main(argv=None) -> int:
    out = compare(argv)
    if "verdicts" in out:
        print(json.dumps({"equivalent": out["ok"]}))
    return 0 if out.get("ok", True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
