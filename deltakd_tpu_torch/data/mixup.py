"""Mixup / CutMix as an on-device batch transform (``deltakd_tpu/data/mixup.py``,
timm ``Mixup`` in 'batch' mode): with probability ``prob`` the batch is mixed
with its flip; when both are enabled a coin with ``switch_prob`` picks cutmix;
one lambda ~ Beta(alpha, alpha) per batch; targets become smoothed one-hot
mixed with the same lambda (cutmix corrects it by the clipped box area).

``draw_mixup`` takes a ``torch.Generator`` and returns the draws, all on the
device (no host sync); ``mix_batch`` applies them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    num_classes: int = 1000

    @classmethod
    def from_config(cls, cfg, num_classes: int) -> Optional["MixupConfig"]:
        if not cfg.mixup_active:
            return None
        return cls(mixup_alpha=cfg.mixup, cutmix_alpha=cfg.cutmix,
                   prob=cfg.mixup_prob, switch_prob=cfg.mixup_switch_prob,
                   label_smoothing=cfg.smoothing, num_classes=num_classes)


@dataclasses.dataclass
class MixupDraws:
    do_mix: torch.Tensor       # 0-d bool
    use_cutmix: torch.Tensor   # 0-d bool
    lam_mix: torch.Tensor      # 0-d float
    lam_cut: torch.Tensor      # 0-d float
    cy: torch.Tensor           # 0-d float, box centre row
    cx: torch.Tensor           # 0-d float, box centre column


def one_hot_smoothed(labels, num_classes: int, smoothing: float):
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    return torch.nn.functional.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _gamma(generator, alpha: float, device, tries: int = 32):
    """One Gamma(alpha, 1) sample on the device: Marsaglia-Tsang, with
    ``tries`` proposals drawn at once and the first accepted one kept (each
    is accepted with probability > 0.95), boosted for alpha < 1."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn(tries, generator=generator, device=device)
    u = torch.rand(tries, generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp(min=1e-30)))
    g = (d * v)[torch.argmax(ok.int())]
    if alpha < 1.0:
        g = g * torch.rand((), generator=generator, device=device) ** (1.0 / alpha)
    return g


def _beta(generator, alpha: float, device):
    x = _gamma(generator, alpha, device)
    y = _gamma(generator, alpha, device)
    return x / (x + y)


def draw_mixup(generator, mc: MixupConfig, h: int, w: int, device=None) -> MixupDraws:
    one = torch.ones((), device=device)
    do_mix = torch.rand((), generator=generator, device=device) < mc.prob
    if mc.cutmix_alpha > 0 and mc.mixup_alpha > 0:
        use_cutmix = torch.rand((), generator=generator, device=device) < mc.switch_prob
    else:
        use_cutmix = torch.tensor(mc.mixup_alpha <= 0, device=device)
    lam_mix = _beta(generator, mc.mixup_alpha, device) if mc.mixup_alpha > 0 else one
    lam_cut = _beta(generator, mc.cutmix_alpha, device) if mc.cutmix_alpha > 0 else one
    cy = torch.randint(0, h, (), generator=generator, device=device).float()
    cx = torch.randint(0, w, (), generator=generator, device=device).float()
    return MixupDraws(do_mix, use_cutmix, lam_mix, lam_cut, cy, cx)


def _bbox(h: int, w: int, lam, cy, cx):
    """timm rand_bbox from the drawn centre: (y0, y1, x0, x1, corrected lam)."""
    ratio = torch.sqrt(1.0 - lam)
    cut_h = torch.floor(h * ratio)
    cut_w = torch.floor(w * ratio)
    y0 = (cy - torch.floor(cut_h / 2)).clamp(0, h)
    y1 = (cy + torch.floor(cut_h / 2)).clamp(0, h)
    x0 = (cx - torch.floor(cut_w / 2)).clamp(0, w)
    x1 = (cx + torch.floor(cut_w / 2)).clamp(0, w)
    return y0, y1, x0, x1, 1.0 - (y1 - y0) * (x1 - x0) / float(h * w)


def mix_batch(images, labels, mc: MixupConfig, d: MixupDraws
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,H,W,C] images + int labels -> (mixed images, soft targets [B,C])."""
    B, H, W, _ = images.shape
    flipped = images.flip(0)
    lam_b = d.lam_mix.to(images.dtype)     # keep a bf16 pixel stage bf16
    mixed_m = lam_b * images + (1.0 - lam_b) * flipped
    y0, y1, x0, x1, lam_cut_c = _bbox(H, W, d.lam_cut, d.cy, d.cx)
    yy = torch.arange(H, dtype=torch.float32, device=images.device)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=images.device)[None, :]
    box = ((yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1))[None, :, :, None]
    mixed_c = torch.where(box, flipped, images)
    mixed = torch.where(d.use_cutmix, mixed_c, mixed_m)
    lam = torch.where(d.use_cutmix, lam_cut_c, d.lam_mix)
    images_out = torch.where(d.do_mix, mixed, images)
    lam = torch.where(d.do_mix, lam, torch.ones_like(lam))
    targets = one_hot_smoothed(labels, mc.num_classes, mc.label_smoothing)
    return images_out, lam * targets + (1.0 - lam) * targets.flip(0)


def apply_mixup(generator, images, labels, mc: MixupConfig):
    H, W = images.shape[1:3]
    return mix_batch(images, labels, mc, draw_mixup(generator, mc, H, W, images.device))
