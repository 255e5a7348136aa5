"""Mixup / CutMix as an on-device batch transform (``deltakd_tpu/data/mixup.py``,
timm ``Mixup``): with probability ``prob`` an image is mixed with its partner
in the flipped batch; when both are enabled a coin with ``switch_prob`` picks
cutmix; lambda ~ Beta(alpha, alpha); targets become smoothed one-hot mixed with
the same lambda (cutmix corrects it by the clipped box area). Mode 'batch'
draws one decision for the whole batch, 'elem' one per image, and 'pair' one
per image with partners (i, B-1-i) sharing the first one's.

``draw_mixup`` takes a ``torch.Generator`` and returns the draws, all on the
device (no host sync); ``mix_batch`` applies them. Over several data ranks
(``dp``: under tensor parallelism the data axis, whose rank and group pick
the partner and carry the exchange) each rank mixes its rows of the global
batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from deltakd_tpu_torch.parallel.mesh import LOCAL, DataParallel

MODES = ("batch", "pair", "elem")


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    prob: float = 1.0
    switch_prob: float = 0.5
    label_smoothing: float = 0.1
    num_classes: int = 1000
    mode: str = "batch"

    @classmethod
    def from_config(cls, cfg, num_classes: int) -> Optional["MixupConfig"]:
        if not cfg.mixup_active:
            return None
        return cls(mixup_alpha=cfg.mixup, cutmix_alpha=cfg.cutmix,
                   prob=cfg.mixup_prob, switch_prob=cfg.mixup_switch_prob,
                   label_smoothing=cfg.smoothing, num_classes=num_classes,
                   mode=cfg.mixup_mode)


@dataclasses.dataclass
class MixupDraws:
    """0-d in 'batch' mode, [B] (one per image of the global batch, before
    pairing) otherwise."""

    do_mix: torch.Tensor       # bool
    use_cutmix: torch.Tensor   # bool
    lam_mix: torch.Tensor      # float
    lam_cut: torch.Tensor      # float
    cy: torch.Tensor           # float, box centre row
    cx: torch.Tensor           # float, box centre column


def one_hot_smoothed(labels, num_classes: int, smoothing: float):
    on = 1.0 - smoothing + smoothing / num_classes
    off = smoothing / num_classes
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.long()[:, None] == classes).float() * (on - off) + off


def _gamma(generator, alpha: float, device, shape=(), tries: int = 32):
    """Gamma(alpha, 1) samples of ``shape`` on the device: Marsaglia-Tsang,
    with ``tries`` proposals drawn at once and the first accepted one kept
    (each is accepted with probability > 0.95), boosted for alpha < 1."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    x = torch.randn((tries,) + tuple(shape), generator=generator, device=device)
    u = torch.rand((tries,) + tuple(shape), generator=generator, device=device)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp(min=1e-30)))
    first = torch.argmax(ok.int(), dim=0, keepdim=True)
    g = (d * v).gather(0, first)[0]
    if alpha < 1.0:
        g = g * torch.rand(shape, generator=generator, device=device) ** (1.0 / alpha)
    return g


def _beta(generator, alpha: float, device, shape=()):
    x = _gamma(generator, alpha, device, shape)
    y = _gamma(generator, alpha, device, shape)
    return x / (x + y)


def draw_mixup(generator, mc: MixupConfig, b: int, h: int, w: int, device=None
               ) -> MixupDraws:
    if mc.mode not in MODES:
        raise ValueError(f"mixup mode {mc.mode!r} is not one of {MODES}")
    shape = () if mc.mode == "batch" else (b,)
    one = torch.ones(shape, device=device)
    do_mix = torch.rand(shape, generator=generator, device=device) < mc.prob
    if mc.cutmix_alpha > 0 and mc.mixup_alpha > 0:
        use_cutmix = torch.rand(shape, generator=generator, device=device) < mc.switch_prob
    else:
        use_cutmix = torch.full(shape, mc.mixup_alpha <= 0, device=device)
    lam_mix = _beta(generator, mc.mixup_alpha, device, shape) if mc.mixup_alpha > 0 else one
    lam_cut = _beta(generator, mc.cutmix_alpha, device, shape) if mc.cutmix_alpha > 0 else one
    cy = torch.randint(0, h, shape, generator=generator, device=device).float()
    cx = torch.randint(0, w, shape, generator=generator, device=device).float()
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


def _paired(d: MixupDraws) -> MixupDraws:
    """Images i >= B // 2 take the draws of their partner B-1-i."""
    def mirror(v):
        first = torch.arange(v.shape[0], device=v.device) < v.shape[0] // 2
        return torch.where(first, v, v.flip(0))
    return MixupDraws(*(mirror(v) for v in dataclasses.astuple(d)))


def mix_batch(images, labels, mc: MixupConfig, d: MixupDraws, dp: DataParallel = LOCAL
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,H,W,C] images + int labels -> (mixed images, soft targets [B,C]).
    ``images`` and ``labels`` are this rank's rows of the global batch and
    ``d`` the draws for the global batch."""
    B, H, W, _ = images.shape
    per_image = d.lam_mix.dim() == 1
    if per_image:
        if mc.mode == "pair":
            d = _paired(d)
        rows = slice(dp.rank * B, (dp.rank + 1) * B)
        d = MixupDraws(*(v[rows] for v in dataclasses.astuple(d)))
    e4 = (lambda v: v[:, None, None, None]) if per_image else (lambda v: v)  # noqa: E731
    # the partner rank's batch, flipped: row j's partner in the global batch
    flipped = dp.swap_with_partner(images).flip(0)
    flipped_labels = dp.swap_with_partner(labels).flip(0)
    lam_b = e4(d.lam_mix).to(images.dtype)     # keep a bf16 pixel stage bf16
    mixed_m = lam_b * images + (1.0 - lam_b) * flipped
    y0, y1, x0, x1, lam_cut_c = _bbox(H, W, d.lam_cut, d.cy, d.cx)
    yy = torch.arange(H, dtype=torch.float32, device=images.device)[:, None, None]
    xx = torch.arange(W, dtype=torch.float32, device=images.device)[None, :, None]
    sq = (lambda v: v[:, None, None, None]) if per_image else (lambda v: v)  # noqa: E731
    box = (yy >= sq(y0)) & (yy < sq(y1)) & (xx >= sq(x0)) & (xx < sq(x1))
    mixed_c = torch.where(box, flipped, images)
    mixed = torch.where(e4(d.use_cutmix), mixed_c, mixed_m)
    lam = torch.where(d.use_cutmix, lam_cut_c, d.lam_mix)
    images_out = torch.where(e4(d.do_mix), mixed, images)
    lam = torch.where(d.do_mix, lam, torch.ones_like(lam))
    targets = one_hot_smoothed(labels, mc.num_classes, mc.label_smoothing)
    partner = one_hot_smoothed(flipped_labels, mc.num_classes, mc.label_smoothing)
    lam_t = lam[:, None] if per_image else lam
    return images_out, lam_t * targets + (1.0 - lam_t) * partner


def apply_mixup(generator, images, labels, mc: MixupConfig, dp: DataParallel = LOCAL):
    """Mixup of this rank's rows of the global batch; ``generator`` must be
    equal on every rank."""
    B, H, W = images.shape[:3]
    d = draw_mixup(generator, mc, B * dp.world, H, W, images.device)
    return mix_batch(images, labels, mc, d, dp)
