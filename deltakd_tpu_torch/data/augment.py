"""On-device data augmentation, the main-path subset of
``deltakd_tpu/data/augment.py``: RandomResizedCrop (or RandomCrop with
4-pixel zero padding for inputs of 32 px or less), horizontal flip, PIL-style
bicubic or bilinear resampling as two dense interpolation matmuls, the integer
rounding after the geometric stage, the optional bf16 pixel stage,
normalisation and random erasing; plus the eval transform.

Every random function is split in two: ``draw_*`` takes a ``torch.Generator``
and returns the drawn values, and the deterministic half takes those values,
so tests can feed both packages the same draws. Images flow as float32 in
[0, 255] until the final normalisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Static description of the train-time pipeline (from TrainConfig)."""

    input_size: int = 224
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    reprob: float = 0.25
    interpolation: str = "bicubic"     # crop/resize kernel: bicubic|bilinear|random
    remode: str = "pixel"              # RandomErasing fill: pixel|const|rand
    recount: int = 1                   # RandomErasing max_count
    small_input_crop: bool = False     # <=32 px: RandomCrop(pad=4)
    eval_crop_ratio: float = 0.875
    pixel_bf16: bool = False           # post-resample pixel stage in bf16

    @classmethod
    def from_config(cls, cfg) -> "AugmentConfig":
        from deltakd_tpu_torch.data.registry import DATASET_STATS

        stats = DATASET_STATS[cfg.dataset]
        return cls(input_size=cfg.input_size, mean=tuple(stats["mean"]),
                   std=tuple(stats["std"]), reprob=cfg.reprob,
                   interpolation=cfg.interpolation, remode=cfg.remode,
                   recount=cfg.recount, small_input_crop=cfg.input_size <= 32,
                   eval_crop_ratio=cfg.eval_crop_ratio,
                   pixel_bf16=cfg.aug_pixel_bf16)


# -----------------------------------------------------------------------------
# Affine machinery ([..., 2, 3] output-pixel -> source-pixel maps)
# -----------------------------------------------------------------------------

def _to3(m):
    pad = torch.tensor([0.0, 0.0, 1.0], dtype=m.dtype, device=m.device)
    return torch.cat([m, pad.expand(m.shape[:-2] + (1, 3))], dim=-2)


def compose(outer, inner):
    """result(p) = outer(inner(p))."""
    return (_to3(outer) @ _to3(inner))[..., :2, :]


def crop_matrix(top, left, crop_h, crop_w, out_h: int, out_w: int):
    """Output pixel -> source pixel map for crop-and-resize ([B] tensors)."""
    sy = crop_h / out_h
    sx = crop_w / out_w
    z = torch.zeros_like(sy)
    row0 = torch.stack([sy, z, top + 0.5 * sy - 0.5], dim=-1)
    row1 = torch.stack([z, sx, left + 0.5 * sx - 0.5], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def hflip_matrix(out_w: int, device=None):
    return torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, float(out_w - 1)]],
                        device=device)


def _interp_matrix(coord, in_size: int):
    """[B, out] source coords -> [B, out, in] bilinear row weights."""
    c = coord.clamp(0.0, in_size - 1.0)
    grid = torch.arange(in_size, dtype=torch.float32, device=coord.device)
    return torch.clamp(1.0 - (c[..., None] - grid).abs(), min=0.0)


def _cubic_weights(d):
    """PIL bicubic kernel (a = -0.5)."""
    a = -0.5
    x = d.abs()
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return torch.where(x <= 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def _interp_matrix_cubic(coord, in_size: int, scale=None):
    """[B, out] source coords -> [B, out, in] PIL-bicubic row weights, with
    PIL's antialias stretch max(scale, 1) on downscale and out-of-image taps
    dropped with the row renormalised."""
    grid = torch.arange(in_size, dtype=torch.float32, device=coord.device)
    ss = torch.clamp(scale, min=1.0)[..., None, None] if scale is not None else 1.0
    w = _cubic_weights((grid - coord[..., None]) / ss)
    rowsum = w.sum(-1, keepdim=True)
    nearest = torch.nn.functional.one_hot(
        coord.round().clamp(0, in_size - 1).long(), in_size).float()
    return torch.where(rowsum > 1e-6, w / rowsum.clamp(min=1e-6), nearest)


def _row_weights(coord, in_size, scale, method, pick):
    if method == "bilinear":
        return _interp_matrix(coord, in_size)
    wc = _interp_matrix_cubic(coord, in_size, scale)
    if method == "bicubic":
        return wc
    if method != "random":
        raise NotImplementedError(f"interpolation '{method}' not implemented "
                                  f"(bilinear, bicubic, random are)")
    if pick is None:
        raise ValueError("interpolation 'random' needs a per-sample pick")
    return torch.where(pick[:, None, None], wc, _interp_matrix(coord, in_size))


def resample_separable(imgs, mats, out_h: int, out_w: int, fill=None,
                       method: str = "bilinear", pick=None):
    """Axis-aligned batched warp as two matmuls: [B,H,W,C] x [B,2,3] ->
    [B,out_h,out_w,C]. ``mats`` must have zero off-diagonal linear terms.
    Bicubic runs the horizontal pass first and rounds it to clipped integers
    before the vertical pass, like PIL's 8-bit resample."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    sy = mats[:, 0, 0:1] * ys[None, :] + mats[:, 0, 2:3]
    sx = mats[:, 1, 1:2] * xs[None, :] + mats[:, 1, 2:3]
    ry = _row_weights(sy, H, mats[:, 0, 0], method, pick)
    rx = _row_weights(sx, W, mats[:, 1, 1], method, pick)
    if method == "bilinear":
        t = torch.einsum("boh,bhwc->bowc", ry, imgs)
        out = torch.einsum("bpw,bowc->bopc", rx, t)
    else:
        t = torch.einsum("bpw,bhwc->bhpc", rx, imgs)
        t = torch.round(t.clamp(0.0, 255.0))
        out = torch.einsum("boh,bhpc->bopc", ry, t)
    if fill is not None:
        oob_y = (sy < -0.5) | (sy > H - 0.5)
        oob_x = (sx < -0.5) | (sx > W - 0.5)
        oob = oob_y[:, :, None] | oob_x[:, None, :]
        out = torch.where(oob[..., None], fill, out)
    return out


# -----------------------------------------------------------------------------
# RandomResizedCrop
# -----------------------------------------------------------------------------

_N_TRY = 10


def draw_rrc(generator, batch: int, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
             device=None):
    """Per sample and try: area fraction, log aspect, and two uniforms for the
    offsets, each [batch, 10]."""
    def u(lo=0.0, hi=1.0):
        return torch.rand(batch, _N_TRY, generator=generator, device=device) * (hi - lo) + lo

    return (u(*scale), u(math.log(ratio[0]), math.log(ratio[1])), u(), u())


def rrc_from_draws(area_frac, log_ratio, u_top, u_left, h: int, w: int,
                   ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop: the first of 10 tries that fits, else a
    center crop at clamped aspect. Returns (top, left, crop_h, crop_w) [B]."""
    aspect = torch.exp(log_ratio)
    target = h * w * area_frac
    cw = torch.round(torch.sqrt(target * aspect))
    ch = torch.round(torch.sqrt(target / aspect))
    ok = (cw <= w) & (ch <= h)
    top = torch.floor(u_top * (h - ch + 1))
    left = torch.floor(u_left * (w - cw + 1))
    idx = torch.argmax(ok.int(), dim=-1, keepdim=True)   # first success
    any_ok = ok.any(-1)

    in_ratio = w / h
    if in_ratio < ratio[0]:
        fb_w, fb_h = w, round(w / ratio[0])
    elif in_ratio > ratio[1]:
        fb_w, fb_h = round(h * ratio[1]), h
    else:
        fb_w, fb_h = w, h
    fb = (float((h - fb_h) // 2), float((w - fb_w) // 2), float(fb_h), float(fb_w))
    picked = (top, left, ch, cw)
    return tuple(torch.where(any_ok, v.gather(-1, idx)[:, 0], f)
                 for v, f in zip(picked, fb))


def random_resized_crop_params(generator, batch: int, h: int, w: int,
                               scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), device=None):
    return rrc_from_draws(*draw_rrc(generator, batch, scale, ratio, device),
                          h, w, ratio)


# -----------------------------------------------------------------------------
# Random erasing
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class ErasingDraws:
    do: torch.Tensor          # [B] bool
    count: torch.Tensor       # [B] erase count in [1, max_count]
    area_frac: torch.Tensor   # [B, K]
    log_ratio: torch.Tensor   # [B, K]
    u_top: torch.Tensor       # [B, K]
    u_left: torch.Tensor      # [B, K]
    noise: Optional[torch.Tensor]  # pixel: [B,H,W,C]; rand: [B,K,C]; const: None


def draw_random_erasing(generator, shape, prob: float, scale=(0.02, 1 / 3),
                        ratio=(0.3, 10 / 3), mode: str = "pixel",
                        max_count: int = 1, device=None) -> ErasingDraws:
    B, H, W, C = shape
    K = max(1, int(max_count))

    def u(lo=0.0, hi=1.0):
        return torch.rand(B, K, generator=generator, device=device) * (hi - lo) + lo

    count = (torch.randint(1, K + 1, (B,), generator=generator, device=device)
             if K > 1 else torch.ones(B, dtype=torch.long, device=device))
    area_frac = u(*scale)
    log_ratio = u(math.log(ratio[0]), math.log(ratio[1]))
    u_top, u_left = u(), u()
    if mode == "pixel":
        noise = torch.randn(B, H, W, C, generator=generator, device=device)
    elif mode == "rand":
        noise = torch.randn(B, K, C, generator=generator, device=device)
    elif mode == "const":
        noise = None
    else:
        raise ValueError(f"unknown erasing mode '{mode}' "
                         f"('pixel', 'const', 'rand' are implemented)")
    do = torch.rand(B, generator=generator, device=device) < prob
    return ErasingDraws(do, count, area_frac, log_ratio, u_top, u_left, noise)


def apply_random_erasing(imgs, d: ErasingDraws, mode: str = "pixel"):
    """timm RandomErasing on the normalised batch: up to K boxes per image
    (area budget split by the drawn count), filled with per-pixel noise
    (pixel), zeros (const) or one colour per box, later boxes winning (rand)."""
    B, H, W, C = imgs.shape
    K = d.area_frac.shape[1]
    dev = imgs.device
    target = H * W * d.area_frac / d.count[:, None].float()
    aspect = torch.exp(d.log_ratio)
    eh = torch.round(torch.sqrt(target * aspect)).clamp(1, H)
    ew = torch.round(torch.sqrt(target / aspect)).clamp(1, W)
    top = torch.floor(d.u_top * (H - eh + 1))
    left = torch.floor(d.u_left * (W - ew + 1))
    active = torch.arange(K, device=dev)[None, :] < d.count[:, None]
    yy = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None, :]
    e4 = lambda v: v[:, :, None, None]  # noqa: E731
    boxes = ((yy >= e4(top)) & (yy < e4(top + eh)) & (xx >= e4(left))
             & (xx < e4(left + ew)) & e4(active))
    box = boxes.any(1)
    if mode == "const":
        fill = torch.zeros_like(imgs)
    elif mode == "rand":
        fill = torch.zeros_like(imgs)
        for k in range(K):  # sequential: later boxes overwrite overlaps
            fill = torch.where(boxes[:, k, :, :, None],
                               d.noise[:, k][:, None, None, :].to(imgs.dtype), fill)
    elif mode == "pixel":
        fill = d.noise.to(imgs.dtype)
    else:
        raise ValueError(f"unknown erasing mode '{mode}'")
    return torch.where((d.do[:, None, None] & box)[..., None], fill, imgs)


def random_erasing_batch(generator, imgs, prob: float, mode: str = "pixel",
                         max_count: int = 1):
    d = draw_random_erasing(generator, imgs.shape, prob, mode=mode,
                            max_count=max_count, device=imgs.device)
    return apply_random_erasing(imgs, d, mode)


# -----------------------------------------------------------------------------
# Full train/eval transforms
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class TrainDraws:
    top: torch.Tensor         # [B] crop box in source pixels
    left: torch.Tensor
    crop_h: torch.Tensor
    crop_w: torch.Tensor
    flip: torch.Tensor        # [B] bool
    interp_pick: Optional[torch.Tensor]   # [B] bool (interpolation 'random')
    erase: Optional[ErasingDraws]


def draw_train_transform(generator, shape, ac: AugmentConfig, device=None) -> TrainDraws:
    B, H, W, C = shape
    S = ac.input_size
    if ac.small_input_crop:
        # RandomCrop(S, padding=4); a larger source is first scaled to S
        scale = min(H, W) / S
        top, left = ((torch.randint(0, 9, (B,), generator=generator, device=device)
                      .float() - 4.0) * scale for _ in range(2))
        ch = cw = torch.full((B,), S * scale, device=device)
    else:
        top, left, ch, cw = random_resized_crop_params(generator, B, H, W,
                                                       device=device)
    flip = torch.rand(B, generator=generator, device=device) < 0.5
    pick = (torch.rand(B, generator=generator, device=device) < 0.5
            if ac.interpolation == "random" else None)
    erase = (draw_random_erasing(generator, (B, S, S, C), ac.reprob, mode=ac.remode,
                                 max_count=ac.recount, device=device)
             if ac.reprob > 0 else None)
    return TrainDraws(top, left, ch, cw, flip, pick, erase)


def _normalize(img, ac: AugmentConfig):
    mean = (torch.tensor(ac.mean, device=img.device) * 255.0).to(img.dtype)
    inv_std = (1.0 / (torch.tensor(ac.std, device=img.device) * 255.0)).to(img.dtype)
    return (img - mean) * inv_std


def apply_train_transform(images_u8, ac: AugmentConfig, d: TrainDraws):
    """[B, H, W, 3] uint8 -> [B, S, S, 3] normalised (float32, or bf16 with
    ``pixel_bf16``), from the given draws."""
    B = images_u8.shape[0]
    S = ac.input_size
    dev = images_u8.device
    mats = crop_matrix(d.top, d.left, d.crop_h, d.crop_w, S, S)
    flipped = compose(mats, hflip_matrix(S, dev).expand(B, 2, 3))
    mats = torch.where(d.flip[:, None, None], flipped, mats)
    crop_fill = torch.zeros(3, device=dev) if ac.small_input_crop else None
    imgs = resample_separable(images_u8.float(), mats, S, S, fill=crop_fill,
                              method=ac.interpolation, pick=d.interp_pick)
    # integer pixels, like PIL's uint8 output (and exact in bf16)
    imgs = torch.round(imgs.clamp(0.0, 255.0))
    if ac.pixel_bf16:
        imgs = imgs.to(torch.bfloat16)
    imgs = _normalize(imgs, ac)
    if d.erase is not None:
        imgs = apply_random_erasing(imgs, d.erase, ac.remode)
    return imgs


def train_transform(generator, images_u8, ac: AugmentConfig):
    d = draw_train_transform(generator, images_u8.shape, ac, device=images_u8.device)
    return apply_train_transform(images_u8, ac, d)


def eval_transform(images_u8, ac: AugmentConfig):
    """Resize(S/crop_ratio) + CenterCrop(S) + normalise; inputs of 32 px or
    less that already are S x S skip the resize."""
    B, H, W, _ = images_u8.shape
    S = ac.input_size
    img = images_u8.float()
    if S > 32 or (H, W) != (S, S):
        resize_to = int(S / ac.eval_crop_ratio) if S > 32 else S
        scale = min(H, W) / resize_to
        new_h, new_w = round(H / scale), round(W / scale)
        full = lambda v: torch.full((B,), float(v), device=img.device)  # noqa: E731
        mat = crop_matrix(full((new_h - S) / 2.0 * scale), full((new_w - S) / 2.0 * scale),
                          full(S * scale), full(S * scale), S, S)
        img = resample_separable(img, mat, S, S, method="bicubic").clamp(0.0, 255.0)
    return _normalize(img, ac)
