"""On-device data augmentation, the port of ``deltakd_tpu/data/augment.py``:
RandomResizedCrop (or RandomCrop with 4-pixel padding for inputs of 32 px or
less, and with reflect padding for ``--src``), horizontal flip, PIL-style
bicubic or bilinear resampling as two dense interpolation matmuls,
RandAugment (timm ``rand-*-inc1``) and AutoAugment (timm ``original``) with
their geometric ops composed into one oblique warp, 3-Augment, colour jitter,
the integer rounding after the geometric stage, the optional bf16 pixel
stage, normalisation and random erasing; plus the eval transform.

Every random function is split in two: ``draw_*`` takes a ``torch.Generator``
and returns the drawn values, and the deterministic half takes those values,
so tests can feed both packages the same draws. Images flow as float32 in
[0, 255] until the final normalisation.

The transform never waits for the card: a batch-wide choice (whether any
image drew a geometric op, colour jitter's order) is a device flag that
selects its result with ``torch.where``, never a Python branch on a tensor,
and small constants reach the card by asynchronous copies. Equalize counts
its histogram in integers (``scatter_add_``) and applies its LUT by
indexing, where the JAX package uses one-hot matmuls for the TPU's MXU; both
give the same integers.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

_GRAY = (0.299, 0.587, 0.114)


def _const(values, device, dtype=torch.float32):
    """A small constant tensor on ``device``. The copy to a card is
    asynchronous (a synchronising copy would make the host wait)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


def _div(x, c: float):
    """x / c rounded once. On a card, a tensor divided by a Python number is
    multiplied by the number's rounded reciprocal instead, which can move the
    last bit, and a floor, a rounding or a threshold after it would then
    part from the CPU and from JAX."""
    return x / torch.full_like(x, c)


def _exp(x):
    """exp(x) in x's dtype, through fp64: the card's and the CPU's fp32 exp
    differ in the last bit, and a crop or erasing box is rounded from it."""
    return torch.exp(x.double()).to(x.dtype)


def _mean_hw(x):
    """Mean over the two image axes as a sum and one division, as jnp.mean."""
    n = x.shape[-2] * x.shape[-1]
    return _div(x.sum(dim=(-2, -1)), float(n))


@dataclasses.dataclass(frozen=True)
class RandAugmentConfig:
    magnitude: float = 9.0
    mstd: float = 0.5
    num_layers: int = 2
    prob: float = 0.5

    @classmethod
    def parse(cls, spec: str) -> Optional["RandAugmentConfig"]:
        """Parse timm policy strings like 'rand-m9-mstd0.5-inc1'. Strict: the
        ops implement timm's increasing (``inc1``) magnitude maps only, so a
        spec without ``inc1``, an ``inc0``, a ``w#`` weight preset or any
        other unknown token raises ``NotImplementedError``, as in the JAX
        package."""
        if not spec:
            return None
        if not spec.startswith("rand"):
            raise NotImplementedError(
                f"--aa '{spec}' is not implemented (timm RandAugment 'rand-*' "
                f"policies are; use e.g. 'rand-m9-mstd0.5-inc1' or '' to disable)")
        kw = {}
        increasing = False
        for tok in spec.split("-")[1:]:
            if tok.startswith("mstd"):
                kw["mstd"] = float(tok[4:])
            elif tok.startswith("inc"):
                if tok != "inc1":
                    raise NotImplementedError(
                        f"--aa token '{tok}': only the increasing-severity op set "
                        f"(inc1) is implemented")
                increasing = True
            elif tok.startswith("m") and tok[1:2].isdigit():
                kw["magnitude"] = float(tok[1:])
            elif tok.startswith("n") and tok[1:2].isdigit():
                kw["num_layers"] = int(tok[1:])
            elif tok.startswith("p") and tok[1:2].isdigit():
                kw["prob"] = float(tok[1:])
            else:
                raise NotImplementedError(
                    f"--aa token '{tok}' in '{spec}' is not implemented "
                    f"(m#/n#/p#/mstd#/inc1 are)")
        if not increasing:
            raise NotImplementedError(
                f"--aa '{spec}' selects timm's non-increasing magnitude maps (no "
                f"'inc1' token); only the increasing maps are implemented — "
                f"append '-inc1'")
        return cls(**kw)


# The AutoAugment-paper ImageNet policy (timm auto_augment.py
# auto_augment_policy_original): 25 sub-policies of two (op, prob, level)
# slots. Per image one sub-policy is drawn and its two slots applied in turn,
# each with its probability. The ops use timm's non-increasing maps:
#   PosterizeOriginal  bits   = int(level/10*4) + 4
#   Solarize           thresh = int(level/10*256)
#   Color/Contrast/Sharpness  factor = level/10*1.8 + 0.1 (no random sign)
#   Rotate/ShearX      RandAugment's builders, random sign included.
_AA_POLICY_ORIGINAL = (
    (("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
    (("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, 4), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, 7)),
    (("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, 2)),
    (("Equalize", 0.0, 7), ("Equalize", 0.8, 8)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("Invert", 0.6, 8)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, 9)),
    (("Color", 0.4, 0), ("Equalize", 0.6, 3)),
    (("Equalize", 0.4, 7), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)),
    (("Invert", 0.6, 4), ("Equalize", 1.0, 8)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, 8), ("Equalize", 0.6, 3)),
)

# AutoAugment op names -> the RandAugment op indices (_GEO_BUILDERS, _PIXEL_OPS)
_AA_OP_INDEX = {
    "AutoContrast": 0, "Equalize": 1, "Invert": 2, "Rotate": 3,
    "PosterizeOriginal": 4, "Solarize": 5, "Color": 7, "Contrast": 8,
    "Sharpness": 10, "ShearX": 11,
}


@dataclasses.dataclass(frozen=True)
class AutoAugmentConfig:
    policy: str = "original"
    mstd: float = 0.0       # gaussian level noise (timm magnitude_std)

    @classmethod
    def parse(cls, spec: str) -> "AutoAugmentConfig":
        """'original' / 'original-mstd0.5'. Other policies ('originalr', 'v0',
        'v0r', '3a') and AugMix raise ``NotImplementedError``, as in the JAX
        package; so does any section other than 'mstd#'."""
        parts = spec.split("-")
        if parts[0] != "original":
            raise NotImplementedError(
                f"--aa '{spec}': AutoAugment policy '{parts[0]}' is not "
                f"implemented ('original' is; 'originalr'/'v0'/'v0r'/'3a'/AugMix "
                f"are not)")
        mstd = 0.0
        for tok in parts[1:]:
            if tok.startswith("mstd"):
                mstd = float(tok[4:])
            else:
                raise NotImplementedError(
                    f"--aa token '{tok}' in '{spec}': timm AutoAugment specs "
                    f"accept only 'mstd#' sections")
        return cls(policy=parts[0], mstd=mstd)

    @staticmethod
    def tables():
        """(op, prob, level) as nested lists [25][2]."""
        tab = _AA_POLICY_ORIGINAL
        return ([[_AA_OP_INDEX[s[0]] for s in sp] for sp in tab],
                [[s[1] for s in sp] for sp in tab],
                [[float(s[2]) for s in sp] for sp in tab])


def parse_aa_spec(spec: str):
    """RandAugmentConfig ('rand-*'), AutoAugmentConfig ('original*'), or None
    (empty). Anything else raises ``NotImplementedError``: the specs accepted
    and rejected are those of the JAX package's ``parse_aa_spec``."""
    if not spec:
        return None
    if spec.startswith("rand"):
        return RandAugmentConfig.parse(spec)
    if spec.startswith(("original", "v0", "3a", "augmix")):
        return AutoAugmentConfig.parse(spec)
    raise NotImplementedError(
        f"--aa '{spec}' is not a recognized timm policy string ('rand-*' "
        f"RandAugment and 'original[-mstd#]' AutoAugment are implemented; use '' "
        f"to disable)")


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Static description of the train-time pipeline (from TrainConfig)."""

    input_size: int = 224
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    rand_augment: Optional[RandAugmentConfig] = None
    auto_augment: Optional[AutoAugmentConfig] = None
    color_jitter: float = 0.0          # active only without aa, or with 3-Augment
    reprob: float = 0.25
    interpolation: str = "bicubic"     # crop/resize kernel: bicubic|bilinear|random
    remode: str = "pixel"              # RandomErasing fill: pixel|const|rand
    recount: int = 1                   # RandomErasing max_count
    three_augment: bool = False        # DeiT-III 3-Augment
    src: bool = False                  # RandomCrop(pad=4, reflect) instead of RRC
    small_input_crop: bool = False     # <=32 px: RandomCrop(pad=4)
    eval_crop_ratio: float = 0.875
    pixel_bf16: bool = False           # post-resample pixel stage in bf16
    subset_ops: bool = True            # equalize and sharpness on a batch subset

    @classmethod
    def from_config(cls, cfg) -> "AugmentConfig":
        """The JAX package's rules: 3-Augment turns RA/AA and erasing off;
        colour jitter acts only without aa or with 3-Augment; the heavy RA ops
        run on a batch subset unless the batch is split over devices
        (``_mesh_is_single_data_shard``): with ``mesh_shape`` None, over more
        than one rank; otherwise over a data axis > 1, whatever the model
        axis (its ranks hold the same rows). The subset (its size and the
        rows past it) is the local batch's, so a split batch would not give
        the global batch's transform: the ops run on every image instead, as
        in the JAX package."""
        from deltakd_tpu_torch.data.registry import DATASET_STATS
        from deltakd_tpu_torch.parallel.mesh import world

        stats = DATASET_STATS[cfg.dataset]
        aa = parse_aa_spec(cfg.aa) if not cfg.ThreeAugment else None
        ms = cfg.mesh_shape
        return cls(input_size=cfg.input_size, mean=tuple(stats["mean"]),
                   std=tuple(stats["std"]),
                   rand_augment=aa if isinstance(aa, RandAugmentConfig) else None,
                   auto_augment=aa if isinstance(aa, AutoAugmentConfig) else None,
                   color_jitter=cfg.color_jitter if (aa is None or cfg.ThreeAugment) else 0.0,
                   reprob=cfg.reprob if not cfg.ThreeAugment else 0.0,
                   interpolation=cfg.interpolation, remode=cfg.remode,
                   recount=cfg.recount, three_augment=cfg.ThreeAugment, src=cfg.src,
                   small_input_crop=cfg.input_size <= 32,
                   eval_crop_ratio=cfg.eval_crop_ratio,
                   pixel_bf16=cfg.aug_pixel_bf16,
                   subset_ops=world() == 1 if ms is None else int(ms[0]) == 1)


# -----------------------------------------------------------------------------
# Affine machinery ([..., 2, 3] output-pixel -> source-pixel maps)
# -----------------------------------------------------------------------------

def _eye23(batch: int, device):
    return _const([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device).expand(batch, 2, 3)


def _to3(m):
    pad = _const([0.0, 0.0, 1.0], m.device, m.dtype)
    return torch.cat([m, pad.expand(m.shape[:-2] + (1, 3))], dim=-2)


def compose(outer, inner):
    """result(p) = outer(inner(p))."""
    return (_to3(outer) @ _to3(inner))[..., :2, :]


def crop_matrix(top, left, crop_h, crop_w, out_h: int, out_w: int):
    """Output pixel -> source pixel map for crop-and-resize ([B] tensors)."""
    sy = _div(crop_h, float(out_h))
    sx = _div(crop_w, float(out_w))
    z = torch.zeros_like(sy)
    row0 = torch.stack([sy, z, top + 0.5 * sy - 0.5], dim=-1)
    row1 = torch.stack([z, sx, left + 0.5 * sx - 0.5], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def hflip_matrix(out_w: int, device=None):
    return _const([[1.0, 0.0, 0.0], [0.0, -1.0, float(out_w - 1)]], device)


def _invert_axis_aligned(mats):
    """Inverse of an axis-aligned [B, 2, 3] affine."""
    ay, ax = mats[:, 0, 0], mats[:, 1, 1]
    by, bx = mats[:, 0, 2], mats[:, 1, 2]
    z = torch.zeros_like(ay)
    row0 = torch.stack([1.0 / ay, z, -by / ay], dim=-1)
    row1 = torch.stack([z, 1.0 / ax, -bx / ax], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _source_coords(mats, ys, xs):
    """Source (row, col) of every output pixel: [B, len(ys), len(xs)] each.
    Products and sums one at a time, so the card and the CPU round alike."""
    def row(r):
        return (mats[:, r, 0, None, None] * ys[None, :, None]
                + mats[:, r, 1, None, None] * xs[None, None, :]
                + mats[:, r, 2, None, None])
    return row(0), row(1)


def _out_of_image(sy, sx, H: int, W: int):
    return (sy < -0.5) | (sy > H - 0.5) | (sx < -0.5) | (sx > W - 0.5)


def warp_bilinear_batch(imgs, mats, out_h: int, out_w: int, fill=None):
    """Batched affine bilinear sampling: [B,H,W,C] x [B,2,3] ->
    [B,out_h,out_w,C], one gather per corner; with ``fill``, output pixels
    whose source lies outside the image take it."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    sy, sx = _source_coords(mats, torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev))
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = (sy - y0)[..., None], (sx - x0)[..., None]
    flat = imgs.reshape(B, H * W, C)

    def gather(yi, xi):
        yc = yi.clamp(0, H - 1).long()
        xc = xi.clamp(0, W - 1).long()
        idx = (yc * W + xc).reshape(B, out_h * out_w, 1).expand(-1, -1, C)
        return torch.gather(flat, 1, idx).reshape(B, out_h, out_w, C)

    out = ((1 - wy) * ((1 - wx) * gather(y0, x0) + wx * gather(y0, x0 + 1))
           + wy * ((1 - wx) * gather(y0 + 1, x0) + wx * gather(y0 + 1, x0 + 1)))
    if fill is not None:
        out = torch.where(_out_of_image(sy, sx, H, W)[..., None], fill, out)
    return out


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
    dropped with the row renormalised; a row with no tap left takes the
    nearest edge pixel."""
    grid = torch.arange(in_size, dtype=torch.float32, device=coord.device)
    ss = torch.clamp(scale, min=1.0)[..., None, None] if scale is not None else 1.0
    w = _cubic_weights((grid - coord[..., None]) / ss)
    rowsum = w.sum(-1, keepdim=True)
    nearest = (grid == coord.round().clamp(0, in_size - 1)[..., None]).float()
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


def _reflect_coord(c, n: int):
    """Mirror out-of-image source coords back inside (F.pad 'reflect': index
    -1 -> 1, n -> n-2). Valid for excursions below n - 1."""
    c = c.abs()
    return torch.where(c > n - 1.0, 2.0 * (n - 1.0) - c, c)


def resample_separable(imgs, mats, out_h: int, out_w: int, fill=None,
                       method: str = "bilinear", pick=None, reflect: bool = False):
    """Axis-aligned batched warp as two matmuls: [B,H,W,C] x [B,2,3] ->
    [B,out_h,out_w,C]. ``mats`` must have zero off-diagonal linear terms.
    Bicubic runs the horizontal pass first and rounds it to clipped integers
    before the vertical pass, like PIL's 8-bit resample. ``reflect`` mirrors
    out-of-image coordinates back inside (RandomCrop with reflect padding, the
    ``--src`` crop) and excludes ``fill``."""
    if reflect and fill is not None:
        raise ValueError("reflect excludes fill")
    B, H, W, C = imgs.shape
    dev = imgs.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    sy = mats[:, 0, 0:1] * ys[None, :] + mats[:, 0, 2:3]
    sx = mats[:, 1, 1:2] * xs[None, :] + mats[:, 1, 2:3]
    if reflect:
        sy, sx = _reflect_coord(sy, H), _reflect_coord(sx, W)
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


# The largest source side at which the oblique warp runs at the source: its
# dense product holds [B, H*W, H, 3] fp32 (0.8 GB at 64 px and B = 256, 34 GB
# at 224 px). The JAX package's rule (H*W <= S*S alone) takes it for a 224 px
# source at S = 224 as well (its synthetic data at input sizes above 64 px),
# against its own docstring's "<=64px inputs".
DENSE_WARP_MAX_SIDE = 64


def warp_dense_matmul(imgs, mats, out_h: int, out_w: int, fill=None):
    """General (oblique) batched affine bilinear warp as two dense
    interpolation products, no gathers: out[o] = sum_h ky[o,h] sum_w kx[o,w]
    src[h,w]. Cheap for small sources (a warp at source resolution)."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    sy, sx = _source_coords(mats, torch.arange(out_h, dtype=torch.float32, device=dev),
                            torch.arange(out_w, dtype=torch.float32, device=dev))
    O = out_h * out_w
    ky = _interp_matrix(sy.reshape(B, O), H)                   # [B, O, H]
    kx = _interp_matrix(sx.reshape(B, O), W)                   # [B, O, W]
    t = torch.einsum("bow,bhwc->bohc", kx, imgs)               # [B, O, H, C]
    out = torch.einsum("boh,bohc->boc", ky, t).reshape(B, out_h, out_w, C)
    if fill is not None:
        out = torch.where(_out_of_image(sy, sx, H, W)[..., None], fill, out)
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
    aspect = _exp(log_ratio)
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
# Pixel ops: batched over [B, H, W, C], per-sample magnitude m [B]
# -----------------------------------------------------------------------------

def _clip(x):
    return x.clamp(0.0, 255.0)


def _bcast(v, img):
    """[B] (or 0-d) -> broadcastable against [B, H, W, C]."""
    return v.reshape(v.shape + (1,) * (img.dim() - v.dim())) if v.dim() else v


def _blend(a, b, factor):
    # the factor in the image dtype, so a bf16 stage stays bf16
    return _clip(b + factor.to(b.dtype) * (a - b))


def _gray(img, keepdim=True):
    """ITU-R 601 luma in the image dtype, with the weights rounded to that
    dtype, summed as the compiled JAX sum does on the CPU: an fp32
    multiply-add chain r*wr, then + g*wg, then + b*wb, each rounded once to
    fp32, then one rounding to the image dtype. The products are exact in
    fp32 for a 16-bit image and in fp64 for an fp32 one, so a product then
    an add rounds as the multiply-add does."""
    wide = torch.float64 if img.dtype == torch.float32 else torch.float32
    w = _const(_GRAY, img.device, img.dtype).to(wide)
    x = img.to(wide)
    acc = (x[..., 0] * w[0]).float().to(wide)
    acc = (x[..., 1] * w[1] + acc).float().to(wide)
    acc = (x[..., 2] * w[2] + acc).float().to(img.dtype)
    return acc[..., None] if keepdim else acc


def op_invert(img, m=None, sign=None):
    return 255.0 - img


def op_solarize(img, m, sign=None):
    thresh = _bcast(256.0 - _div(m, 10.0) * 256.0, img)       # SolarizeIncreasing
    return torch.where(img < thresh, img, 255.0 - img)


def op_solarize_add(img, m, sign=None):
    add = _bcast(_div(m, 10.0) * 110.0, img).to(img.dtype)
    return torch.where(img < 128.0, _clip(img + add), img)


def _posterize(img, bits):
    q = _bcast(torch.pow(2, (8.0 - bits).long()), img).to(img.dtype)   # exact powers of 2
    return torch.floor(torch.floor(img) / q) * q


def op_posterize(img, m, sign=None):
    return _posterize(img, torch.clamp(4 - torch.floor(_div(m, 10.0) * 4.0), min=1.0))


def op_autocontrast(img, m=None, sign=None):
    lo = img.amin(dim=(-3, -2), keepdim=True)
    hi = img.amax(dim=(-3, -2), keepdim=True)
    span = torch.clamp(hi - lo, min=1e-5)
    scale = torch.full_like(span, 255.0) / span   # one rounding (255.0 / x is 255 * (1 / x))
    return torch.where(hi > lo, _clip((img - lo) * scale), img)


def op_equalize(img, m=None, sign=None):
    """PIL ImageOps.equalize: per image and channel, a LUT from the
    cumulative histogram; PIL's step leaves out the last occupied bin, and a
    channel whose step is 0 passes through unchanged."""
    B, H, W, C = img.shape
    npix = H * W
    dev = img.device
    v = torch.floor(img).clamp(0, 255).long()
    plane = (torch.arange(B, device=dev)[:, None, None, None] * C
             + torch.arange(C, device=dev)) * 256
    flat = (plane + v).reshape(-1)                       # (b, c, value)
    hist = torch.zeros(B * C * 256, dtype=torch.int64, device=dev)
    hist.scatter_add_(0, flat, torch.ones_like(flat))    # integer counts
    hist = hist.reshape(B, C, 256)
    last_val = 255 - torch.argmax((hist.flip(-1) > 0).int(), dim=-1)
    last_count = hist.gather(-1, last_val[..., None])[..., 0]
    # PIL's integer arithmetic: step = (npix - last) // 255, lut[v] =
    # (step // 2 + cumulative count below v) // step
    step = torch.div(npix - last_count, 255, rounding_mode="floor")
    cum_before = torch.cumsum(hist, -1) - hist
    lut = torch.div(torch.div(step, 2, rounding_mode="floor")[..., None] + cum_before,
                    step[..., None].clamp(min=1), rounding_mode="floor")
    mapped = lut.clamp(0, 255).reshape(-1)[flat].reshape(B, H, W, C)
    return torch.where(step[:, None, None, :] > 0, mapped.to(img.dtype), img)


def _enhance_factor(m, sign):
    """timm 'increasing' enhance arg: 1 + sign * 0.9 * m / 10."""
    return 1.0 + sign * _div(m, 10.0) * 0.9


def _aa_enhance_factor(level):
    """timm non-increasing enhance arg (AutoAugment): level/10 * 1.8 + 0.1."""
    return _div(level, 10.0) * 1.8 + 0.1


def _color_core(img, factor):
    return _blend(img, _gray(img).expand(img.shape), factor)


def _contrast_core(img, factor):
    mean = torch.round(_mean_hw(torch.floor(_gray(img, keepdim=False).float())))
    return _blend(img, _bcast(mean, img).to(img.dtype).expand(img.shape), factor)


def _brightness_core(img, factor):
    return _blend(img, torch.zeros_like(img), factor)


def _sharpness_core(x, factor):
    """PIL SHARPEN: a 3x3 smoothing ([[1,1,1],[1,5,1],[1,1,1]] / 13, weights
    in the image dtype, sums in fp32), the border kept, then a blend."""
    H, W = x.shape[1:3]
    w = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0
    w = w.to(x.dtype).float().tolist()
    xf = x.float()
    acc = sum(w[dy][dx] * xf[:, dy:H - 2 + dy, dx:W - 2 + dx]
              for dy in range(3) for dx in range(3))
    smoothed = x.clone()
    smoothed[:, 1:H - 1, 1:W - 1] = acc.to(x.dtype)
    return _blend(x, smoothed, factor)


def op_color(img, m, sign):
    return _color_core(img, _bcast(_enhance_factor(m, sign), img))


def op_contrast(img, m, sign):
    return _contrast_core(img, _bcast(_enhance_factor(m, sign), img))


def op_brightness(img, m, sign):
    return _brightness_core(img, _bcast(_enhance_factor(m, sign), img))


def op_sharpness(img, m, sign):
    return _sharpness_core(img, _bcast(_enhance_factor(m, sign), img))


# --- geometric ops: per-sample matrices composed into the main warp ---------

def _rotate_matrix(m, sign, size: int):
    """Rotation by sign * 30 m/10 degrees about the centre of the size x size
    output grid."""
    rad = _div(_div(sign * m, 10.0) * 30.0 * math.pi, 180.0)
    c, s = torch.cos(rad), torch.sin(rad)
    ctr = (size - 1) / 2.0
    row0 = torch.stack([c, -s, ctr - c * ctr + s * ctr], dim=-1)
    row1 = torch.stack([s, c, ctr - s * ctr - c * ctr], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _shear_matrix(m, sign, size: int, axis: int):
    """PIL/timm shear, origin-anchored: ShearX (axis 0) maps output (row, col)
    to source (row, col + sh * row); ShearY the transpose."""
    sh = _div(sign * m, 10.0) * 0.3
    one, zero = torch.ones_like(sh), torch.zeros_like(sh)
    if axis == 0:
        rows = ([one, zero, zero], [sh, one, zero])
    else:
        rows = ([one, sh, zero], [zero, one, zero])
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _translate_matrix(m, sign, size: int, axis: int):
    t = _div(sign * m, 10.0) * 0.45 * size
    one, zero = torch.ones_like(t), torch.zeros_like(t)
    ty = t if axis == 1 else zero
    tx = t if axis == 0 else zero
    row0 = torch.stack([one, zero, ty], dim=-1)
    row1 = torch.stack([zero, one, tx], dim=-1)
    return torch.stack([row0, row1], dim=-2)


# timm _RAND_INCREASING_TRANSFORMS op table: geometric entries carry their
# matrix builder, pixel entries their batched op (img, m, sign)
_GEO_BUILDERS = {
    3: _rotate_matrix,
    11: lambda m, sign, size: _shear_matrix(m, sign, size, 0),
    12: lambda m, sign, size: _shear_matrix(m, sign, size, 1),
    13: lambda m, sign, size: _translate_matrix(m, sign, size, 0),
    14: lambda m, sign, size: _translate_matrix(m, sign, size, 1),
}
_PIXEL_OPS = {
    0: op_autocontrast, 1: op_equalize, 2: op_invert, 4: op_posterize,
    5: op_solarize, 6: op_solarize_add, 7: op_color, 8: op_contrast,
    9: op_brightness, 10: op_sharpness,
}
NUM_RAND_OPS = 15
_HEAVY_PIXEL_OPS = (1, 10)  # equalize, sharpness: run on a batch subset


def _aa_solarize(img, level):
    """timm non-increasing Solarize: thresh = int(level/10 * 256)."""
    thresh = _bcast(torch.trunc(_div(level, 10.0) * 256.0), img)
    return torch.where(img < thresh, img, 255.0 - img)


def _aa_posterize_original(img, level):
    """timm PosterizeOriginal: bits = int(level/10 * 4) + 4."""
    return _posterize(img, torch.trunc(_div(level, 10.0) * 4.0) + 4.0)


def _aa_color(img, level):
    return _color_core(img, _bcast(_aa_enhance_factor(level), img))


def _aa_contrast(img, level):
    return _contrast_core(img, _bcast(_aa_enhance_factor(level), img))


def _aa_sharpness(img, level):
    return _sharpness_core(img, _bcast(_aa_enhance_factor(level), img))


# AutoAugment pixel appliers (img, level) by op index; AutoContrast, Equalize
# and Invert take no argument and are RandAugment's
_AA_PIXEL_OPS = {
    0: op_autocontrast, 1: op_equalize, 2: op_invert,
    4: _aa_posterize_original, 5: _aa_solarize,
    7: _aa_color, 8: _aa_contrast, 10: _aa_sharpness,
}


@dataclasses.dataclass
class OpDraws:
    """One RandAugment layer or one AutoAugment slot, per image: the op, whether
    it applies, its magnitude (RA) or level (AA), and a random sign for every
    op that takes one (row i for op i; the subset path of sharpness, op 10,
    reads the first k entries of its row, one per subset slot)."""

    op_idx: torch.Tensor      # [B] long
    apply: torch.Tensor       # [B] bool
    m: torch.Tensor           # [B] float
    sign: torch.Tensor        # [NUM_RAND_OPS, B] +-1.0


def _draw_signs(generator, batch: int, device):
    u = torch.rand(NUM_RAND_OPS, batch, generator=generator, device=device)
    return torch.where(u < 0.5, 1.0, -1.0)


def draw_ra_layer(generator, batch: int, ra: RandAugmentConfig, device=None) -> OpDraws:
    op_idx = torch.randint(0, NUM_RAND_OPS, (batch,), generator=generator, device=device)
    apply = torch.rand(batch, generator=generator, device=device) < ra.prob
    noise = torch.randn(batch, generator=generator, device=device)
    m = torch.clamp(ra.magnitude + ra.mstd * noise, 0.0, 10.0)
    return OpDraws(op_idx, apply, m, _draw_signs(generator, batch, device))


def draw_aa_slots(generator, batch: int, aa: AutoAugmentConfig, device=None) -> List[OpDraws]:
    """One sub-policy per image, then per slot its op, the apply gate
    u < prob and the level with optional gaussian noise clipped to [0, 10]
    (timm AugmentOp)."""
    op_t, prob_t, lvl_t = (_const(t, device) for t in AutoAugmentConfig.tables())
    sp = torch.randint(0, len(_AA_POLICY_ORIGINAL), (batch,), generator=generator,
                       device=device)
    slots = []
    for slot in range(2):
        apply = torch.rand(batch, generator=generator, device=device) < prob_t[sp, slot]
        level = lvl_t[sp, slot]
        if aa.mstd > 0:
            noise = torch.randn(batch, generator=generator, device=device)
            level = torch.clamp(level + aa.mstd * noise, 0.0, 10.0)
        slots.append(OpDraws(op_t[sp, slot].long(), apply, level,
                             _draw_signs(generator, batch, device)))
    return slots


def _ra_geo_matrices(op: OpDraws, size: int):
    """[B, 2, 3] matrix of this layer (the chosen geometric op, or identity)
    and a 0-d device flag: did any image draw a geometric op."""
    mat = _eye23(op.op_idx.shape[0], op.m.device)
    any_geo = torch.zeros((), dtype=torch.bool, device=op.m.device)
    for i, builder in _GEO_BUILDERS.items():
        sel = op.apply & (op.op_idx == i)
        mat = torch.where(sel[:, None, None], builder(op.m, op.sign[i], size), mat)
        any_geo = any_geo | sel.any()
    return mat, any_geo


def _apply_on_subset(op_fn, imgs, sel, k: int):
    """``op_fn(sub, idx)`` on at most ``k`` selected images: a stable sort of
    ~sel puts the selected rows first; their first k rows run the op and are
    written back. Selected rows past k skip the op (rare: a layer picks an
    op for about 1/30 of the batch, and k = max(8, B / 8))."""
    idx = torch.argsort((~sel).to(torch.uint8), stable=True)[:k]
    sub = imgs[idx]
    out_sub = torch.where(sel[idx][:, None, None, None], op_fn(sub, idx), sub)
    return imgs.index_copy(0, idx, out_sub)


def _apply_ra_pixel_ops(imgs, op: OpDraws, subset_ok: bool = True):
    """One RandAugment layer's pixel ops. Each image runs at most one op, so
    the masks are disjoint and every op reads the layer's input; equalize and
    sharpness run on a subset of the batch (``_apply_on_subset``)."""
    x = out = imgs
    subset_k = max(8, imgs.shape[0] // 8)
    for i, fn in _PIXEL_OPS.items():
        sel = op.apply & (op.op_idx == i)
        sign = op.sign[i]
        if i in _HEAVY_PIXEL_OPS and subset_ok:
            out = _apply_on_subset(
                lambda sub, idx, fn=fn, sign=sign: fn(sub, op.m[idx], sign[:sub.shape[0]]),
                out, sel, subset_k)
        else:
            out = torch.where(sel[:, None, None, None], fn(x, op.m, sign), out)
    return out


def _apply_aa_pixel_ops(imgs, op: OpDraws):
    """One AutoAugment slot's pixel ops, each on the whole batch from the
    slot's input (disjoint masks, as in a RandAugment layer)."""
    out = imgs
    for i, fn in _AA_PIXEL_OPS.items():
        sel = op.apply & (op.op_idx == i)
        out = torch.where(sel[:, None, None, None], fn(imgs, op.m), out)
    return out


# -----------------------------------------------------------------------------
# Colour jitter, 3-Augment
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class JitterDraws:
    brightness: torch.Tensor   # [B] factors in [max(0, 1 - s), 1 + s]
    contrast: torch.Tensor
    saturation: torch.Tensor
    order: torch.Tensor        # [3] a permutation of (0, 1, 2), one per batch


def draw_color_jitter(generator, batch: int, strength: float, device=None,
                      batch_generator=None) -> JitterDraws:
    """Per-image factors from ``generator``; the one order of the whole
    (global) batch from ``batch_generator``, which defaults to it."""
    lo, hi = max(0.0, 1 - strength), 1 + strength

    def u():
        return torch.rand(batch, generator=generator, device=device) * (hi - lo) + lo

    fb, fc, fs = u(), u(), u()
    order = torch.argsort(torch.rand(3, generator=batch_generator or generator,
                                     device=device))
    return JitterDraws(fb, fc, fs, order)


def color_jitter_batch(imgs, d: JitterDraws):
    """torchvision ColorJitter(brightness=contrast=saturation=s): per-sample
    factors, the three functions in the batch's drawn order. The order lives
    on the device, so each stage computes all three and selects one."""
    dt = imgs.dtype
    fb, fc, fs = (_bcast(f, imgs).to(dt) for f in (d.brightness, d.contrast, d.saturation))

    def brightness(im):
        return _clip(im * fb)

    def contrast(im):
        # the mean in fp32, rounded once to the image dtype
        gmean = _bcast(_mean_hw(_gray(im, keepdim=False).float()), im).to(dt)
        return _clip((im - gmean) * fc + gmean)

    def saturation(im):
        gray = _gray(im)
        return _clip((im - gray) * fs + gray)

    for i in range(3):
        which = d.order[i]
        imgs = torch.where(which == 0, brightness(imgs),
                           torch.where(which == 1, contrast(imgs), saturation(imgs)))
    return imgs


def gaussian_blur_batch(imgs, radius):
    """PIL GaussianBlur with a per-sample radius [B]: a separable 9-tap
    kernel, edge-replicated, as weighted shifted slices."""
    B, H, W, C = imgs.shape
    taps = torch.arange(-4.0, 5.0, device=imgs.device)
    w = torch.exp(-0.5 * (taps[None, :] / radius[:, None].clamp(min=1e-3)) ** 2)
    w = (w / w.sum(1, keepdim=True)).to(imgs.dtype)          # [B, 9]

    def pass_axis(x, axis):
        n = x.shape[axis]
        rows = torch.arange(-4, n + 4, device=x.device).clamp(0, n - 1)
        xp = x.index_select(axis, rows)
        acc = torch.zeros_like(x)
        for i in range(9):
            acc = acc + w[:, i].reshape(B, 1, 1, 1) * xp.narrow(axis, i, n)
        return acc

    return pass_axis(pass_axis(imgs, 1), 2)


def grayscale(img):
    return torch.round(_gray(img)).expand(img.shape)


@dataclasses.dataclass
class ThreeAugDraws:
    choice: torch.Tensor       # [B] 0 grayscale, 1 solarize, 2 gaussian blur
    radius: torch.Tensor       # [B] blur radius in [0.1, 2.0]
    jitter: Optional[JitterDraws]


def draw_three_augment(generator, batch: int, color_jitter: float, device=None,
                       batch_generator=None) -> ThreeAugDraws:
    choice = torch.randint(0, 3, (batch,), generator=generator, device=device)
    radius = torch.rand(batch, generator=generator, device=device) * 1.9 + 0.1
    jitter = (draw_color_jitter(generator, batch, color_jitter, device, batch_generator)
              if color_jitter > 0 else None)
    return ThreeAugDraws(choice, radius, jitter)


def three_augment(imgs, d: ThreeAugDraws):
    """DeiT-III 3-Augment: per image one of grayscale, solarize (128) and
    gaussian blur, then colour jitter."""
    sol = torch.where(imgs < 128.0, imgs, 255.0 - imgs)
    c = d.choice[:, None, None, None]
    imgs = torch.where(c == 0, grayscale(imgs),
                       torch.where(c == 1, sol, gaussian_blur_batch(imgs, d.radius)))
    return color_jitter_batch(imgs, d.jitter) if d.jitter is not None else imgs


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
    aspect = _exp(d.log_ratio)
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
    ra: Optional[List[OpDraws]] = None    # one per RandAugment layer
    aa: Optional[List[OpDraws]] = None    # the two AutoAugment slots
    three: Optional[ThreeAugDraws] = None
    jitter: Optional[JitterDraws] = None  # colour jitter without aa


def draw_train_transform(generator, shape, ac: AugmentConfig, device=None,
                         batch_generator=None) -> TrainDraws:
    """The per-image draws from ``generator``; the draw that the JAX package
    makes once for the whole global batch (colour jitter's order) from
    ``batch_generator``, which under data parallelism is equal on every rank
    (default: ``generator``). The order of the draws is the same either way."""
    B, H, W, C = shape
    S = ac.input_size
    if ac.small_input_crop or ac.src:
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
    d = TrainDraws(top, left, ch, cw, flip, pick, None)
    if ac.three_augment:
        d.three = draw_three_augment(generator, B, ac.color_jitter, device, batch_generator)
    else:
        if ac.rand_augment is not None:
            d.ra = [draw_ra_layer(generator, B, ac.rand_augment, device)
                    for _ in range(ac.rand_augment.num_layers)]
        if ac.auto_augment is not None:
            d.aa = draw_aa_slots(generator, B, ac.auto_augment, device)
        if d.ra is None and d.aa is None and ac.color_jitter > 0:
            d.jitter = draw_color_jitter(generator, B, ac.color_jitter, device,
                                         batch_generator)
    if ac.reprob > 0:
        d.erase = draw_random_erasing(generator, (B, S, S, C), ac.reprob, mode=ac.remode,
                                      max_count=ac.recount, device=device)
    return d


def _normalize(img, ac: AugmentConfig):
    mean = (_const(ac.mean, img.device) * 255.0).to(img.dtype)
    inv_std = (1.0 / (_const(ac.std, img.device) * 255.0)).to(img.dtype)
    return (img - mean) * inv_std


def _geometry(d: TrainDraws, S: int):
    """The RA layers' and AA slots' geometric ops as one [B, 2, 3] output-space
    affine and a 0-d device flag (any image drew one); None without RA/AA."""
    ops = (d.ra or []) + (d.aa or [])
    if not ops:
        return None, None
    geo, any_geo = None, None
    for op in ops:
        g, a = _ra_geo_matrices(op, S)
        geo = g if geo is None else compose(geo, g)
        any_geo = a if any_geo is None else any_geo | a
    return geo, any_geo


def geometric_stage(images_u8, ac: AugmentConfig, d: TrainDraws):
    """Steps 1-4 of the train transform: the crop and the flip as one
    axis-aligned affine; the RA/AA geometric ops as one oblique warp, run at
    the smaller of the source and the output resolution (at the source
    through the crop's conjugate, a dense-matmul warp, for sources of at most
    DENSE_WARP_MAX_SIDE px; at the output a gather warp) and selected by a
    device flag when any image drew one; the resample; the rounding to
    integer pixels and the bf16 cast."""
    B, H, W, _ = images_u8.shape
    S = ac.input_size
    dev = images_u8.device
    fill = _const([round(m * 255) for m in ac.mean], dev)
    mats = crop_matrix(d.top, d.left, d.crop_h, d.crop_w, S, S)
    flipped = compose(mats, hflip_matrix(S, dev).expand(B, 2, 3))
    mats = torch.where(d.flip[:, None, None], flipped, mats)
    crop_fill = torch.zeros(3, device=dev) if ac.small_input_crop else None
    reflect = ac.src and not ac.small_input_crop

    def resample(x):
        return resample_separable(x, mats, S, S, fill=crop_fill, method=ac.interpolation,
                                  pick=d.interp_pick, reflect=reflect)

    geo, any_geo = _geometry(d, S)
    imgs = images_u8.float()
    if geo is None:
        imgs = resample(imgs)
    elif H * W <= S * S and max(H, W) <= DENSE_WARP_MAX_SIDE:
        # the output-space affine conjugated into source space: M G = (M G M^-1) M
        g_src = (_to3(mats) @ _to3(geo) @ _to3(_invert_axis_aligned(mats)))[:, :2]
        imgs = resample(torch.where(any_geo, warp_dense_matmul(imgs, g_src, H, W, fill),
                                    imgs))
    else:
        imgs = resample(imgs)
        imgs = torch.where(any_geo, warp_bilinear_batch(imgs, geo, S, S, fill), imgs)
    # integer pixels, like PIL's uint8 output (and exact in bf16)
    imgs = torch.round(_clip(imgs))
    return imgs.to(torch.bfloat16) if ac.pixel_bf16 else imgs


def pixel_stage(imgs, ac: AugmentConfig, d: TrainDraws):
    """Step 5 and after: the pixel ops (the RA layers, the AA slots; or
    3-Augment; or colour jitter alone) in the image dtype, normalisation and
    random erasing."""
    if d.three is not None:
        imgs = three_augment(imgs, d.three)
    for op in d.ra or []:
        imgs = _apply_ra_pixel_ops(imgs, op, subset_ok=ac.subset_ops)
    for op in d.aa or []:
        imgs = _apply_aa_pixel_ops(imgs, op)
    if d.jitter is not None:
        imgs = color_jitter_batch(imgs, d.jitter)
    imgs = _normalize(imgs, ac)
    if d.erase is not None:
        imgs = apply_random_erasing(imgs, d.erase, ac.remode)
    return imgs


def apply_train_transform(images_u8, ac: AugmentConfig, d: TrainDraws):
    """[B, H, W, 3] uint8 -> [B, S, S, 3] normalised (float32, or bf16 with
    ``pixel_bf16``), from the given draws."""
    return pixel_stage(geometric_stage(images_u8, ac, d), ac, d)


def draws_to(d, device):
    """Draws (TrainDraws, MixupDraws or any part of them) with every tensor
    on ``device``: the same transform on another device."""
    if isinstance(d, torch.Tensor):
        return d.to(device)
    if isinstance(d, list):
        return [draws_to(x, device) for x in d]
    if dataclasses.is_dataclass(d):
        return dataclasses.replace(d, **{f.name: draws_to(getattr(d, f.name), device)
                                         for f in dataclasses.fields(d)})
    return d


def train_transform(generator, images_u8, ac: AugmentConfig, batch_generator=None):
    d = draw_train_transform(generator, images_u8.shape, ac, device=images_u8.device,
                             batch_generator=batch_generator)
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
