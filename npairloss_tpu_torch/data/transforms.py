"""Data augmentation on the device, in torch — port of
``npairloss_tpu/data/transforms.py``.

The reference splits augmentation between Caffe's ``transform_param``
(mean subtraction, random crop, mirror — usage/def.prototxt:10-16) and a
``DataTransformer`` layer (rotation, translation, scale, horizontal flip,
optional elastic deformation — def.prototxt:69-83).  Here both run
batched on the tensor's device:

  * rotation, scale and translation compose into one inverse affine per
    image about its centre; one bilinear gather warps the image;
  * the elastic deformation is Gaussian-smoothed noise added to the same
    sampling grid;
  * crop, mirror and mean are gathers and elementwise ops.

Every random operation is split in two: a draw (``transformer_draws``,
``transform_param_draws``) that takes a ``torch.Generator`` and returns
the per-image parameters, and an apply (``data_transformer``,
``apply_transform_param``) that is a plain function of images and draws.
So the tests can feed the apply functions the JAX package's own draws;
the numbers a generator gives differ between the packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from npairloss_tpu_torch.config.schema import TransformParam, TransformerConfig
from npairloss_tpu_torch.device import upload


# -- bilinear warp primitives --------------------------------------------------


def bilinear_sample(images: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Sample images [N, H, W, C] at float coordinates ys, xs [N, Ho, Wo],
    border-clamped.  As ``_bilinear_sample``: the weights come from the
    unclipped floor, the upper neighbour is the clipped floor plus one,
    clipped again."""
    n, h, w, c = images.shape
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy = (ys - y0f)[..., None]
    wx = (xs - x0f)[..., None]
    y0 = y0f.long().clamp(0, h - 1)
    x0 = x0f.long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    flat = images.reshape(n, h * w, c)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(n, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(*yy.shape, c)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def gaussian_kernel1d(radius: float, width: int) -> np.ndarray:
    """Normalized Gaussian taps at offsets -width..width (fp32)."""
    sigma = max(float(radius), 1e-3)
    xs = np.arange(-width, width + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def smooth_field(field: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of fields [..., H, W]: edge padding, then a
    'valid' convolution down the columns, then along the rows."""
    shape = field.shape
    k = kernel.flip(0).to(field)  # a convolution, as jnp.convolve
    pad = k.shape[0] // 2
    f = field.reshape(-1, 1, shape[-2], shape[-1])
    f = F.conv2d(F.pad(f, (0, 0, pad, pad), mode="replicate"),
                 k.view(1, 1, -1, 1))
    f = F.conv2d(F.pad(f, (pad, pad, 0, 0), mode="replicate"),
                 k.view(1, 1, 1, -1))
    return f.reshape(shape)


def warp(images: torch.Tensor, angle: torch.Tensor, tx: torch.Tensor,
         ty: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor,
         flip: torch.Tensor,
         disp: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
         ) -> torch.Tensor:
    """The inverse affine about each image's centre (undo translation,
    then rotation and scale, then the horizontal flip), plus an optional
    displacement field (dy, dx) [N, H, W]; per-image parameters [N]."""
    n, h, w, _ = images.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dev = images.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")

    def col(v):
        return v.to(device=dev, dtype=torch.float32).view(n, 1, 1)

    yr = yy - cy - col(ty)
    xr = xx - cx - col(tx)
    cos, sin = torch.cos(col(angle)), torch.sin(col(angle))
    xs = (cos * xr + sin * yr) / col(sx)
    ys = (-sin * xr + cos * yr) / col(sy)
    xs = torch.where(flip.to(dev).view(n, 1, 1), -xs, xs)
    ys = ys + cy
    xs = xs + cx
    if disp is not None:
        ys = ys + disp[0]
        xs = xs + disp[1]
    return bilinear_sample(images, ys, xs)


# -- DataTransformer: rotation + translation + scale + flip + elastic ---------


@dataclasses.dataclass(frozen=True)
class WarpDraws:
    """Per-image DataTransformer parameters [N]; ``noise`` [N, 2, H, W]
    is standard normal (scaled by ``amplitude`` when applied), present
    when the config is elastic."""

    angle: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    sx: torch.Tensor
    sy: torch.Tensor
    flip: torch.Tensor
    noise: Optional[torch.Tensor] = None


def _scale_range(s) -> Tuple[float, float]:
    # A symmetric zoom U(min(s, 1/s), max(s, 1/s)): scope 0.8 and 1.25
    # mean the same +-25 %.
    s = float(s) if s else 1.0
    if s <= 0:
        return 1.0, 1.0
    return min(s, 1.0 / s), max(s, 1.0 / s)


def transformer_draws(n: int, h: int, w: int, cfg: TransformerConfig,
                      generator: torch.Generator) -> WarpDraws:
    """Per image: angle ~ U(-rotate_angle_scope, +scope) [radians], t_w /
    t_h ~ U(-translation scope, +scope) [pixels], s_w / s_h in the folded
    scale range, flip ~ Bernoulli(0.5) when h_flip; standard normal noise
    for the elastic field.  On the generator's device."""
    dev = generator.device

    def uniform(lo, hi):
        u = torch.rand(n, generator=generator, device=dev)
        return lo + (hi - lo) * u

    scope = float(cfg.rotate_angle_scope)
    tw, th = float(cfg.translation_w_scope), float(cfg.translation_h_scope)
    angle = uniform(-scope, scope)
    tx = uniform(-tw, tw)
    ty = uniform(-th, th)
    sx = uniform(*_scale_range(cfg.scale_w_scope))
    sy = uniform(*_scale_range(cfg.scale_h_scope))
    flip = (torch.rand(n, generator=generator, device=dev) < 0.5
            if cfg.h_flip else torch.zeros(n, dtype=torch.bool, device=dev))
    noise = (torch.randn((n, 2, h, w), generator=generator, device=dev)
             if cfg.elastic_transform else None)
    return WarpDraws(angle, tx, ty, sx, sy, flip, noise)


def data_transformer(images: torch.Tensor, cfg: TransformerConfig,
                     draws: WarpDraws) -> torch.Tensor:
    """The DataTransformer warp of images [N, H, W, C] (fp32 out) with
    the given draws; the elastic field is the draws' noise times
    ``amplitude``, smoothed by a Gaussian of sigma ``radius``."""
    images = images.to(torch.float32)
    disp = None
    if cfg.elastic_transform:
        kernel = torch.from_numpy(gaussian_kernel1d(
            cfg.radius, max(int(3 * cfg.radius), 1)))
        noise = draws.noise.to(images.device) * float(
            np.float32(cfg.amplitude))
        smooth = smooth_field(noise, kernel)
        disp = (smooth[:, 0], smooth[:, 1])
    return warp(images, draws.angle, draws.tx, draws.ty, draws.sx, draws.sy,
                draws.flip, disp)


# -- transform_param: mean subtraction + crop + mirror ------------------------


@dataclasses.dataclass(frozen=True)
class CropDraws:
    """Per-image crop offsets [N] (None: no crop) and mirror flags [N]
    (None: no mirror)."""

    oy: Optional[torch.Tensor] = None
    ox: Optional[torch.Tensor] = None
    mirror: Optional[torch.Tensor] = None


def transform_param_draws(n: int, h: int, w: int, tp: TransformParam,
                          train: bool,
                          generator: torch.Generator) -> CropDraws:
    """TRAIN: a random crop offset per image and a mirror flag with p =
    0.5 (when ``mirror``); TEST: the centre crop, no mirror.  A crop
    larger than the image draws nothing (``apply_transform_param``
    refuses it)."""
    dev = generator.device
    crop = int(tp.crop_size)
    oy = ox = mirror = None
    if crop and crop <= min(h, w) and (crop < h or crop < w):
        if train:
            oy = torch.randint(0, h - crop + 1, (n,), generator=generator,
                               device=dev)
            ox = torch.randint(0, w - crop + 1, (n,), generator=generator,
                               device=dev)
        else:
            oy = torch.full((n,), (h - crop) // 2, dtype=torch.int64,
                            device=dev)
            ox = torch.full((n,), (w - crop) // 2, dtype=torch.int64,
                            device=dev)
    if tp.mirror and train:
        mirror = torch.rand(n, generator=generator, device=dev) < 0.5
    return CropDraws(oy, ox, mirror)


def apply_transform_param(images: torch.Tensor, tp: TransformParam,
                          train: bool, draws: CropDraws) -> torch.Tensor:
    """Caffe transform_param on images [N, H, W, C] (fp32 out): subtract
    the mean (given in Caffe's BGR order, so reversed for RGB images),
    scale, crop at the draws' offsets (clamped as ``dynamic_slice``
    clamps), mirror where the draws say (TRAIN only)."""
    images = images.to(torch.float32)
    n, h, w, c = images.shape
    if tp.mean_value:
        mean = list(tp.mean_value)
        if len(mean) == 1:
            mean = mean * c
        if len(mean) != c:
            raise ValueError(
                f"mean_value has {len(tp.mean_value)} entries; expected 1 or "
                f"{c} (channel count)")
        images = images - upload(
            np.asarray(mean[::-1], np.float32), images.device)
    if tp.scale != 1.0:
        images = images * float(np.float32(tp.scale))
    crop = int(tp.crop_size)
    if crop and crop > min(h, w):
        raise ValueError(f"crop_size {crop} exceeds image size {h}x{w}")
    if crop and (crop < h or crop < w):
        dev = images.device
        steps = torch.arange(crop, device=dev)
        oy = draws.oy.to(dev).clamp(0, h - crop).view(n, 1) + steps
        ox = draws.ox.to(dev).clamp(0, w - crop).view(n, 1) + steps
        rows = torch.arange(n, device=dev).view(n, 1, 1)
        images = images[rows, oy.view(n, crop, 1), ox.view(n, 1, crop)]
    if tp.mirror and train:
        flip = draws.mirror.to(images.device).view(n, 1, 1, 1)
        images = torch.where(flip, images.flip(2), images)
    return images


def augment(images: torch.Tensor, generator: torch.Generator,
            tp: Optional[TransformParam] = None,
            transformer: Optional[TransformerConfig] = None,
            train: bool = True) -> torch.Tensor:
    """The whole pipeline: the DataTransformer warp (TRAIN only, as the
    reference's include{phase: TRAIN}), then transform_param; draws
    from ``generator`` (on the images' device)."""
    n, h, w, _ = images.shape
    if transformer is not None and train:
        images = data_transformer(
            images, transformer,
            transformer_draws(n, h, w, transformer, generator))
    if tp is not None:
        images = apply_transform_param(
            images, tp, train,
            transform_param_draws(n, h, w, tp, train, generator))
    return images
