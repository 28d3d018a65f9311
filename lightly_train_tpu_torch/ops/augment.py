"""On-device fused multi-crop augmentation.

Port of the parts of ``lightly_train_tpu/ops/augment.py`` that the DINOv2
views reach through ``augment_view_with_geometry``. Op order:
RandomResizedCrop -> HFlip/VFlip -> ColorJitter -> ToGray -> GaussianBlur ->
Solarize -> Normalize, batched on the device from a uint8 (B, H, W, 3)
batch, channels-last as in the JAX package.

Every random op comes in two parts: a sampler that takes an explicit
``torch.Generator`` (on the images' device) and returns the sampled
parameters, and a deterministic function of the images and those parameters
(the ``*_with`` functions, :func:`crop_resize_matmul`). The tests feed both
packages the same sampled parameters; the samplers are checked by bounds.
:func:`override_view_specs` applies the user's ``transform_args``; random
rotation (reflect-101 border, bilinear) runs after the flips.
:func:`crop_resize_nearest` crops integer region masks with a view's crop
geometry (DetCon's dataset masks). Channel drop only acts on images of more
than 3 channels, which wait for ``LIGHTLY_TRAIN_IMAGE_MODE=UNCHANGED``
(ROADMAP item 19), and is refused until then.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ViewAugmentConfig:
    """Static parameters for one view family (the JAX fields the DINOv2
    views use)."""

    out_size: Tuple[int, int] = (224, 224)
    crop_scale: Tuple[float, float] = (0.08, 1.0)
    crop_ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    hflip_prob: float = 0.5
    vflip_prob: float = 0.0
    # color jitter
    cj_prob: float = 0.8
    cj_strength: float = 0.5
    cj_bright: float = 0.8
    cj_contrast: float = 0.8
    cj_sat: float = 0.4
    cj_hue: float = 0.2
    # grayscale
    gray_prob: float = 0.2
    # blur
    blur_prob: float = 0.5
    blur_sigma: Tuple[float, float] = (0.1, 2.0)
    blur_kernel_size: int = 9
    # solarize
    solarize_prob: float = 0.0
    solarize_threshold: float = 0.5
    # random rotation: an angle in [-degrees, degrees] with probability
    # prob, reflect-101 border, after the flips at the view resolution.
    rotation_prob: float = 0.0
    rotation_degrees: float = 0.0
    # crop interpolation: "area" = cv2 INTER_AREA, "bilinear" = hat kernel.
    interpolation: str = "area"
    # normalize
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


def _uniform(generator: torch.Generator, shape, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


# ---------------------------------------------------------------------------
# crop + resize
# ---------------------------------------------------------------------------


def _sample_crop_boxes(
    generator: torch.Generator,
    batch: int,
    in_hw: Tuple[int, int],
    scale: Tuple[float, float],
    ratio: Tuple[float, float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample (y0, x0, h, w) float crop boxes, one per image. Shapes (B,)."""
    H, W = in_hw
    dev = generator.device
    if tuple(scale) == (1.0, 1.0):
        full = torch.zeros(batch, device=dev)
        return (full, full, torch.full((batch,), float(H), device=dev),
                torch.full((batch,), float(W), device=dev))
    area = H * W * _uniform(generator, (batch,), scale[0], scale[1])
    log_ratio = _uniform(generator, (batch,), math.log(ratio[0]),
                         math.log(ratio[1]))
    aspect = torch.exp(log_ratio)
    w = torch.clamp(torch.sqrt(area * aspect), 1.0, W)
    h = torch.clamp(torch.sqrt(area / aspect), 1.0, H)
    # Clamp to bounds instead of retrying (as the JAX sampler does).
    y0 = _uniform(generator, (batch,)) * (H - h)
    x0 = _uniform(generator, (batch,)) * (W - w)
    return y0, x0, h, w


def _bilinear_weight_matrix(src: torch.Tensor, in_size: int) -> torch.Tensor:
    """(..., out) source coords -> (..., out, in) bilinear hat weights."""
    idx = torch.arange(in_size, dtype=torch.float32, device=src.device)
    return torch.clamp(1.0 - torch.abs(src[..., None] - idx), 0.0, 1.0)


def _area_down_weight_matrix(y0: torch.Tensor, h: torch.Tensor, in_size: int,
                             out: int) -> torch.Tensor:
    """(B, out, in) cv2 INTER_AREA downscale weights for crops [y0, y0+h)."""
    dev = y0.device
    s = (h / out)[:, None]
    i = torch.arange(out, dtype=torch.float32, device=dev)[None]
    a = torch.clamp(y0[:, None] + i * s, 0.0, float(in_size))
    b = torch.clamp(y0[:, None] + (i + 1.0) * s, 0.0, float(in_size))
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    overlap = torch.clamp(
        torch.minimum(b[..., None], j + 1.0) - torch.maximum(a[..., None], j),
        0.0, 1.0,
    )
    return overlap / torch.clamp(b - a, min=1e-9)[..., None]


def _area_up_weight_matrix(y0: torch.Tensor, h: torch.Tensor, in_size: int,
                           out: int) -> torch.Tensor:
    """(B, out, in) cv2 INTER_AREA upscale weights (cv2's 2-tap path)."""
    dev = y0.device
    s = (h / out)[:, None]
    i = torch.arange(out, dtype=torch.float32, device=dev)[None]
    sxf = torch.floor(i * s)
    fx = (i + 1.0) - (sxf + 1.0) / torch.clamp(s, min=1e-9)
    fx = torch.where(fx <= 0.0, torch.zeros_like(fx), fx - torch.floor(fx))
    col = torch.clamp(y0[:, None] + sxf, 0.0, in_size - 1.0)
    col1 = torch.clamp(col + 1.0, max=in_size - 1.0)
    j = torch.arange(in_size, dtype=torch.float32, device=dev)
    one0 = (torch.abs(col[..., None] - j) < 0.5).float()
    one1 = (torch.abs(col1[..., None] - j) < 0.5).float()
    return one0 * (1.0 - fx)[..., None] + one1 * fx[..., None]


def crop_resize_matmul(
    images: torch.Tensor,
    y0: torch.Tensor,
    x0: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    out_hw: Tuple[int, int],
    hflip: Optional[torch.Tensor] = None,
    method: str = "bilinear",
) -> torch.Tensor:
    """Batched crop+resize as two batched matmuls.

    images: (B, H, W, C); y0/x0/h/w: (B,) crop boxes in pixels; ``hflip``
    ((B,) bool) mirrors the column resampling. ``method="area"`` reproduces
    cv2 INTER_AREA (area averaging when both axes downscale, cv2's 2-tap
    fallback per axis otherwise).
    """
    B, H, W, C = images.shape
    oh, ow = out_hw
    dev = images.device
    if method == "area":
        down_both = ((h / oh) >= 1.0) & ((w / ow) >= 1.0)

        def one_axis(o, hh, in_size, out):
            return torch.where(
                down_both[:, None, None],
                _area_down_weight_matrix(o, hh, in_size, out),
                _area_up_weight_matrix(o, hh, in_size, out),
            )

        Ry = one_axis(y0, h, H, oh)
        Rx = one_axis(x0, w, W, ow)
        if hflip is not None:
            Rx = torch.where(hflip[:, None, None], torch.flip(Rx, dims=[1]), Rx)
    else:
        t_y = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
        t_x = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
        t_x = t_x[None, :].expand(B, ow)
        if hflip is not None:
            t_x = torch.where(hflip[:, None], 1.0 - t_x, t_x)
        sy = torch.clamp(y0[:, None] + t_y[None, :] * h[:, None] - 0.5,
                         0.0, H - 1.0)
        sx = torch.clamp(x0[:, None] + t_x * w[:, None] - 0.5, 0.0, W - 1.0)
        Ry = _bilinear_weight_matrix(sy, H)
        Rx = _bilinear_weight_matrix(sx, W)
    img_f = images.float()
    rows = torch.einsum("boh,bhwc->bowc", Ry, img_f)
    return torch.einsum("bowc,bxw->boxc", rows, Rx)


def _nearest_weight_matrix(src: torch.Tensor, in_size: int) -> torch.Tensor:
    """(..., out) source coords -> (..., out, in) one-hot nearest matrix."""
    idx = torch.arange(in_size, dtype=torch.float32, device=src.device)
    nearest = torch.round(torch.clamp(src, 0, in_size - 1))
    return (torch.abs(nearest[..., None] - idx) < 0.5).float()


def crop_resize_nearest(
    masks: torch.Tensor,
    y0: torch.Tensor,
    x0: torch.Tensor,
    h: torch.Tensor,
    w: torch.Tensor,
    out_hw: Tuple[int, int],
) -> torch.Tensor:
    """Nearest-neighbour crop+resize of integer (B, H, W) masks with the
    crop geometry of an image view: two products with one-hot resampling
    matrices, so the ids come out exact (below 2^24)."""
    B, H, W = masks.shape
    oh, ow = out_hw
    dev = masks.device
    t_y = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    t_x = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    sy = torch.clamp(y0[:, None] + t_y[None, :] * h[:, None] - 0.5,
                     0.0, H - 1.0)
    sx = torch.clamp(x0[:, None] + t_x[None, :] * w[:, None] - 0.5,
                     0.0, W - 1.0)
    Ry = _nearest_weight_matrix(sy, H)
    Rx = _nearest_weight_matrix(sx, W)
    rows = torch.einsum("boh,bhw->bow", Ry, masks.float())
    out = torch.einsum("bow,bxw->box", rows, Rx)
    return torch.round(out).to(masks.dtype)


# ---------------------------------------------------------------------------
# flips and rotation
# ---------------------------------------------------------------------------


def flip_with(images: torch.Tensor, do_h: Optional[torch.Tensor],
              do_v: Optional[torch.Tensor]) -> torch.Tensor:
    """Flip the images where the (B,) bools ``do_h`` / ``do_v`` are set."""
    out = images
    if do_h is not None:
        out = torch.where(do_h[:, None, None, None], torch.flip(out, [2]), out)
    if do_v is not None:
        out = torch.where(do_v[:, None, None, None], torch.flip(out, [1]), out)
    return out


def random_flip(generator: torch.Generator, images: torch.Tensor,
                hflip_prob: float, vflip_prob: float) -> torch.Tensor:
    """Random horizontal/vertical flips, batched. images: (B, H, W, C)."""
    B = images.shape[0]
    do_h = _uniform(generator, (B,)) < hflip_prob if hflip_prob > 0 else None
    do_v = _uniform(generator, (B,)) < vflip_prob if vflip_prob > 0 else None
    return flip_with(images, do_h, do_v)


def sample_rotation(generator: torch.Generator, batch: int, prob: float,
                    degrees: float) -> Params:
    """apply (B,) bool and angle (B,) in radians, uniform in [-degrees,
    degrees] where applied and 0 elsewhere."""
    apply = _uniform(generator, (batch,)) < prob
    angle = _uniform(generator, (batch,), -degrees, degrees) * (
        math.pi / 180.0)
    return {"rotate": apply,
            "rotate_angle": torch.where(apply, angle, torch.zeros_like(angle))}


def random_rotate_with(images: torch.Tensor, apply: torch.Tensor,
                       angle: torch.Tensor) -> torch.Tensor:
    """Rotate each (H, W, C) image about its centre by ``angle`` where
    ``apply``: bilinear sampling of the inversely rotated grid, borders
    reflected as OpenCV's BORDER_REFLECT_101 (albumentations' ``Rotate``)."""
    return rotate_with_cos_sin(images, apply, torch.cos(angle),
                               torch.sin(angle))


def rotate_with_cos_sin(images: torch.Tensor, apply: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """:func:`random_rotate_with` from each angle's (B,) cosine and sine."""
    B, H, W, C = images.shape
    dev = images.device
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    ys = torch.arange(H, dtype=torch.float32, device=dev) - cy
    xs = torch.arange(W, dtype=torch.float32, device=dev) - cx
    yy = ys[:, None].expand(H, W)
    xx = xs[None, :].expand(H, W)
    sy = cos[:, None, None] * yy[None] - sin[:, None, None] * xx[None] + cy
    sx = sin[:, None, None] * yy[None] + cos[:, None, None] * xx[None] + cx

    def reflect101(v, n):
        period = 2.0 * (n - 1)
        v = torch.remainder(torch.abs(v), period)
        return torch.minimum(v, period - v)

    sy = reflect101(sy, H)
    sx = reflect101(sx, W)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = (sy - y0)[..., None]
    fx = (sx - x0)[..., None]
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    flat = images.reshape(B, H * W, C)

    def gather(yi, xi):
        lin = (yi * W + xi).reshape(B, H * W, 1).expand(B, H * W, C)
        return torch.gather(flat, 1, lin).reshape(B, H, W, C)

    out = (gather(y0i, x0i) * (1 - fy) * (1 - fx)
           + gather(y0i, x1i) * (1 - fy) * fx
           + gather(y1i, x0i) * fy * (1 - fx)
           + gather(y1i, x1i) * fy * fx)
    return torch.where(apply[:, None, None, None], out, images)


def random_rotate(generator: torch.Generator, images: torch.Tensor,
                  prob: float, degrees: float) -> torch.Tensor:
    if prob <= 0.0 or degrees == 0.0:
        return images
    p = sample_rotation(generator, images.shape[0], prob, degrees)
    return random_rotate_with(images, p["rotate"], p["rotate_angle"])


# ---------------------------------------------------------------------------
# photometric ops
# ---------------------------------------------------------------------------

_RGB2GRAY = (0.299, 0.587, 0.114)
# YIQ conversion for linear hue rotation.
_RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322),
            (0.211, -0.523, 0.312))
_YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647),
            (1.0, -1.106, 1.703))


def _gray(images: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(_RGB2GRAY, dtype=images.dtype, device=images.device)
    return torch.tensordot(images, w, dims=([-1], [0]))


def sample_color_jitter(
    generator: torch.Generator, batch: int, prob: float = 0.8,
    strength: float = 0.5, brightness: float = 0.8, contrast: float = 0.8,
    saturation: float = 0.4, hue: float = 0.2,
) -> Params:
    """apply (B,) bool, brightness/contrast/saturation factors (B,) uniform
    in [max(0, 1 - s*v), 1 + s*v], hue angle theta (B,) in radians."""

    def factor(v: float) -> torch.Tensor:
        return _uniform(generator, (batch,), max(0.0, 1.0 - strength * v),
                        1.0 + strength * v)

    apply = _uniform(generator, (batch,)) < prob
    fb, fc, fs = factor(brightness), factor(contrast), factor(saturation)
    theta = _uniform(generator, (batch,), -strength * hue,
                     strength * hue) * 2.0 * math.pi
    return {"apply": apply, "fb": fb, "fc": fc, "fs": fs, "theta": theta}


def color_jitter_with(images: torch.Tensor, p: Params) -> torch.Tensor:
    """ColorJitter on float images in [0, 1], as ONE per-image 3x3 matrix +
    offset (brightness -> contrast -> saturation -> YIQ hue rotation),
    clipped once at the end (the JAX package's composed form)."""
    B = images.shape[0]
    dev = images.device
    fb, fc, fs, theta = p["fb"], p["fc"], p["fs"], p["theta"]
    eye = torch.eye(3, device=dev)
    A = fb[:, None, None] * eye[None]
    o = torch.zeros(B, 3, device=dev)
    gray_mean = _gray(images).mean(dim=(1, 2))
    A = fc[:, None, None] * A
    o = fc[:, None] * o + ((1.0 - fc) * fb * gray_mean)[:, None]
    G = torch.outer(torch.ones(3, device=dev),
                    torch.tensor(_RGB2GRAY, device=dev))
    S = fs[:, None, None] * eye[None] + (1.0 - fs)[:, None, None] * G[None]
    A = torch.einsum("bij,bjk->bik", S, A)
    o = torch.einsum("bij,bj->bi", S, o)
    c_t, s_t = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(c_t), torch.ones_like(c_t)
    R_yiq = torch.stack([
        torch.stack([ones, zeros, zeros], -1),
        torch.stack([zeros, c_t, -s_t], -1),
        torch.stack([zeros, s_t, c_t], -1),
    ], dim=1)
    yiq2rgb = torch.tensor(_YIQ2RGB, device=dev)
    rgb2yiq = torch.tensor(_RGB2YIQ, device=dev)
    H_mat = torch.einsum("ij,bjk,kl->bil", yiq2rgb, R_yiq, rgb2yiq)
    A = torch.einsum("bij,bjk->bik", H_mat, A)
    o = torch.einsum("bij,bj->bi", H_mat, o)
    out = torch.einsum("bhwc,bdc->bhwd", images, A) + o[:, None, None, :]
    out = torch.clamp(out, 0.0, 1.0)
    apply = p["apply"].float()[:, None, None, None]
    return images * (1.0 - apply) + out * apply


def color_jitter(generator: torch.Generator, images: torch.Tensor,
                 **kwargs) -> torch.Tensor:
    return color_jitter_with(
        images, sample_color_jitter(generator, images.shape[0], **kwargs))


def grayscale_with(images: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    gray = _gray(images)[..., None].expand_as(images)
    return torch.where(apply[:, None, None, None], gray, images)


def random_grayscale(generator: torch.Generator, images: torch.Tensor,
                     prob: float) -> torch.Tensor:
    if prob <= 0:
        return images
    return grayscale_with(images, _uniform(generator, (images.shape[0],)) < prob)


def gaussian_blur_with(images: torch.Tensor, apply: torch.Tensor,
                       sigma: torch.Tensor, kernel_size: int = 9
                       ) -> torch.Tensor:
    """Per-image Gaussian blur as two banded matmuls (edge-renormalized zero
    padding), in bf16 as the JAX package does it."""
    B, H, W, C = images.shape
    half = kernel_size // 2

    def band_matrix(n: int) -> torch.Tensor:
        i = torch.arange(n, dtype=torch.float32, device=images.device)
        d = i[:, None] - i[None, :]
        w = torch.exp(-(d[None] ** 2) / (2.0 * sigma[:, None, None] ** 2))
        w = torch.where(torch.abs(d)[None] <= half, w, torch.zeros_like(w))
        return w / w.sum(dim=-1, keepdim=True)

    Kh = band_matrix(H).to(torch.bfloat16)
    Kw = band_matrix(W).to(torch.bfloat16)
    img16 = images.to(torch.bfloat16)
    blurred = torch.einsum("bij,bjwc->biwc", Kh, img16)
    blurred = torch.einsum("biwc,bxw->bixc", blurred, Kw).to(images.dtype)
    return torch.where(apply[:, None, None, None], blurred, images)


def gaussian_blur(generator: torch.Generator, images: torch.Tensor,
                  prob: float, sigma_range: Tuple[float, float] = (0.1, 2.0),
                  kernel_size: int = 9) -> torch.Tensor:
    if prob <= 0:
        return images
    B = images.shape[0]
    sigma = _uniform(generator, (B,), sigma_range[0], sigma_range[1])
    apply = _uniform(generator, (B,)) < prob
    return gaussian_blur_with(images, apply, sigma, kernel_size)


def solarize_with(images: torch.Tensor, apply: torch.Tensor,
                  threshold: float = 0.5) -> torch.Tensor:
    solarized = torch.where(images >= threshold, 1.0 - images, images)
    return torch.where(apply[:, None, None, None], solarized, images)


def random_solarize(generator: torch.Generator, images: torch.Tensor,
                    prob: float, threshold: float = 0.5) -> torch.Tensor:
    if prob <= 0:
        return images
    apply = _uniform(generator, (images.shape[0],)) < prob
    return solarize_with(images, apply, threshold)


def view_config_with_overrides(cfg: ViewAugmentConfig,
                               args: dict) -> ViewAugmentConfig:
    """Apply the reference's ``transform_args`` keys to a view config.

    The keys of ``MethodTransformArgs``: image_size, random_resize,
    random_flip, color_jitter, random_gray_scale, gaussian_blur, solarize,
    random_rotation, normalize, and channel_drop set to None. A key set to
    None turns its op off. Channel drop acts only on images of more than 3
    channels, which need ``LIGHTLY_TRAIN_IMAGE_MODE=UNCHANGED``: both wait
    for ROADMAP item 19.
    """
    if args.get("channel_drop") is not None:
        raise NotImplementedError(
            f"transform_args channel_drop={args['channel_drop']!r} is not "
            "ported yet: it acts on images of more than 3 channels, which "
            "need LIGHTLY_TRAIN_IMAGE_MODE=UNCHANGED (ROADMAP item 19).")
    u: dict = {}
    if "image_size" in args:
        s = args["image_size"]
        u["out_size"] = (s, s) if isinstance(s, int) else tuple(s)
    if "random_resize" in args:
        rr = args["random_resize"]
        u["crop_scale"] = (1.0, 1.0) if rr is None else (
            rr.get("min_scale", cfg.crop_scale[0]),
            rr.get("max_scale", cfg.crop_scale[1]))
    if "random_flip" in args:
        rf = args["random_flip"]
        u["hflip_prob"] = 0.0 if rf is None else rf.get("horizontal_prob", 0.5)
        u["vflip_prob"] = 0.0 if rf is None else rf.get("vertical_prob", 0.0)
    if "color_jitter" in args:
        cj = args["color_jitter"]
        if cj is None:
            u["cj_prob"] = 0.0
        else:
            u["cj_prob"] = cj.get("prob", cfg.cj_prob)
            u["cj_strength"] = cj.get("strength", cfg.cj_strength)
            u["cj_bright"] = cj.get("brightness", cfg.cj_bright)
            u["cj_contrast"] = cj.get("contrast", cfg.cj_contrast)
            u["cj_sat"] = cj.get("saturation", cfg.cj_sat)
            u["cj_hue"] = cj.get("hue", cfg.cj_hue)
    if "random_gray_scale" in args:
        g = args["random_gray_scale"]
        u["gray_prob"] = 0.0 if g is None else float(g)
    if "gaussian_blur" in args:
        gb = args["gaussian_blur"]
        if gb is None:
            u["blur_prob"] = 0.0
        else:
            u["blur_prob"] = gb.get("prob", cfg.blur_prob)
            if "sigmas" in gb:
                u["blur_sigma"] = tuple(gb["sigmas"])
    if "solarize" in args:
        so = args["solarize"]
        if so is None:
            u["solarize_prob"] = 0.0
        else:
            u["solarize_prob"] = so.get("prob", cfg.solarize_prob)
            u["solarize_threshold"] = so.get("threshold",
                                             cfg.solarize_threshold)
    if "random_rotation" in args:
        rot = args["random_rotation"]
        if rot is None:
            u["rotation_prob"] = 0.0
        else:
            u["rotation_prob"] = rot.get("prob", 1.0)
            deg = rot.get("degrees", 0.0)
            u["rotation_degrees"] = float(
                deg if not isinstance(deg, (tuple, list))
                else max(abs(deg[0]), abs(deg[1])))
    if args.get("normalize") is not None:
        u["mean"] = tuple(args["normalize"]["mean"])
        u["std"] = tuple(args["normalize"]["std"])
    return dataclasses.replace(cfg, **u)


def override_view_specs(specs: list, transform_args: Optional[dict]) -> list:
    """Apply ``transform_args`` to a method's view specs: top-level keys to
    every view, a ``global_view`` / ``local_view`` sub-dict only to the
    largest-resolution views / the rest."""
    if not transform_args:
        return specs
    common = {k: v for k, v in transform_args.items()
              if k not in ("global_view", "local_view")}
    max_size = max(s.config.out_size[0] for s in specs)
    out = []
    for s in specs:
        cfg = view_config_with_overrides(s.config, common)
        group = ("global_view" if s.config.out_size[0] == max_size
                 else "local_view")
        if transform_args.get(group):
            cfg = view_config_with_overrides(cfg, transform_args[group])
        out.append(dataclasses.replace(s, config=cfg))
    return out


def normalize(images: torch.Tensor, mean: Sequence[float] = IMAGENET_MEAN,
              std: Sequence[float] = IMAGENET_STD) -> torch.Tensor:
    m = torch.tensor(mean, dtype=images.dtype, device=images.device)
    s = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - m) / s


# ---------------------------------------------------------------------------
# one view
# ---------------------------------------------------------------------------


def sample_view_params(generator: torch.Generator, batch: int,
                       in_hw: Tuple[int, int],
                       cfg: ViewAugmentConfig) -> Params:
    """Every random choice of one view, keyed like the ``*_with`` inputs."""
    y0, x0, h, w = _sample_crop_boxes(generator, batch, in_hw, cfg.crop_scale,
                                      cfg.crop_ratio)
    out: Params = {"y0": y0, "x0": x0, "h": h, "w": w}
    out["hflip"] = (_uniform(generator, (batch,)) < cfg.hflip_prob
                    if cfg.hflip_prob > 0
                    else torch.zeros(batch, dtype=torch.bool,
                                     device=generator.device))
    if cfg.vflip_prob > 0:
        out["vflip"] = _uniform(generator, (batch,)) < cfg.vflip_prob
    if cfg.cj_prob > 0:
        cj = sample_color_jitter(
            generator, batch, cfg.cj_prob, cfg.cj_strength, cfg.cj_bright,
            cfg.cj_contrast, cfg.cj_sat, cfg.cj_hue)
        out.update({f"cj_{k}": v for k, v in cj.items()})
    if cfg.gray_prob > 0:
        out["gray"] = _uniform(generator, (batch,)) < cfg.gray_prob
    if cfg.blur_prob > 0:
        out["blur_sigma"] = _uniform(generator, (batch,), *cfg.blur_sigma)
        out["blur"] = _uniform(generator, (batch,)) < cfg.blur_prob
    if cfg.solarize_prob > 0:
        out["solarize"] = _uniform(generator, (batch,)) < cfg.solarize_prob
    if cfg.rotation_prob > 0 and cfg.rotation_degrees != 0.0:
        out.update(sample_rotation(generator, batch, cfg.rotation_prob,
                                   cfg.rotation_degrees))
    return out


def augment_view_with_params(
    images: torch.Tensor, cfg: ViewAugmentConfig, p: Params,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One view from sampled parameters: (view (B, oh, ow, 3) normalized in
    ``out_dtype``, geometry (B, 5) float32 ``[y0, x0, h, w, hflipped]``)."""
    out = crop_resize_matmul(images, p["y0"], p["x0"], p["h"], p["w"],
                             cfg.out_size, hflip=p["hflip"],
                             method=cfg.interpolation)
    if images.dtype == torch.uint8:
        out = out * (1.0 / 255.0)
    if "vflip" in p:
        out = flip_with(out, None, p["vflip"])
    geometry = torch.stack(
        [p["y0"], p["x0"], p["h"], p["w"], p["hflip"].float()], dim=1)
    if "rotate" in p:
        # After the flips, before the photometric ops; the geometry does
        # not record it (methods that read geometry refuse rotation).
        out = random_rotate_with(out, p["rotate"], p["rotate_angle"])
    if "cj_apply" in p:
        out = color_jitter_with(
            out, {k[3:]: v for k, v in p.items() if k.startswith("cj_")})
    if "gray" in p:
        out = grayscale_with(out, p["gray"])
    if "blur" in p:
        out = gaussian_blur_with(out, p["blur"], p["blur_sigma"],
                                 cfg.blur_kernel_size)
    if "solarize" in p:
        out = solarize_with(out, p["solarize"], cfg.solarize_threshold)
    out = normalize(out, cfg.mean, cfg.std)
    return out.to(out_dtype), geometry


def augment_view_with_geometry(
    generator: torch.Generator, images: torch.Tensor, cfg: ViewAugmentConfig,
    out_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full fused augmentation of one view of a uint8 (B, H, W, 3) batch."""
    params = sample_view_params(generator, images.shape[0],
                                (images.shape[1], images.shape[2]), cfg)
    return augment_view_with_params(images, cfg, params, out_dtype)
