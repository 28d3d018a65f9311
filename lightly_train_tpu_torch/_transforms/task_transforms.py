"""Per-task training transform schemas and the on-device pipeline.

Port of ``lightly_train_tpu/_transforms/task_transforms.py``. Each
``train_*`` entry point takes a typed ``transform_args`` schema with "auto"
fields and the JAX package's resolution rules, and each task family has
the reference's default recipe:

- semantic, instance and panoptic segmentation (EoMT, linear and
  multihead): scale jitter (0.5-2.0, 20 scales) -> random crop
  (``image_size``, centre padding, masks filled with ``ignore_index``, the
  slot-id map with ``NO_SEGMENT``) -> horizontal flip (0.5) -> colour
  jitter (p 0.5) -> normalize;
- image classification (and multihead): RandomResizedCrop (area 0.2-1.0)
  -> horizontal flip (0.5) -> colour jitter -> normalize.

The pipeline runs on the device over the staged uint8 batch: the geometric
chain is one crop box per sample (``ops/task_augs.py``), the colour jitter
the composed 3x3 matrix of ``ops/augment.py``. :class:`TrainTransform`
splits it into :meth:`TrainTransform.sample`, which draws every random
parameter from a ``torch.Generator``, and :meth:`TrainTransform.apply`,
which applies given parameters, so that a test can hand it the JAX
package's draws. ``channel_drop`` acts only on images of more than 3
channels and is refused, as ``pretrain`` refuses it (ROADMAP item 19).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from lightly_train_tpu_torch._configs.config import Auto, Config
from lightly_train_tpu_torch._configs.validate import config_validate
from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch.errors import ConfigValidationError
from lightly_train_tpu_torch.ops import augment as A
from lightly_train_tpu_torch.ops import task_augs as T

logger = get_logger("transforms")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# Component args
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NormalizeArgs(Config):
    mean: Tuple[float, ...] = IMAGENET_MEAN
    std: Tuple[float, ...] = IMAGENET_STD


@dataclasses.dataclass
class RandomFlipArgs(Config):
    horizontal_prob: float = 0.5
    vertical_prob: float = 0.0


@dataclasses.dataclass
class RandomRotate90Args(Config):
    prob: float = 0.5


@dataclasses.dataclass
class RandomRotationArgs(Config):
    prob: float = 0.5
    degrees: float = 30.0


@dataclasses.dataclass
class ColorJitterArgs(Config):
    """All-or-none with ``prob``, as the reference's task jitter."""

    prob: float = 0.5
    strength: float = 1.0
    brightness: float = 32.0 / 255.0
    contrast: float = 0.5
    saturation: float = 0.5
    hue: float = 18.0 / 360.0


@dataclasses.dataclass
class ChannelDropArgs(Config):
    num_channels_keep: int = 3
    weight_drop: Tuple[float, ...] = (1.0, 1.0, 1.0)


@dataclasses.dataclass
class ScaleJitterArgs(Config):
    min_scale: float = 0.5
    max_scale: float = 2.0
    num_scales: int = 20
    prob: float = 1.0


@dataclasses.dataclass
class RandomCropArgs(Config):
    height: Union[int, Auto] = "auto"
    width: Union[int, Auto] = "auto"
    pad_if_needed: bool = True
    fill: int = 0
    prob: float = 1.0


@dataclasses.dataclass
class RandomResizeArgs(Config):
    """Classification RandomResizedCrop area-scale range."""

    min_scale: float = 0.2
    max_scale: float = 1.0


@dataclasses.dataclass
class SmallestMaxSizeArgs(Config):
    max_size: Union[int, Auto] = "auto"
    prob: float = 1.0


# ---------------------------------------------------------------------------
# Task schemas
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TaskTransformArgs(Config):
    """Base schema."""

    image_size: Union[Tuple[int, int], Auto] = "auto"
    channel_drop: Optional[ChannelDropArgs] = None
    num_channels: Union[int, Auto] = "auto"
    normalize: Union[NormalizeArgs, Auto] = "auto"
    random_flip: Optional[RandomFlipArgs] = dataclasses.field(
        default_factory=RandomFlipArgs)
    random_rotate_90: Optional[RandomRotate90Args] = None
    random_rotate: Optional[RandomRotationArgs] = None
    color_jitter: Optional[ColorJitterArgs] = dataclasses.field(
        default_factory=ColorJitterArgs)

    def resolve_auto(self, image_size: Tuple[int, int]) -> None:
        if self.image_size == "auto":
            self.image_size = tuple(image_size)
        if self.normalize == "auto":
            self.normalize = NormalizeArgs()
        if self.num_channels == "auto":
            if self.channel_drop is not None:
                self.num_channels = self.channel_drop.num_channels_keep
            else:
                self.num_channels = len(self.normalize.mean)

    def resolve_incompatible(self) -> None:
        """Repeat mean and std to ``num_channels``; colour jitter off
        unless there are 3 channels."""
        nc = self.num_channels
        mean, std = self.normalize.mean, self.normalize.std
        if len(mean) != nc:
            self.normalize.mean = tuple(mean[i % len(mean)] for i in range(nc))
        if len(std) != nc:
            self.normalize.std = tuple(std[i % len(std)] for i in range(nc))
        if self.color_jitter is not None and nc != 3:
            logger.debug(
                "Disabling color jitter: needs 3 channels, have %d", nc)
            self.color_jitter = None

    def model_dump(self) -> Dict[str, Any]:
        """The resolved schema as nested dicts (pydantic's name)."""
        return self.dump()


@dataclasses.dataclass
class SemanticSegmentationTransformArgs(TaskTransformArgs):
    """The segmentation train recipe."""

    ignore_index: int = 255
    scale_jitter: Optional[ScaleJitterArgs] = dataclasses.field(
        default_factory=ScaleJitterArgs)
    smallest_max_size: Optional[SmallestMaxSizeArgs] = None
    random_crop: Optional[RandomCropArgs] = dataclasses.field(
        default_factory=RandomCropArgs)

    def resolve_auto(self, image_size: Tuple[int, int]) -> None:
        super().resolve_auto(image_size)
        if self.random_crop is not None:
            if self.random_crop.height == "auto":
                self.random_crop.height = self.image_size[0]
            if self.random_crop.width == "auto":
                self.random_crop.width = self.image_size[1]
            if (self.random_crop.height, self.random_crop.width) != tuple(
                    self.image_size):
                raise ConfigValidationError(
                    "random_crop.height/width must equal image_size "
                    f"({tuple(self.image_size)}): the crop IS the model "
                    "input here. Set image_size= on the train_* call to "
                    "change the training resolution."
                )
        if (self.smallest_max_size is not None
                and self.smallest_max_size.max_size == "auto"):
            self.smallest_max_size.max_size = min(self.image_size)


@dataclasses.dataclass
class ImageClassificationTransformArgs(TaskTransformArgs):
    """The classification train recipe."""

    random_crop: Optional[RandomResizeArgs] = dataclasses.field(
        default_factory=RandomResizeArgs)
    resize_scale: Optional[float] = None


TASK_TRANSFORM_ARGS: Dict[str, type] = {
    "semantic_segmentation": SemanticSegmentationTransformArgs,
    "instance_segmentation": SemanticSegmentationTransformArgs,
    "panoptic_segmentation": SemanticSegmentationTransformArgs,
    "image_classification": ImageClassificationTransformArgs,
}


def resolve_task_transform_args(
    kind: str,
    user_args: Optional[Dict[str, Any]],
    image_size: Tuple[int, int],
    hflip_prob: Optional[float] = None,
) -> TaskTransformArgs:
    """Validate user overrides onto the task's default schema and resolve.
    ``hflip_prob`` (the legacy scalar knob) overrides
    ``random_flip.horizontal_prob`` where the user does not set
    ``random_flip``. ``channel_drop`` is refused (ROADMAP item 19)."""
    args = config_validate(TASK_TRANSFORM_ARGS[kind], dict(user_args or {}))
    if args.channel_drop is not None:
        raise NotImplementedError(
            f"transform_args channel_drop={args.channel_drop!r} is not "
            "ported yet: it acts on images of more than 3 channels, which "
            "need LIGHTLY_TRAIN_IMAGE_MODE=UNCHANGED (ROADMAP item 19).")
    if hflip_prob is not None and "random_flip" not in (user_args or {}):
        args.random_flip = (None if hflip_prob <= 0
                            else RandomFlipArgs(horizontal_prob=hflip_prob))
    args.resolve_auto(image_size)
    args.resolve_incompatible()
    return args


# ---------------------------------------------------------------------------
# On-device pipeline
# ---------------------------------------------------------------------------

# Spatial integer id-map batch keys: ``masks`` (filled with ignore_index
# outside the image) and the instance and panoptic slot-id map ``seg_map``
# (filled with NO_SEGMENT).
_MAP_KEYS = ("masks", "seg_map")
# ``tasks/eomt_instance_panoptic.py``'s NO_SEGMENT.
NO_SEGMENT = 255

Params = Dict[str, Any]


def ids_present(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) flags of the ids below ``n`` present in each (H, W) map of
    non-negative ids (``n`` and above: none), counted without a one-hot
    map."""
    B = ids.shape[0]
    idx = ids.long().clamp(max=n) + (n + 1) * torch.arange(
        B, device=ids.device)[:, None, None]
    counts = torch.bincount(idx.reshape(-1), minlength=B * (n + 1))
    return counts.reshape(B, n + 1)[:, :n] > 0


class TrainTransform:
    """The resolved schema as ``fn(batch, generator) -> batch``, in the
    reference's order: the geometric chain (scale jitter and random crop,
    smallest-max-size and random crop, or RandomResizedCrop, with the flips
    folded into the sampling coordinates) -> rotate90 -> rotate -> colour
    jitter -> normalize. Images come in as (B, H, W, C) uint8 and leave
    normalized in ``dtype``; ``masks`` and ``seg_map`` follow the
    geometry, nearest, with ``ignore_index`` and ``NO_SEGMENT`` fills, and
    a crop drops from ``seg_valid`` every slot it removed."""

    def __init__(self, args: TaskTransformArgs, dtype: torch.dtype):
        self.args = args
        self.dtype = dtype
        self.out_hw = tuple(args.image_size)
        self.classification = isinstance(args, ImageClassificationTransformArgs)
        self.scale_jitter = getattr(args, "scale_jitter", None)
        self.random_crop = getattr(args, "random_crop", None)
        self.smallest = getattr(args, "smallest_max_size", None)
        if self.smallest is not None and self.scale_jitter is not None:
            logger.info(
                "smallest_max_size set: it replaces scale_jitter in the "
                "geometric chain (set scale_jitter=None to silence this)")

    def sample(self, generator: torch.Generator, batch: int,
               in_hw: Tuple[int, int]) -> Params:
        """Every random parameter of one batch's transform."""
        a = self.args
        H, W = in_hw
        u = lambda: A._uniform(generator, (batch,))  # noqa: E731
        p: Params = {"hflip": None, "vflip": None, "boxes": None,
                     "rot90": None, "rotate": None, "jitter": None}
        flip = a.random_flip
        if flip is not None:
            if flip.horizontal_prob > 0:
                p["hflip"] = u() < flip.horizontal_prob
            if flip.vertical_prob > 0:
                p["vflip"] = u() < flip.vertical_prob
        crop = self.random_crop
        if self.classification:
            if crop is not None:
                p["boxes"] = T.sample_random_resized_crop(
                    generator, batch, in_hw, crop.min_scale, crop.max_scale)
        elif self.smallest is not None:
            applied, u_y, u_x = u() < self.smallest.prob, u(), u()
            skip = (u() >= crop.prob
                    if crop is not None and crop.prob < 1.0 else None)
            p["boxes"] = self._smallest_boxes(applied, u_y, u_x, skip, H, W)
        elif self.scale_jitter is not None or crop is not None:
            sj = self.scale_jitter or ScaleJitterArgs(
                min_scale=1.0, max_scale=1.0, num_scales=1, prob=0.0)
            p["boxes"] = T.sample_scale_jitter_crop(
                generator, batch, in_hw, self.out_hw, sj.min_scale,
                sj.max_scale, sj.num_scales, sj.prob,
                crop_prob=crop.prob if crop else 1.0,
                pad_if_needed=crop.pad_if_needed if crop else True)
        if a.random_rotate_90 is not None and a.random_rotate_90.prob > 0:
            p["rot90"] = T.sample_rot90(generator, batch,
                                        a.random_rotate_90.prob)
        if a.random_rotate is not None and a.random_rotate.prob > 0 \
                and a.random_rotate.degrees != 0.0:
            p["rotate"] = A.sample_rotation(generator, batch,
                                            a.random_rotate.prob,
                                            a.random_rotate.degrees)
        cj = a.color_jitter
        if cj is not None:
            p["jitter"] = A.sample_color_jitter(
                generator, batch, prob=cj.prob, strength=cj.strength,
                brightness=cj.brightness, contrast=cj.contrast,
                saturation=cj.saturation, hue=cj.hue)
        return p

    def _smallest_boxes(self, applied, u_y, u_x, skip, H: int, W: int):
        """SmallestMaxSize(max_size) + RandomCrop as a box: the window
        ``out_hw / f`` in staged pixels (f = max_size / min(H, W)) where the
        resize fires, else ``out_hw``; uniform offsets, centre padding where
        the window exceeds the image; ``skip`` keeps the whole image."""
        crop = self.random_crop
        f = float(self.smallest.max_size) / float(min(H, W))
        oh, ow = self.out_hw
        h = torch.where(applied, torch.full_like(u_y, oh / f),
                        torch.full_like(u_y, float(oh)))
        w = torch.where(applied, torch.full_like(u_x, ow / f),
                        torch.full_like(u_x, float(ow)))
        if crop is not None and not crop.pad_if_needed:
            h = torch.clamp(h, max=float(H))
            w = torch.clamp(w, max=float(W))
        y0 = torch.where(h <= H, u_y * (H - h), -(h - H) / 2.0)
        x0 = torch.where(w <= W, u_x * (W - w), -(w - W) / 2.0)
        if skip is not None:
            y0 = torch.where(skip, torch.zeros_like(y0), y0)
            x0 = torch.where(skip, torch.zeros_like(x0), x0)
            h = torch.where(skip, torch.full_like(h, float(H)), h)
            w = torch.where(skip, torch.full_like(w, float(W)), w)
        return y0, x0, h, w

    def _fixed_boxes(self, batch: int, H: int, W: int, device):
        """Classification without ``random_crop`` but with
        ``resize_scale``: a centred window of size / scale."""
        s = float(self.args.resize_scale)
        ch = torch.full((batch,), H / s, device=device)
        cw = torch.full((batch,), W / s, device=device)
        return (H - ch) / 2.0, (W - cw) / 2.0, ch, cw

    def apply(self, batch: Dict[str, torch.Tensor],
              p: Params) -> Dict[str, torch.Tensor]:
        """The transform of ``batch`` with the parameters ``p``."""
        a = self.args
        out = dict(batch)
        images = batch["images"].float() / 255.0
        B, H, W = images.shape[:3]
        hflip, vflip = p["hflip"], p["vflip"]
        boxes = p["boxes"]
        fill = 0.0
        if self.classification:
            if boxes is None and self.random_crop is None \
                    and a.resize_scale is not None:
                boxes = self._fixed_boxes(B, H, W, images.device)
        elif boxes is not None and self.random_crop is not None:
            fill = float(self.random_crop.fill) / 255.0
        map_keys = [k for k in _MAP_KEYS if k in batch]
        ignore = getattr(a, "ignore_index", 255)
        if boxes is not None:
            y0, x0, h, w = boxes
            images = T.padded_crop_resize(images, y0, x0, h, w, self.out_hw,
                                          fill=fill, hflip=hflip, vflip=vflip)
            for k in map_keys:
                out[k] = T.padded_crop_resize_nearest(
                    batch[k], y0, x0, h, w, self.out_hw,
                    fill=NO_SEGMENT if k == "seg_map" else ignore,
                    hflip=hflip, vflip=vflip)
            if "seg_map" in batch and "seg_valid" in batch:
                # A slot the crop removed whole is no target any more.
                out["seg_valid"] = batch["seg_valid"] & ids_present(
                    out["seg_map"], batch["seg_valid"].shape[1])
        else:
            # No crop: the flips are explicit reversals, joint with maps.
            for do, axis in ((hflip, 2), (vflip, 1)):
                if do is None:
                    continue
                images = torch.where(do[:, None, None, None],
                                     images.flip(axis), images)
                for k in map_keys:
                    out[k] = torch.where(do[:, None, None],
                                         out[k].flip(axis), out[k])
        if p["rot90"] is not None:
            images, rotated = T.rot90_with(
                images, p["rot90"], [out[k] for k in map_keys] or None)
            for k, r in zip(map_keys, rotated or []):
                out[k] = r
        if p["rotate"] is not None:
            apply, angle = p["rotate"]["rotate"], p["rotate"]["rotate_angle"]
            maps = [out[k] for k in map_keys]
            images = A.random_rotate_with(images, apply, angle)
            for k, r in zip(map_keys, T.rotate_maps_with(maps, apply, angle)
                            if maps else []):
                out[k] = r
        if p["jitter"] is not None:
            images = A.color_jitter_with(images, p["jitter"])
        mean = torch.tensor(a.normalize.mean, dtype=torch.float32,
                            device=images.device)
        std = torch.tensor(a.normalize.std, dtype=torch.float32,
                           device=images.device)
        out["images"] = ((images - mean) / std).to(self.dtype)
        return out

    def __call__(self, batch: Dict[str, torch.Tensor],
                 generator: torch.Generator) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        return self.apply(batch, self.sample(generator, images.shape[0],
                                             tuple(images.shape[1:3])))


def build_train_transform(args: TaskTransformArgs,
                          dtype: torch.dtype) -> TrainTransform:
    """The resolved schema as a :class:`TrainTransform`."""
    return TrainTransform(args, dtype)
