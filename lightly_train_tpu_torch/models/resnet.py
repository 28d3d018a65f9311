"""ResNet backbone in PyTorch (torchvision family, and RT-DETR's "vd").

Port of ``lightly_train_tpu/models/resnet.py``: ResNet-18/34 basic blocks
and ResNet-50/101 bottlenecks; the "vd" variant (RT-DETR's PResNet) with a
deep stem of three 3x3 convolutions and average-pool shortcuts. BatchNorm
keeps its running statistics as buffers (``models/conv.py``), updated by
every train-mode forward.

Inputs are channels-last (B, H, W, 3), as in the JAX package; the
convolutions run on NCHW views of channels-last memory. The output dict is
the JAX one: ``features`` (B, H/32, W/32, D), ``cls_token`` (the global
average pool), ``patch_tokens`` (B, H W / 1024, D) and ``stage_features``
(each stage's (B, h, w, C)). Layer names are the Flax scopes, so
``from_jax.params_from_jax`` carries a JAX tree over as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.models.conv import (
    BatchNorm,
    Conv,
    avg_pool,
    max_pool,
    reset_cnn_parameters,
)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    bottleneck: bool = False
    width: int = 64
    dtype: torch.dtype = torch.float32
    # ResNet-D / "vd" (RT-DETR's PResNet): 3x conv3x3 deep stem and
    # avgpool + conv1x1 downsample shortcuts.
    deep_stem: bool = False


class _Block(nn.Module):
    """A basic block (two 3x3 convolutions) or a bottleneck (1x1, 3x3,
    1x1 x4), with a projection shortcut where the shape changes."""

    def __init__(self, in_ch: int, filters: int, stride: int,
                 bottleneck: bool, vd: bool, dtype: torch.dtype):
        super().__init__()
        self.stride, self.vd, self.bottleneck = stride, vd, bottleneck
        pad1 = ((1, 1), (1, 1))  # the stride-2 3x3 pads as torch does
        if bottleneck:
            out_ch = 4 * filters
            self.conv1 = Conv(in_ch, filters, 1, bias=False, dtype=dtype)
            self.conv2 = Conv(filters, filters, 3, stride, pad1, bias=False,
                              dtype=dtype)
            self.conv3 = Conv(filters, out_ch, 1, bias=False, dtype=dtype)
            self.bn3 = BatchNorm(out_ch, dtype)
        else:
            out_ch = filters
            self.conv1 = Conv(in_ch, filters, 3, stride, pad1, bias=False,
                              dtype=dtype)
            self.conv2 = Conv(filters, filters, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(filters, dtype)
        self.bn2 = BatchNorm(filters, dtype)
        self.has_down = in_ch != out_ch or stride != 1
        if self.has_down:
            down_stride = 1 if vd and stride != 1 else stride
            self.down_conv = Conv(in_ch, out_ch, 1, down_stride, bias=False,
                                  dtype=dtype)
            self.down_bn = BatchNorm(out_ch, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x), train))
        if self.bottleneck:
            h = F.relu(self.bn2(self.conv2(h), train))
            h = self.bn3(self.conv3(h), train)
        else:
            h = self.bn2(self.conv2(h), train)
        if self.has_down:
            if self.vd and self.stride != 1:
                x = avg_pool(x, 2, 2, "SAME")
            x = self.down_bn(self.down_conv(x), train)
        return F.relu(x + h)


class ResNet(nn.Module):
    """``forward(images, train=False, generator=None)``: images (B, H, W,
    3); returns the JAX ResNet's feature dict."""

    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        pad1 = ((1, 1), (1, 1))
        if cfg.deep_stem:
            chans = (3, cfg.width // 2, cfg.width // 2, cfg.width)
            for i in range(3):
                setattr(self, f"stem_conv{i + 1}", Conv(
                    chans[i], chans[i + 1], 3, 2 if i == 0 else 1, pad1,
                    bias=False, dtype=dtype))
                setattr(self, f"stem_bn{i + 1}",
                        BatchNorm(chans[i + 1], dtype))
        else:
            self.stem_conv = Conv(3, cfg.width, 7, 2, ((3, 3), (3, 3)),
                                  bias=False, dtype=dtype)
            self.stem_bn = BatchNorm(cfg.width, dtype)
        in_ch = cfg.width
        self.block_names = []
        for stage, n_blocks in enumerate(cfg.stage_sizes):
            filters = cfg.width * 2 ** stage
            names = []
            for b in range(n_blocks):
                name = f"stage{stage}_block{b}"
                stride = 2 if (b == 0 and stage > 0) else 1
                setattr(self, name, _Block(in_ch, filters, stride,
                                           cfg.bottleneck, cfg.deep_stem,
                                           dtype))
                in_ch = filters * (4 if cfg.bottleneck else 1)
                names.append(name)
            self.block_names.append(names)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        reset_cnn_parameters(self, generator)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)
        if cfg.deep_stem:
            for i in range(1, 4):
                x = getattr(self, f"stem_conv{i}")(x)
                x = F.relu(getattr(self, f"stem_bn{i}")(x, train))
        else:
            x = F.relu(self.stem_bn(self.stem_conv(x), train))
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        stage_feats = []
        for names in self.block_names:
            for name in names:
                x = getattr(self, name)(x, train)
            stage_feats.append(x.permute(0, 2, 3, 1))
        features = x.permute(0, 2, 3, 1)
        B, H, W, D = features.shape
        return {
            "features": features,
            "cls_token": features.mean(dim=(1, 2)),
            "patch_tokens": features.reshape(B, H * W, D),
            "stage_features": stage_feats,
        }


_RESNET_SIZES = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnettest": ((1, 1, 1, 1), False),
    # RT-DETR PResNet "vd" variants (rtdetr package).
    "resnet18vd": ((2, 2, 2, 2), False),
    "resnet34vd": ((3, 4, 6, 3), False),
    "resnet50vd": ((3, 4, 6, 3), True),
    "resnet101vd": ((3, 4, 23, 3), True),
    "resnettestvd": ((1, 1, 1, 1), False),
}


def resnet_config(name: str, dtype: torch.dtype = torch.float32
                  ) -> ResNetConfig:
    if name not in _RESNET_SIZES:
        raise ValueError(
            f"Unknown ResNet '{name}'. Options: {sorted(_RESNET_SIZES)}")
    stages, bottleneck = _RESNET_SIZES[name]
    width = 8 if name.startswith("resnettest") else 64
    return ResNetConfig(stage_sizes=stages, bottleneck=bottleneck,
                        width=width, dtype=dtype,
                        deep_stem=name.endswith("vd"))


def resnet_feature_dim(name: str) -> int:
    stages, bottleneck = _RESNET_SIZES[name]
    width = 8 if name.startswith("resnettest") else 64
    dim = width * 2 ** (len(stages) - 1)
    return dim * 4 if bottleneck else dim
