"""The YOLO-NAS backbone in PyTorch (the super_gradients family).

Port of ``lightly_train_tpu/models/yolo_nas.py``: a QARepVGG stem, four
stages of a QARepVGG stride-2 downsample and a CSP layer of QARepVGG
bottleneck pairs, and an SPP context module.

- ``QARepVGGBlock``: a biased 3x3 convolution plus a 1x1 one without bias,
  plus the identity at stride 1 with equal widths, then one BatchNorm of
  the sum and ReLU. The convolutions pad as Flax's "SAME", which at stride
  2 on an even map pads only the end (``conv.same_pads``).
- ``YoloNASBottleneck``: two blocks and a residual scaled by ``alpha``, a
  learnable 0-d parameter (created whether or not the widths allow the
  residual, as in the JAX module).
- ``SPP``: 1x1 conv-BN-SiLU, max pools of 5, 9 and 13 ("SAME", -inf
  padding), 1x1 conv-BN-SiLU of their concatenation.

Inputs and feature maps are channels-last (B, H, W, C); layer names are the
Flax scopes.
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
    max_pool,
    reset_cnn_parameters,
)


@dataclasses.dataclass(frozen=True)
class YoloNASConfig:
    stem_ch: int = 48
    stage_channels: Tuple[int, ...] = (96, 192, 384, 768)
    stage_depths: Tuple[int, ...] = (2, 3, 5, 2)
    hidden_ratio: float = 0.5
    dtype: torch.dtype = torch.float32


class QARepVGGBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv3 = Conv(in_ch, out_ch, 3, stride, "SAME", dtype=dtype)
        self.conv1 = Conv(in_ch, out_ch, 1, stride, "SAME", bias=False,
                          dtype=dtype)
        self.bn = BatchNorm(out_ch, dtype)
        self.identity = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = self.conv3(x) + self.conv1(x)
        if self.identity:
            h = h + x
        return F.relu(self.bn(h, train))


class YoloNASBottleneck(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype):
        super().__init__()
        self.cv1 = QARepVGGBlock(in_ch, out_ch, 1, dtype)
        self.cv2 = QARepVGGBlock(out_ch, out_ch, 1, dtype)
        self.alpha = nn.Parameter(torch.ones(()))
        self.residual = in_ch == out_ch

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = self.cv2(self.cv1(x, train), train)
        if self.residual:
            h = h + self.alpha.to(h.dtype) * x
        return h


def _add_conv_bn(parent: nn.Module, name: str, in_ch: int, out_ch: int,
                 dtype: torch.dtype) -> None:
    """The ``{name}_conv`` / ``{name}_bn`` pair of the CSP layer and the
    SPP, flat in ``parent``'s scope: a 1x1 "SAME" convolution without
    bias and BatchNorm."""
    setattr(parent, f"{name}_conv", Conv(in_ch, out_ch, 1, 1, "SAME",
                                         bias=False, dtype=dtype))
    setattr(parent, f"{name}_bn", BatchNorm(out_ch, dtype))


def _conv_bn_silu(parent: nn.Module, name: str, x: torch.Tensor,
                  train: bool) -> torch.Tensor:
    x = getattr(parent, f"{name}_conv")(x)
    return F.silu(getattr(parent, f"{name}_bn")(x, train))


class YoloNASCSPLayer(nn.Module):
    """CSP split -> n bottlenecks on one branch -> concat -> 1x1 merge."""

    def __init__(self, in_ch: int, out_ch: int, n: int, hidden_ratio: float,
                 dtype: torch.dtype):
        super().__init__()
        c = int(out_ch * hidden_ratio)
        _add_conv_bn(self, "cv1", in_ch, c, dtype)
        _add_conv_bn(self, "cv2", in_ch, c, dtype)
        for i in range(n):
            setattr(self, f"m{i}", YoloNASBottleneck(c, c, dtype))
        self.n = n
        _add_conv_bn(self, "cv3", 2 * c, out_ch, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        main = _conv_bn_silu(self, "cv1", x, train)
        short = _conv_bn_silu(self, "cv2", x, train)
        for i in range(self.n):
            main = getattr(self, f"m{i}")(main, train)
        return _conv_bn_silu(self, "cv3", torch.cat([main, short], dim=1),
                             train)


class SPP(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype,
                 pools: Tuple[int, ...] = (5, 9, 13)):
        super().__init__()
        c = in_ch // 2
        _add_conv_bn(self, "cv1", in_ch, c, dtype)
        _add_conv_bn(self, "cv2", c * (1 + len(pools)), out_ch, dtype)
        self.pools = pools

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = _conv_bn_silu(self, "cv1", x, train)
        outs = [h] + [max_pool(h, k, 1, "SAME") for k in self.pools]
        return _conv_bn_silu(self, "cv2", torch.cat(outs, dim=1), train)


class YoloNASBackbone(nn.Module):
    """Stem + 4 stages (QARepVGG downsample + CSP layer) + SPP context;
    ``stage_features`` are the last three stages' outputs, the last after
    the SPP."""

    def __init__(self, cfg: YoloNASConfig):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        self.stem = QARepVGGBlock(3, cfg.stem_ch, 2, dtype)
        in_ch = cfg.stem_ch
        for i, (ch, n) in enumerate(zip(cfg.stage_channels,
                                        cfg.stage_depths)):
            setattr(self, f"stage{i}_down",
                    QARepVGGBlock(in_ch, ch, 2, dtype))
            setattr(self, f"stage{i}_csp",
                    YoloNASCSPLayer(ch, ch, n, cfg.hidden_ratio, dtype))
            in_ch = ch
        self.context = SPP(in_ch, cfg.stage_channels[-1], dtype)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Flax's initializers; every ``alpha`` at 1."""
        reset_cnn_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, YoloNASBottleneck):
                m.alpha.data.fill_(1.0)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)
        x = self.stem(x, train)
        stages = []
        for i in range(len(self.cfg.stage_channels)):
            x = getattr(self, f"stage{i}_down")(x, train)
            x = getattr(self, f"stage{i}_csp")(x, train)
            stages.append(x)
        stages[-1] = x = self.context(x, train)
        features = x.permute(0, 2, 3, 1)
        B, H, W, D = features.shape
        return {
            "features": features,
            "cls_token": features.mean(dim=(1, 2)),
            "patch_tokens": features.reshape(B, H * W, D),
            "stage_features": [s.permute(0, 2, 3, 1) for s in stages[-3:]],
        }


_YOLO_NAS_SIZES = {
    # super_gradients scales: depth and width grow S -> L.
    "yolo_nas_s": ((96, 192, 384, 768), (2, 3, 5, 2), 0.5),
    "yolo_nas_m": ((96, 192, 384, 768), (3, 4, 6, 3), 0.75),
    "yolo_nas_l": ((96, 192, 384, 768), (4, 5, 7, 4), 1.0),
    "yolo_nas_test": ((8, 16, 24, 32), (1, 1, 1, 1), 0.5),
}


def yolo_nas_config(name: str, dtype: torch.dtype = torch.float32
                    ) -> YoloNASConfig:
    if name not in _YOLO_NAS_SIZES:
        raise ValueError(f"Unknown YOLO-NAS size '{name}'. "
                         f"Options: {sorted(_YOLO_NAS_SIZES)}")
    chans, depths, ratio = _YOLO_NAS_SIZES[name]
    return YoloNASConfig(stem_ch=max(chans[0] // 2, 8),
                         stage_channels=chans, stage_depths=depths,
                         hidden_ratio=ratio, dtype=dtype)
