"""ShuffleNetV2 backbone in PyTorch (torchvision family).

Port of ``lightly_train_tpu/models/shufflenet.py``: a 3x3 stride-2
convolution and a 3x3 stride-2 max pool (both Flax "SAME": an even map
pads only its end), 3 stages of ShuffleNetV2 units (channel split, or a
depthwise downsampling shortcut, then 1x1 -> depthwise 3x3 -> 1x1, concat,
channel shuffle), and a final 1x1 convolution. BatchNorm keeps its running
statistics as buffers (``models/conv.py``).

``channel_shuffle`` is defined on the JAX package's channels-last
``(B, H, W, g, C / g)`` split: output channel ``i g + j`` is input channel
``j C / g + i``, which the NCHW ``(B, g, C / g, H, W)`` transpose gives
too. Layer names are the Flax scopes.
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
class ShuffleNetV2Config:
    stage_repeats: Tuple[int, ...] = (4, 8, 4)
    stage_channels: Tuple[int, ...] = (116, 232, 464)
    out_channels: int = 1024
    dtype: torch.dtype = torch.float32


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """NCHW ``x`` with its channels in the JAX package's shuffled order."""
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2).reshape(
        B, C, H, W)


class _ShuffleUnit(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        branch = out_ch // 2
        if stride != 1:
            self.short_dw = Conv(in_ch, in_ch, 3, 2, groups=in_ch,
                                 bias=False, dtype=dtype)
            self.short_dw_bn = BatchNorm(in_ch, dtype)
            self.short_pw = Conv(in_ch, branch, 1, bias=False, dtype=dtype)
            self.short_pw_bn = BatchNorm(branch, dtype)
        h_in = in_ch if stride != 1 else in_ch // 2
        self.pw1 = Conv(h_in, branch, 1, bias=False, dtype=dtype)
        self.pw1_bn = BatchNorm(branch, dtype)
        self.dw = Conv(branch, branch, 3, stride, groups=branch, bias=False,
                       dtype=dtype)
        self.dw_bn = BatchNorm(branch, dtype)
        self.pw2 = Conv(branch, branch, 1, bias=False, dtype=dtype)
        self.pw2_bn = BatchNorm(branch, dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.stride == 1:
            shortcut, h = x.chunk(2, dim=1)
        else:
            shortcut = self.short_dw_bn(self.short_dw(x), train)
            shortcut = F.relu(self.short_pw_bn(self.short_pw(shortcut),
                                               train))
            h = x
        h = F.relu(self.pw1_bn(self.pw1(h), train))
        h = self.dw_bn(self.dw(h), train)
        h = F.relu(self.pw2_bn(self.pw2(h), train))
        return channel_shuffle(torch.cat([shortcut, h], dim=1))


class ShuffleNetV2(nn.Module):
    """``forward(images, train=False, generator=None)``: images (B, H, W,
    3); returns the JAX ShuffleNetV2's feature dict (its last stage
    feature is the final 1x1 convolution's output)."""

    def __init__(self, cfg: ShuffleNetV2Config):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        self.conv1 = Conv(3, 24, 3, 2, bias=False, dtype=dtype)
        self.conv1_bn = BatchNorm(24, dtype)
        in_ch = 24
        self.block_names = []
        for s, (reps, ch) in enumerate(zip(cfg.stage_repeats,
                                           cfg.stage_channels)):
            names = []
            for b in range(reps):
                name = f"stage{s}_block{b}"
                setattr(self, name, _ShuffleUnit(in_ch, ch, 2 if b == 0
                                                 else 1, dtype))
                in_ch = ch
                names.append(name)
            self.block_names.append(names)
        self.conv5 = Conv(in_ch, cfg.out_channels, 1, bias=False, dtype=dtype)
        self.conv5_bn = BatchNorm(cfg.out_channels, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        reset_cnn_parameters(self, generator)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, torch.Tensor]:
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv1_bn(self.conv1(x), train))
        x = max_pool(x, 3, 2, "SAME")
        stage_feats = []
        for names in self.block_names:
            for name in names:
                x = getattr(self, name)(x, train)
            stage_feats.append(x.permute(0, 2, 3, 1))
        x = F.relu(self.conv5_bn(self.conv5(x), train))
        features = x.permute(0, 2, 3, 1)
        stage_feats[-1] = features
        B, H, W, D = features.shape
        return {
            "features": features,
            "cls_token": features.mean(dim=(1, 2)),
            "patch_tokens": features.reshape(B, H * W, D),
            "stage_features": stage_feats,
        }


_SHUFFLENET_SIZES = {
    # torchvision shufflenet_v2_x* widths
    "shufflenet_v2_x0_5": ((4, 8, 4), (48, 96, 192), 1024),
    "shufflenet_v2_x1_0": ((4, 8, 4), (116, 232, 464), 1024),
    "shufflenet_v2_x1_5": ((4, 8, 4), (176, 352, 704), 1024),
    "shufflenet_v2_x2_0": ((4, 8, 4), (244, 488, 976), 2048),
    "shufflenettest": ((1, 1, 1), (8, 16, 32), 32),
}


def shufflenet_config(size: str, dtype: torch.dtype = torch.float32
                      ) -> ShuffleNetV2Config:
    if size not in _SHUFFLENET_SIZES:
        raise ValueError(
            f"Unknown ShuffleNet size '{size}'. "
            f"Options: {sorted(_SHUFFLENET_SIZES)}")
    reps, chans, out = _SHUFFLENET_SIZES[size]
    return ShuffleNetV2Config(stage_repeats=reps, stage_channels=chans,
                              out_channels=out, dtype=dtype)
