"""ConvNeXt backbone in PyTorch (the DINOv3 ConvNeXt family).

Port of ``lightly_train_tpu/models/convnext.py``: a 4x4 stride-4 "VALID"
stem and LayerNorm, then 4 stages (LayerNorm and a 2x2 stride-2
convolution between them) of blocks: depthwise 7x7 convolution (padding
3) -> LayerNorm -> Linear x4 -> exact GELU -> Linear -> LayerScale
(initialised at 1e-6) -> stochastic depth -> residual. Flax's LayerNorm
epsilon is 1e-6 (torch's default is 1e-5). One final LayerNorm is shared
by the pooled token and the patch tokens (``[pooled; tokens]`` normalised
together), as the JAX module does. There is no BatchNorm, so the model has
no running statistics.

Inputs and feature maps are channels-last (B, H, W, C); the convolutions
run on NCHW views of them. Layer names are the Flax scopes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.models.conv import Conv, reset_cnn_parameters
from lightly_train_tpu_torch.models.vit import DropPath, LayerNorm, Linear

_LN_EPS = 1e-6  # flax.linen.LayerNorm's default


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    layerscale_init: float = 1e-6
    drop_path_rate: float = 0.0
    dtype: torch.dtype = torch.float32


def _nchw(conv: Conv, x: torch.Tensor) -> torch.Tensor:
    """``conv`` over a (B, H, W, C) map; returns (B, H', W', C')."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layerscale_init: float, drop_path: float,
                 dtype: torch.dtype):
        super().__init__()
        self.dwconv = Conv(dim, dim, 7, padding="SAME", groups=dim,
                           dtype=dtype)
        self.norm = LayerNorm(dim, _LN_EPS, dtype)
        self.pwconv1 = Linear(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Linear(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.full((dim,), float(layerscale_init)))
        self.layerscale_init = layerscale_init
        self.dp = DropPath(drop_path)

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        h = self.norm(_nchw(self.dwconv, x))
        h = F.gelu(self.pwconv1(h), approximate="none")
        h = self.pwconv2(h)
        h = h * self.gamma.to(h.dtype)
        return x + self.dp(h, train, generator)


class ConvNeXt(nn.Module):
    """``forward(images, train=False, generator=None)``: images (B, H, W,
    3); ``generator`` drives the stochastic depth in training. Returns
    ``features`` (B, H/32, W/32, D) and ``patch_tokens`` after the final
    norm, ``cls_token`` (the normalised pooled token) and
    ``stage_features``."""

    def __init__(self, cfg: ConvNeXtConfig):
        super().__init__()
        self.cfg = cfg
        dtype = cfg.dtype
        total = sum(cfg.depths)
        rates = [cfg.drop_path_rate * i / max(total - 1, 1)
                 for i in range(total)]
        self.stem_conv = Conv(3, cfg.dims[0], 4, 4, "VALID", dtype=dtype)
        self.stem_norm = LayerNorm(cfg.dims[0], _LN_EPS, dtype)
        self.block_names = []
        k = 0
        for stage in range(4):
            if stage > 0:
                setattr(self, f"down{stage}_norm",
                        LayerNorm(cfg.dims[stage - 1], _LN_EPS, dtype))
                setattr(self, f"down{stage}_conv",
                        Conv(cfg.dims[stage - 1], cfg.dims[stage], 2, 2,
                             "VALID", dtype=dtype))
            names = []
            for b in range(cfg.depths[stage]):
                name = f"stage{stage}_block{b}"
                setattr(self, name, ConvNeXtBlock(
                    cfg.dims[stage], cfg.layerscale_init, rates[k], dtype))
                names.append(name)
                k += 1
            self.block_names.append(names)
        self.norm = LayerNorm(cfg.dims[-1], _LN_EPS, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        reset_cnn_parameters(self, generator)
        for m in self.modules():
            if isinstance(m, ConvNeXtBlock):
                m.gamma.data.fill_(m.layerscale_init)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, torch.Tensor]:
        x = images.to(self.cfg.dtype)
        stage_feats = []
        for stage, names in enumerate(self.block_names):
            if stage == 0:
                x = self.stem_norm(_nchw(self.stem_conv, x))
            else:
                x = getattr(self, f"down{stage}_norm")(x)
                x = _nchw(getattr(self, f"down{stage}_conv"), x)
            for name in names:
                x = getattr(self, name)(x, train, generator)
            stage_feats.append(x)
        B, H, W, D = x.shape
        pooled = x.mean(dim=(1, 2))
        tokens = self.norm(torch.cat([pooled[:, None, :],
                                      x.reshape(B, H * W, D)], dim=1))
        patch_tokens = tokens[:, 1:]
        return {
            "features": patch_tokens.reshape(B, H, W, D),
            "cls_token": tokens[:, 0],
            "patch_tokens": patch_tokens,
            "stage_features": stage_feats,
        }


_CONVNEXT_SIZES = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    # test-size factory (the reference's _dinov3_convnext_test)
    "test": ((1, 1, 1, 1), (8, 16, 32, 64)),
}


def convnext_config(size: str, dtype: torch.dtype = torch.float32
                    ) -> ConvNeXtConfig:
    if size not in _CONVNEXT_SIZES:
        raise ValueError(
            f"Unknown ConvNeXt size '{size}'. "
            f"Options: {sorted(_CONVNEXT_SIZES)}")
    depths, dims = _CONVNEXT_SIZES[size]
    return ConvNeXtConfig(depths=depths, dims=dims, dtype=dtype)
