"""The ultralytics YOLOv8, YOLOv5 and YOLO11 backbones in PyTorch.

Port of ``lightly_train_tpu/models/yolo.py``: ``ConvBNSiLU`` (a convolution
without bias, padded symmetrically by k // 2 or by ``pad``, BatchNorm and
SiLU; grouped and without activation for the YOLO11 attention's
convolutions), ``Bottleneck``, ``C2f``, ``C3``, ``C3k2``, ``SPPF`` (5x5
max pools, "SAME", -inf padding), and YOLO11's ``C2PSA`` with
``PSABlock`` and ``PSAAttention``, whose attention is plain products and
an fp32 softmax with key dim hd / 2 over the map's pixels, as in the JAX
package (no Pallas kernel there, so none here).

Each family keeps its own cut and features, as the JAX modules do:

- YOLOv8: layers 0-9; ``features`` is the last C2f (before SPPF),
  ``stage_features`` P3, P4 and SPPF's output;
- YOLOv5: layers 0-8 (6x6 stride-2 stem padded by 2; no SPPF);
  ``features`` the last C3;
- YOLO11: layers 0-10; ``features`` C2PSA's output, after SPPF.

Inputs and feature maps are channels-last (B, H, W, C); the layers run on
NCHW views. Layer names are the Flax scopes (``layer{i}``, ``m{j}``,
``cv1`` ...), so ``from_jax`` carries a JAX tree over as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

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
class YOLOv8Config:
    depth: float = 0.33  # block-count multiple
    width: float = 0.25  # channel multiple
    max_channels: int = 1024
    dtype: torch.dtype = torch.float32

    def ch(self, c: int) -> int:
        return int(round(min(c, self.max_channels) * self.width / 8) * 8) or 8

    def n(self, n: int) -> int:
        return max(1, round(n * self.depth))


class ConvBNSiLU(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int = 1,
                 stride: int = 1, dtype: torch.dtype = torch.float32,
                 pad: int = -1, act: bool = True, groups: int = 1):
        super().__init__()
        p = kernel // 2 if pad < 0 else pad
        self.conv = Conv(in_ch, out_ch, kernel, stride, ((p, p), (p, p)),
                         groups=groups, bias=False, dtype=dtype)
        self.bn = BatchNorm(out_ch, dtype)
        self.act = act

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.bn(self.conv(x), train)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """cv1 (k1) -> cv2 (k2), the residual where the widths match;
    ``hidden_e`` is the hidden width's expansion."""

    def __init__(self, in_ch: int, out_ch: int, shortcut: bool,
                 dtype: torch.dtype, k1: int = 3, k2: int = 3,
                 hidden_e: float = 1.0):
        super().__init__()
        c_ = int(out_ch * hidden_e)
        self.cv1 = ConvBNSiLU(in_ch, c_, k1, dtype=dtype)
        self.cv2 = ConvBNSiLU(c_, out_ch, k2, dtype=dtype)
        self.residual = shortcut and in_ch == out_ch

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        h = self.cv2(self.cv1(x, train), train)
        return h + x if self.residual else h


class C2f(nn.Module):
    """Cross-stage partial block: n bottlenecks on one half, every output
    concatenated; also YOLO11's ``C3k2`` (hidden width int(out * e), the
    inner modules ``C3`` blocks with 3x3 bottlenecks where ``c3k``, else
    bottlenecks of expansion ``hidden_e``)."""

    def __init__(self, in_ch: int, out_ch: int, n: int, shortcut: bool,
                 dtype: torch.dtype, e: float = 0.5, c3k: bool = False,
                 hidden_e: float = 1.0):
        super().__init__()
        c = int(out_ch * e)
        self.cv1 = ConvBNSiLU(in_ch, 2 * c, 1, dtype=dtype)
        for i in range(n):
            setattr(self, f"m{i}", C3(c, c, 2, shortcut, dtype, k=3) if c3k
                    else Bottleneck(c, c, shortcut, dtype,
                                    hidden_e=hidden_e))
        self.n = n
        self.cv2 = ConvBNSiLU((2 + n) * c, out_ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        parts = list(self.cv1(x, train).chunk(2, dim=1))
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1], train))
        return self.cv2(torch.cat(parts, dim=1), train)


class C3(nn.Module):
    """YOLOv5's C3: two 1x1 branches, n bottlenecks (k x k -> 3x3) on the
    first, a 1x1 fuse."""

    def __init__(self, in_ch: int, out_ch: int, n: int, shortcut: bool,
                 dtype: torch.dtype, k: int = 1):
        super().__init__()
        c_ = out_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, c_, 1, dtype=dtype)
        self.cv2 = ConvBNSiLU(in_ch, c_, 1, dtype=dtype)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(c_, c_, shortcut, dtype, k1=k))
        self.n = n
        self.cv3 = ConvBNSiLU(2 * c_, out_ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        a = self.cv1(x, train)
        for i in range(self.n):
            a = getattr(self, f"m{i}")(a, train)
        return self.cv3(torch.cat([a, self.cv2(x, train)], dim=1), train)


class PSAAttention(nn.Module):
    """1x1 qkv over the map, per-head attention with key dim hd * ratio
    (plain products, fp32 softmax), a depthwise 3x3 positional branch on
    v, a 1x1 projection."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads, self.dim = num_heads, dim
        self.hd = dim // num_heads
        self.kd = int(self.hd * attn_ratio)
        self.qkv = ConvBNSiLU(dim, dim + num_heads * self.kd * 2, 1,
                              dtype=dtype, act=False)
        self.pe = ConvBNSiLU(dim, dim, 3, dtype=dtype, act=False,
                             groups=dim)
        self.proj = ConvBNSiLU(dim, dim, 1, dtype=dtype, act=False)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        B, _, H, W = x.shape
        nh, kd = self.num_heads, self.kd
        qkv = self.qkv(x, train).permute(0, 2, 3, 1).reshape(
            B, H * W, nh, 2 * kd + self.hd)
        q, k, v = qkv.split([kd, kd, self.hd], dim=-1)
        attn = torch.einsum("bnhk,bmhk->bhnm", q, k) / math.sqrt(float(kd))
        attn = attn.float().softmax(dim=-1).to(x.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(
            B, H, W, self.dim).permute(0, 3, 1, 2)
        pe = self.pe(v.reshape(B, H, W, self.dim).permute(0, 3, 1, 2), train)
        return self.proj(out + pe, train)


class PSABlock(nn.Module):
    """Residual attention, then a residual 1x1 conv FFN."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.attn = PSAAttention(dim, max(1, dim // 64), dtype)
        self.ffn0 = ConvBNSiLU(dim, dim * 2, 1, dtype=dtype)
        self.ffn1 = ConvBNSiLU(dim * 2, dim, 1, dtype=dtype, act=False)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x + self.attn(x, train)
        return x + self.ffn1(self.ffn0(x, train), train)


class C2PSA(nn.Module):
    """Split, n PSA blocks on one half, 1x1 fuse."""

    def __init__(self, in_ch: int, out_ch: int, n: int, dtype: torch.dtype):
        super().__init__()
        c = out_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, 2 * c, 1, dtype=dtype)
        for i in range(n):
            setattr(self, f"m{i}", PSABlock(c, dtype))
        self.n = n
        self.cv2 = ConvBNSiLU(2 * c, out_ch, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        a, b = self.cv1(x, train).chunk(2, dim=1)
        for i in range(self.n):
            b = getattr(self, f"m{i}")(b, train)
        return self.cv2(torch.cat([a, b], dim=1), train)


class SPPF(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype,
                 pool: int = 5):
        super().__init__()
        c = in_ch // 2
        self.cv1 = ConvBNSiLU(in_ch, c, 1, dtype=dtype)
        self.cv2 = ConvBNSiLU(4 * c, out_ch, 1, dtype=dtype)
        self.pool = pool

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        pools = [self.cv1(x, train)]
        for _ in range(3):
            pools.append(max_pool(pools[-1], self.pool, 1, "SAME"))
        return self.cv2(torch.cat(pools, dim=1), train)


class _YOLOBackbone(nn.Module):
    """The layers ``layer0`` ... in order; subclasses name the cut."""

    def __init__(self, cfg: YOLOv8Config):
        super().__init__()
        self.cfg = cfg
        self.n_layers = 0

    def add(self, layer: nn.Module) -> None:
        setattr(self, f"layer{self.n_layers}", layer)
        self.n_layers += 1

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        reset_cnn_parameters(self, generator)

    def run(self, images: torch.Tensor, train: bool) -> list:
        """Every layer's output, channels-last."""
        x = images.to(self.cfg.dtype).permute(0, 3, 1, 2)
        outs = []
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x, train)
            outs.append(x)
        return [o.permute(0, 2, 3, 1) for o in outs]

    @staticmethod
    def output(features: torch.Tensor, stages: list) -> Dict:
        B, H, W, D = features.shape
        return {
            "features": features,
            "cls_token": features.mean(dim=(1, 2)),
            "patch_tokens": features.reshape(B, H * W, D),
            "stage_features": stages,
        }


class YOLOv8Backbone(_YOLOBackbone):
    """Layers 0-9 of YOLOv8; features before SPPF."""

    def __init__(self, cfg: YOLOv8Config):
        super().__init__(cfg)
        ch, n, dt = cfg.ch, cfg.n, cfg.dtype
        self.add(ConvBNSiLU(3, ch(64), 3, 2, dt))
        self.add(ConvBNSiLU(ch(64), ch(128), 3, 2, dt))
        self.add(C2f(ch(128), ch(128), n(3), True, dt))
        self.add(ConvBNSiLU(ch(128), ch(256), 3, 2, dt))
        self.add(C2f(ch(256), ch(256), n(6), True, dt))
        self.add(ConvBNSiLU(ch(256), ch(512), 3, 2, dt))
        self.add(C2f(ch(512), ch(512), n(6), True, dt))
        self.add(ConvBNSiLU(ch(512), ch(1024), 3, 2, dt))
        self.add(C2f(ch(1024), ch(1024), n(3), True, dt))
        self.add(SPPF(ch(1024), ch(1024), dt))

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        outs = self.run(images, train)
        return self.output(outs[8], [outs[4], outs[6], outs[9]])


class YOLOv5Backbone(_YOLOBackbone):
    """Layers 0-8 of YOLOv5 (cut before SPPF); the 6x6 stem pads by 2."""

    def __init__(self, cfg: YOLOv8Config):
        super().__init__(cfg)
        ch, n, dt = cfg.ch, cfg.n, cfg.dtype
        self.add(ConvBNSiLU(3, ch(64), 6, 2, dt, pad=2))
        self.add(ConvBNSiLU(ch(64), ch(128), 3, 2, dt))
        self.add(C3(ch(128), ch(128), n(3), True, dt))
        self.add(ConvBNSiLU(ch(128), ch(256), 3, 2, dt))
        self.add(C3(ch(256), ch(256), n(6), True, dt))
        self.add(ConvBNSiLU(ch(256), ch(512), 3, 2, dt))
        self.add(C3(ch(512), ch(512), n(9), True, dt))
        self.add(ConvBNSiLU(ch(512), ch(1024), 3, 2, dt))
        self.add(C3(ch(1024), ch(1024), n(3), True, dt))

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        outs = self.run(images, train)
        return self.output(outs[8], [outs[4], outs[6], outs[8]])


class YOLO11Backbone(_YOLOBackbone):
    """Layers 0-10 of YOLO11 (SPPF and C2PSA included); features after
    C2PSA."""

    def __init__(self, cfg: YOLOv8Config):
        super().__init__(cfg)
        ch, n, dt = cfg.ch, cfg.n, cfg.dtype
        self.add(ConvBNSiLU(3, ch(64), 3, 2, dt))
        self.add(ConvBNSiLU(ch(64), ch(128), 3, 2, dt))
        self.add(C2f(ch(128), ch(256), n(2), True, dt, e=0.25,
                     hidden_e=0.5))
        self.add(ConvBNSiLU(ch(256), ch(256), 3, 2, dt))
        self.add(C2f(ch(256), ch(512), n(2), True, dt, e=0.25,
                     hidden_e=0.5))
        self.add(ConvBNSiLU(ch(512), ch(512), 3, 2, dt))
        self.add(C2f(ch(512), ch(512), n(2), True, dt, c3k=True))
        self.add(ConvBNSiLU(ch(512), ch(1024), 3, 2, dt))
        self.add(C2f(ch(1024), ch(1024), n(2), True, dt, c3k=True))
        self.add(SPPF(ch(1024), ch(1024), dt))
        self.add(C2PSA(ch(1024), ch(1024), n(2), dt))

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Dict:
        outs = self.run(images, train)
        return self.output(outs[10], [outs[4], outs[6], outs[10]])


# name -> (depth, width, max_channels): the ultralytics yaml scales.
_YOLOV8_SIZES = {
    "yolov8n": (0.33, 0.25, 1024),
    "yolov8s": (0.33, 0.50, 1024),
    "yolov8m": (0.67, 0.75, 768),
    "yolov8l": (1.00, 1.00, 512),
    "yolov8x": (1.00, 1.25, 512),
    "yolov8test": (0.33, 0.05, 64),  # hidden test size
}
_YOLOV5_SIZES = {
    "yolov5n": (0.33, 0.25, 1024),
    "yolov5s": (0.33, 0.50, 1024),
    "yolov5m": (0.67, 0.75, 1024),
    "yolov5l": (1.00, 1.00, 1024),
    "yolov5x": (1.33, 1.25, 1024),
    "yolov5test": (0.33, 0.05, 128),  # hidden test size
}
_YOLO11_SIZES = {
    "yolo11n": (0.50, 0.25, 1024),
    "yolo11s": (0.50, 0.50, 1024),
    "yolo11m": (0.50, 1.00, 512),
    "yolo11l": (1.00, 1.00, 512),
    "yolo11x": (1.00, 1.50, 512),
    "yolo11test": (0.50, 0.125, 1024),  # hidden test size
}


def yolo_config(size: str, dtype: torch.dtype = torch.float32
                ) -> YOLOv8Config:
    """The config of a YOLOv8, YOLOv5 or YOLO11 size; a ``.pt``, ``-cls``
    or ``-seg`` suffix names the same backbone."""
    key = size.removesuffix(".pt").removesuffix("-cls").removesuffix("-seg")
    for table in (_YOLOV8_SIZES, _YOLOV5_SIZES, _YOLO11_SIZES):
        if key in table:
            d, w, mc = table[key]
            return YOLOv8Config(depth=d, width=w, max_channels=mc,
                                dtype=dtype)
    raise ValueError(f"Unknown YOLO size '{size}'.")


def yolo_backbone(name: str, cfg: YOLOv8Config) -> _YOLOBackbone:
    if name.startswith("yolov5"):
        return YOLOv5Backbone(cfg)
    if name.startswith("yolo11"):
        return YOLO11Backbone(cfg)
    return YOLOv8Backbone(cfg)
