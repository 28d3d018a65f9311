"""ECViT (EdgeCrafter) backbone in PyTorch: conv-pyramid patch embed + RoPE
ViT + a three-level feature pyramid.

Port of ``lightly_train_tpu/models/ecvit.py``:

- the patch embed is three 3x3 stride-2 :class:`ConvNormLayer` s (channels
  D/8, D/4, D/2; BatchNorm and ReLU, no bias) and a biased 3x3 stride-2
  projection to the /16 token grid, all padded by 1 on every side;
- one learned register token is prepended (no CLS token, no position
  embedding); 2-D axial RoPE (base 100) rotates the patch tokens' q and k;
- the blocks are the port's ViT blocks (``models/vit.py``) with LayerNorm
  eps 1e-6, an exact-GELU MLP and no LayerScale, so their attention runs in
  the flat-attention kernels on the card;
- the token outputs of the ``interaction_indexes`` blocks are averaged,
  laid out on the /16 grid and resized in fp32 by bilinear interpolation
  without antialiasing (torch's ``align_corners=False``) to int(g * 2),
  int(g) and int(g / 2) (at least 1), then projected by 1x1
  ConvNormLayers: every level where ``proj_dim`` is set, else only the
  last.

``features`` is the last level (P5, stride 32), ``cls_token`` its mean,
``stage_features`` the three levels. BatchNorm keeps its running statistics
as buffers (``models/conv.py``). Inputs and feature maps are channels-last
(B, H, W, C); layer names are the Flax scopes, so ``from_jax`` carries a
JAX tree over as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.models.conv import (
    BatchNorm,
    Conv,
    reset_cnn_parameters,
)
from lightly_train_tpu_torch.models.vit import Block, ViTConfig, rope_tables


@dataclasses.dataclass(frozen=True)
class ECViTConfig:
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    ffn_ratio: float = 4.0
    # Blocks whose token outputs feed the fused feature map.
    interaction_indexes: Tuple[int, ...] = (10, 11)
    # Per-level projection width (None: embed_dim, one projector on P5).
    proj_dim: Optional[int] = None
    drop_path_rate: float = 0.0
    rope_base: float = 100.0
    dtype: torch.dtype = torch.float32

    def vit_config(self) -> ViTConfig:
        return ViTConfig(
            patch_size=16, embed_dim=self.embed_dim, depth=self.depth,
            num_heads=self.num_heads, mlp_ratio=self.ffn_ratio,
            num_register_tokens=0, layerscale_init=None, use_rope=True,
            rope_base=self.rope_base, use_pos_embed=False, norm_eps=1e-6,
            drop_path_rate=self.drop_path_rate, dtype=self.dtype)


class ConvNormLayer(nn.Module):
    """Convolution without bias, BatchNorm and, with ``act``, ReLU; padded
    by (kernel - 1) / 2 on every side."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 act: bool, dtype: torch.dtype):
        super().__init__()
        p = (kernel - 1) // 2
        self.conv = Conv(in_ch, out_ch, kernel, stride, ((p, p), (p, p)),
                         bias=False, dtype=dtype)
        self.norm = BatchNorm(out_ch, dtype)
        self.act = act

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.norm(self.conv(x), train)
        return F.relu(x) if self.act else x


class ECViT(nn.Module):
    """``forward(images, train=False, generator=None)``: images (B, H, W,
    3); returns the JAX ECViT's feature dict."""

    def __init__(self, cfg: ECViTConfig):
        super().__init__()
        self.cfg = cfg
        D, dtype = cfg.embed_dim, cfg.dtype
        chans = (3, D // 8, D // 4, D // 2)
        for i in range(3):
            setattr(self, f"pe_conv{i}", ConvNormLayer(
                chans[i], chans[i + 1], 3, 2, True, dtype))
        self.pe_proj = Conv(D // 2, D, 3, 2, ((1, 1), (1, 1)), dtype=dtype)
        self.register_token = nn.Parameter(torch.zeros(1, 1, D))
        vcfg = cfg.vit_config()
        rates = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
                 for i in range(cfg.depth)]
        self.blocks = nn.ModuleList(Block(vcfg, r, num_prefix_tokens=1)
                                    for r in rates)
        n_proj = 1 if cfg.proj_dim is None else 3
        width = D if cfg.proj_dim is None else cfg.proj_dim
        for i in range(n_proj):
            setattr(self, f"projector{i}",
                    ConvNormLayer(D, width, 1, 1, False, dtype))

    def stage_channels(self) -> List[int]:
        """The channels of the three ``stage_features`` levels."""
        cfg = self.cfg
        return [cfg.embed_dim if cfg.proj_dim is None else cfg.proj_dim] * 3

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Flax's initializers (``conv.reset_cnn_parameters``); the register
        token at zero."""
        reset_cnn_parameters(self, generator)
        self.register_token.data.zero_()

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, Any]:
        cfg = self.cfg
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)
        for i in range(3):
            x = getattr(self, f"pe_conv{i}")(x, train)
        x = self.pe_proj(x)
        B, D, gh, gw = x.shape
        tokens = torch.cat([self.register_token.to(x.dtype).expand(B, 1, D),
                            x.flatten(2).transpose(1, 2)], dim=1)
        rope = rope_tables((gh, gw), D // cfg.num_heads, cfg.rope_base,
                           cfg.dtype, x.device)
        outs = []
        for i, block in enumerate(self.blocks):
            tokens = block(tokens, train, generator, rope=rope)
            if i in cfg.interaction_indexes:
                outs.append(tokens[:, 1:])
        fused = torch.stack(outs).mean(0).reshape(B, gh, gw, D)
        fused32 = fused.float().permute(0, 3, 1, 2)
        levels = []
        for i in range(3):
            scale = 2.0 ** (1 - i)
            size = (max(1, int(gh * scale)), max(1, int(gw * scale)))
            levels.append(F.interpolate(
                fused32, size=size, mode="bilinear", align_corners=False,
                antialias=False).to(cfg.dtype))
        if cfg.proj_dim is None:
            levels[-1] = self.projector0(levels[-1], train)
        else:
            levels = [getattr(self, f"projector{i}")(lvl, train)
                      for i, lvl in enumerate(levels)]
        p3, p4, p5 = (lvl.permute(0, 2, 3, 1) for lvl in levels)
        Bf, Hf, Wf, Df = p5.shape
        return {
            "features": p5,
            "cls_token": p5.mean(dim=(1, 2)),
            "patch_tokens": p5.reshape(Bf, Hf * Wf, Df),
            "stage_features": [p3, p4, p5],
        }


# The reference presets and the hidden test size.
_ECVIT_SIZES: Dict[str, Dict[str, Any]] = {
    "ecvitt": {"embed_dim": 192, "num_heads": 3, "proj_dim": None,
               "ffn_ratio": 4.0},
    "ecvittplus": {"embed_dim": 256, "num_heads": 4, "proj_dim": None,
                   "ffn_ratio": 4.0},
    "ecvits": {"embed_dim": 384, "num_heads": 6, "proj_dim": 256,
               "ffn_ratio": 4.0},
    "ecvitsplus": {"embed_dim": 384, "num_heads": 6, "proj_dim": 256,
                   "ffn_ratio": 6.0},
    "ecvittest": {"embed_dim": 32, "num_heads": 2, "proj_dim": 16,
                  "ffn_ratio": 4.0, "depth": 2,
                  "interaction_indexes": (0, 1)},
}


def ecvit_config(name: str, dtype: torch.dtype = torch.float32
                 ) -> ECViTConfig:
    if name not in _ECVIT_SIZES:
        raise ValueError(
            f"Unknown ECViT '{name}'. Options: {sorted(_ECVIT_SIZES)}")
    p = _ECVIT_SIZES[name]
    return ECViTConfig(
        embed_dim=p["embed_dim"], num_heads=p["num_heads"],
        proj_dim=p["proj_dim"], ffn_ratio=p["ffn_ratio"],
        depth=p.get("depth", 12),
        interaction_indexes=p.get("interaction_indexes", (10, 11)),
        dtype=dtype)


def ecvit_feature_dim(cfg: ECViTConfig) -> int:
    return cfg.proj_dim if cfg.proj_dim is not None else cfg.embed_dim
