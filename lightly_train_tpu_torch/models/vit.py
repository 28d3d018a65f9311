"""DINOv2-style Vision Transformer in PyTorch.

Port of ``lightly_train_tpu/models/vit.py`` (DINOv2 flavour): CLS token,
learnable mask token for iBOT masking, interpolatable learned position
embedding (torch-exact bicubic weights), separate q/k/v projections,
LayerScale, per-sample stochastic depth.

As in the JAX package, inputs are channels-last (B, H, W, 3), parameters are
float32 and ``cfg.dtype`` is the compute dtype: every projection casts its
input and weight to it (bf16 training computes in bf16 against fp32 master
weights), LayerNorm statistics are taken in fp32. Unmasked attention runs in
the flat-attention kernels on the card (``ops/kernels/attention.py``).
RoPE, SwiGLU and register tokens (DINOv3) wait for ROADMAP item 10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.ops.kernels.attention import attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters. Factory presets in :func:`vit_config`."""

    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layerscale_init: Optional[float] = 1e-5
    drop_path_rate: float = 0.0
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    # LayerNorm epsilon: DINOv2 "layernorm" 1e-6.
    norm_eps: float = 1e-6
    # Base grid the learned pos-embed is stored at (224 / patch).
    pos_embed_size: int = 16
    dtype: torch.dtype = torch.float32  # compute dtype (bf16 for training)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """Flax's default kernel init: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Linear(nn.Module):
    """Dense layer computing in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        lecun_normal_(self.weight.data, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics and output in ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(self.dtype)


def _torch_bicubic_matrix(out_size: int, in_size: int,
                          offset: float = 0.1) -> np.ndarray:
    """(out, in) resampling matrix matching torch ``F.interpolate`` bicubic
    with the reference's ``interpolate_offset=0.1`` (A = -0.75, no
    antialiasing, align_corners=False, edge-clamped taps)."""
    scale = in_size / (out_size + offset)
    x = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    t = x - x0

    def cubic(d: np.ndarray, a: float = -0.75) -> np.ndarray:
        d = np.abs(d)
        return np.where(
            d <= 1.0,
            ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0,
            np.where(d < 2.0, (((d - 5.0) * d + 8.0) * d - 4.0) * a, 0.0),
        )

    mat = np.zeros((out_size, in_size), np.float32)
    for k in range(-1, 3):
        w = cubic(t - k)
        idx = np.clip(x0 + k, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), w.astype(np.float32))
    return mat


def interpolate_pos_embed(pos_embed: torch.Tensor,
                          grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Resample a (1, g0*g0, D) pos-embed grid to ``grid_hw`` (fp32)."""
    n = pos_embed.shape[1]
    g0 = int(round(n ** 0.5))
    gh, gw = grid_hw
    if (g0, g0) == (gh, gw):
        return pos_embed
    p = pos_embed.float().reshape(1, g0, g0, -1)
    ry = torch.from_numpy(_torch_bicubic_matrix(gh, g0)).to(p.device)
    rx = torch.from_numpy(_torch_bicubic_matrix(gw, g0)).to(p.device)
    p = torch.einsum("oh,bhwd->bowd", ry, p)
    p = torch.einsum("xw,bowd->boxd", rx, p)
    return p.reshape(1, gh * gw, -1).to(pos_embed.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.rate == 0.0 or not train:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        u = torch.rand(shape, generator=generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class LayerScale(nn.Module):
    def __init__(self, init_value: float, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        # Separate q/k/v projections, as in the JAX ViT: the (B, N, D)
        # outputs feed the flat-attention kernel directly.
        self.q = Linear(D, D, cfg.qkv_bias, cfg.dtype)
        self.k = Linear(D, D, cfg.qkv_bias, cfg.dtype)
        self.v = Linear(D, D, cfg.qkv_bias, cfg.dtype)
        self.proj = Linear(D, D, cfg.proj_bias, cfg.dtype)

    def forward(self, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = attention(self.q(x), self.k(x), self.v(x), self.num_heads,
                        attn_mask)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        hidden = int(D * cfg.mlp_ratio)
        self.fc1 = Linear(D, hidden, cfg.ffn_bias, cfg.dtype)
        self.fc2 = Linear(hidden, D, cfg.ffn_bias, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, drop_path: float):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = LayerNorm(D, cfg.norm_eps, cfg.dtype)
        self.attn = Attention(cfg)
        self.norm2 = LayerNorm(D, cfg.norm_eps, cfg.dtype)
        self.mlp = Mlp(cfg)
        self.ls1 = self.ls2 = None
        if cfg.layerscale_init is not None:
            self.ls1 = LayerScale(cfg.layerscale_init, D)
            self.ls2 = LayerScale(cfg.layerscale_init, D)
        self.dp1 = DropPath(drop_path)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, train: bool, generator=None, attn_mask=None):
        h = self.attn(self.norm1(x), attn_mask)
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + self.dp1(h, train, generator)
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + self.dp2(h, train, generator)


class VisionTransformer(nn.Module):
    """ViT trunk returning the cls token, patch tokens and the feature map.

    ``forward(images, mask=None, train=False, generator=None)``: images is
    (B, H, W, 3); mask an optional (B, N) bool of patches to replace with the
    learned mask token (the iBOT student path); ``generator`` drives the
    per-sample drop path when training.
    """

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.patch_embed = nn.Conv2d(3, D, cfg.patch_size, cfg.patch_size)
        self.mask_token = nn.Parameter(torch.zeros(D))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, cfg.pos_embed_size * cfg.pos_embed_size, D))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        dp_rates = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
                    for i in range(cfg.depth)]
        self.blocks = nn.ModuleList(Block(cfg, r) for r in dp_rates)
        self.norm = LayerNorm(D, cfg.norm_eps, cfg.dtype)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Flax's initializers: lecun-normal kernels, zero biases, normal
        (0.02) cls token and position embedding, zero mask token."""
        w = self.patch_embed.weight
        lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)
        self.patch_embed.bias.data.zero_()
        self.mask_token.data.zero_()
        for p in (self.pos_embed, self.cls_token):
            p.data.normal_(0.0, 0.02, generator=generator)
        for m in self.modules():
            if isinstance(m, Linear):
                m.reset_parameters(generator)

    def forward(
        self,
        images: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, H, W, _ = images.shape
        gh, gw = H // cfg.patch_size, W // cfg.patch_size
        x = F.conv2d(
            images.to(cfg.dtype).permute(0, 3, 1, 2),
            self.patch_embed.weight.to(cfg.dtype),
            self.patch_embed.bias.to(cfg.dtype),
            stride=cfg.patch_size,
        )
        x = x.flatten(2).transpose(1, 2)  # (B, N, D)
        if mask is not None:
            x = torch.where(mask[:, :, None],
                            self.mask_token.to(x.dtype)[None, None, :], x)
        x = x + interpolate_pos_embed(self.pos_embed, (gh, gw)).to(x.dtype)
        cls = self.cls_token.to(x.dtype).expand(B, 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1)
        for block in self.blocks:
            x = block(x, train, generator)
        x = self.norm(x)
        patch_tokens = x[:, 1:]
        return {
            "cls_token": x[:, 0],
            "patch_tokens": patch_tokens,
            "features": patch_tokens.reshape(B, gh, gw, cfg.embed_dim),
        }


# name: (embed_dim, depth, num_heads) -- DINOv2 family
_SIZES = {
    "vitt": (192, 12, 3),
    "vits": (384, 12, 6),
    "vitb": (768, 12, 12),
    "vitl": (1024, 24, 16),
    "vitg": (1536, 40, 24),
    "vit7b": (4096, 40, 32),
    # tiny test model (reference _vit_test)
    "vittest": (32, 2, 2),
}


def vit_config(
    size: str,
    patch_size: int,
    *,
    flavor: str = "dinov2",
    dtype: torch.dtype = torch.float32,
    drop_path_rate: float = 0.0,
) -> ViTConfig:
    """A ViTConfig for a reference-parity model name (DINOv2 flavour)."""
    if flavor != "dinov2":
        raise NotImplementedError(
            f"ViT flavor '{flavor}' is not ported yet (ROADMAP item 10: the "
            "DINOv3 features RoPE, SwiGLU and register tokens)."
        )
    if size not in _SIZES:
        raise ValueError(f"Unknown ViT size '{size}'. Options: {sorted(_SIZES)}")
    if size == "vitg":
        raise NotImplementedError(
            "dinov2/vitg14 uses a SwiGLU FFN, not ported yet (ROADMAP item 10)."
        )
    if size == "vit7b":
        raise NotImplementedError(
            "dinov2/vit7b14 is not ported yet (ROADMAP item 10): its head dim "
            "128 (4096 / 32 heads) waits for the attention kernels at hd 128 "
            "(ROADMAP queue 2 item 2)."
        )
    embed_dim, depth, num_heads = _SIZES[size]
    return ViTConfig(
        patch_size=patch_size,
        embed_dim=embed_dim,
        depth=depth,
        num_heads=num_heads,
        pos_embed_size=224 // patch_size,
        drop_path_rate=drop_path_rate,
        dtype=dtype,
    )
