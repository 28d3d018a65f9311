"""DINOv2/DINOv3-style Vision Transformer in PyTorch.

Port of ``lightly_train_tpu/models/vit.py``: CLS token, learnable mask token
for iBOT masking, separate q/k/v projections, LayerScale, per-sample
stochastic depth, and either flavour's position code and FFN:

- DINOv2: interpolatable learned position embedding (torch-exact bicubic
  weights), GELU MLP (SwiGLU on ViT-g), LayerNorm eps 1e-6;
- DINOv3: 4 register tokens, 2-D axial RoPE on the patch tokens' q and k
  (no learned position embedding), a key projection without bias, LayerNorm
  eps 1e-5, SwiGLU on the "plus" sizes.

As in the JAX package, inputs are channels-last (B, H, W, 3), parameters are
float32 and ``cfg.dtype`` is the compute dtype: every projection casts its
input and weight to it (bf16 training computes in bf16 against fp32 master
weights), LayerNorm statistics are taken in fp32. Unmasked attention runs in
the flat-attention kernels on the card (``ops/kernels/attention.py``).

Activation checkpointing (``remat_every``, ``remat_policy``): where the JAX
ViT wraps block ``i`` in ``nn.remat`` (``i % remat_every == 0``), the port
runs it under ``torch.utils.checkpoint`` when gradients are taken; the
policy names are those of ``jax.checkpoint_policies`` (:data:`REMAT_POLICIES`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.ops.kernels.attention import attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Architecture hyperparameters. Factory presets in :func:`vit_config`."""

    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_register_tokens: int = 0
    layerscale_init: Optional[float] = 1e-5
    drop_path_rate: float = 0.0
    use_rope: bool = False
    rope_base: float = 100.0
    use_swiglu: bool = False
    # SwiGLU hidden = int(mlp_ratio * D * 2 / 3) padded up to this multiple.
    swiglu_align: int = 8
    qkv_bias: bool = True
    # DINOv3's key projection has no bias.
    mask_k_bias: bool = False
    proj_bias: bool = True
    ffn_bias: bool = True
    # DINOv3 has no learned position embedding (RoPE only).
    use_pos_embed: bool = True
    # LayerNorm epsilon: DINOv2 "layernorm" 1e-6, DINOv3 1e-5.
    norm_eps: float = 1e-6
    # Base grid the learned pos-embed is stored at (224 / patch).
    pos_embed_size: int = 16
    # Recompute every Nth block in the backward pass (0 = off), under the
    # ``jax.checkpoint_policies`` name ``remat_policy`` (None = save
    # nothing).
    remat_every: int = 0
    remat_policy: Optional[str] = None
    dtype: torch.dtype = torch.float32  # compute dtype (bf16 for training)


# The jax.checkpoint_policies names that are policies themselves -> the ops
# whose outputs a recomputed block keeps (None: no checkpoint at all). The
# "dots" policies keep the matrix products (torch's aten.mm / addmm; bmm
# where batch dimensions are allowed), and everything else, the attention
# kernels' outputs included, is recomputed, as a Pallas call is no dot for
# JAX either.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES: Dict[Optional[str], Optional[tuple]] = {
    None: (),
    "nothing_saveable": (),
    "everything_saveable": None,
    "dots_saveable": _DOTS + (torch.ops.aten.bmm.default,),
    "checkpoint_dots": _DOTS + (torch.ops.aten.bmm.default,),
    "dots_with_no_batch_dims_saveable": _DOTS,
    "checkpoint_dots_with_no_batch_dims": _DOTS,
}


def _drawn(w: torch.Tensor, draw, generator: Optional[torch.Generator]
           ) -> None:
    """``draw(t)`` fills ``t`` from ``generator``: in ``w`` itself, or, where
    ``w`` lies on another device than the generator (a model built on the
    card, drawn from the CPU generator), in a buffer on the generator's
    device that is then copied into ``w``. Either way ``w`` gets the same
    values, and a model initialised leaf by leaf never stands whole on the
    host."""
    if generator is None or generator.device == w.device:
        draw(w)
        return
    buf = torch.empty(w.shape, dtype=w.dtype, device=generator.device)
    draw(buf)
    w.copy_(buf)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """Flax's default kernel init: truncated normal, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    _drawn(w, lambda t: nn.init.trunc_normal_(
        t, std=std, a=-2 * std, b=2 * std, generator=generator), generator)


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


@functools.lru_cache(maxsize=None)
def rope_angles(grid_hw: Tuple[int, int], head_dim: int, base: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """2-D axial RoPE cos/sin tables, each (gh * gw, head_dim / 2) float32,
    for a (gh, gw) patch grid: the first half of each table's columns
    rotate with the y coordinate, the second with x; coordinates in
    [-1, 1]; angle = 2 pi coord / period with periods
    base ** (2 i / (head_dim / 2)). Built on the host in numpy float32 in
    the JAX package's op order (``_rope_angles``), which it holds bitwise:
    another order lands about 12 ulp away."""
    gh, gw = grid_hw
    dim_quarter = head_dim // 4
    f32 = np.float32
    periods = f32(base) ** (
        f32(2) * np.arange(dim_quarter, dtype=f32) / f32(dim_quarter * 2))
    ys = (np.arange(0.5, gh, dtype=f32) / f32(gh)) * f32(2) - f32(1)
    xs = (np.arange(0.5, gw, dtype=f32) / f32(gw)) * f32(2) - f32(1)
    two_pi = f32(2 * math.pi)
    ang_y = (two_pi * ys)[:, None] / periods[None, :]
    ang_x = (two_pi * xs)[:, None] / periods[None, :]
    ang = np.concatenate([
        np.broadcast_to(ang_y[:, None, :], (gh, gw, dim_quarter)),
        np.broadcast_to(ang_x[None, :, :], (gh, gw, dim_quarter)),
    ], axis=-1).reshape(gh * gw, head_dim // 2)
    return np.cos(ang), np.sin(ang)


# (grid, head dim, base, dtype, device) -> the tables on the device, so a
# forward copies nothing from the host after its first call.
_ROPE_TABLES: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def rope_tables(grid_hw: Tuple[int, int], head_dim: int, base: float,
                dtype: torch.dtype, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rope_angles` cast to the compute ``dtype`` on ``device``."""
    key = (tuple(grid_hw), head_dim, float(base), dtype, device)
    if key not in _ROPE_TABLES:
        _ROPE_TABLES[key] = tuple(
            torch.from_numpy(t).to(device=device, dtype=dtype)
            for t in rope_angles(tuple(grid_hw), head_dim, float(base)))
    return _ROPE_TABLES[key]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of x (B, N, H, hd) by tables (N, hd / 2)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


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
    def __init__(self, cfg: ViTConfig, num_prefix_tokens: int):
        super().__init__()
        D = cfg.embed_dim
        self.num_heads = cfg.num_heads
        self.num_prefix_tokens = num_prefix_tokens
        # Separate q/k/v projections, as in the JAX ViT: the (B, N, D)
        # outputs feed the flat-attention kernel directly.
        self.q = Linear(D, D, cfg.qkv_bias, cfg.dtype)
        self.k = Linear(D, D, cfg.qkv_bias and not cfg.mask_k_bias,
                        cfg.dtype)
        self.v = Linear(D, D, cfg.qkv_bias, cfg.dtype)
        self.proj = Linear(D, D, cfg.proj_bias, cfg.dtype)

    def forward(self, x: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q, k = self.q(x), self.k(x)
        if rope is not None:
            # The prefix tokens (CLS, registers) are not rotated.
            p = self.num_prefix_tokens
            q, k = (torch.cat([
                t[:, :p], apply_rope(
                    t[:, p:].unflatten(-1, (self.num_heads, -1)), *rope
                ).flatten(2)], dim=1) for t in (q, k))
        out = attention(q, k, self.v(x), self.num_heads, attn_mask)
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


class SwiGLU(nn.Module):
    """SwiGLU FFN with separate w1/w2 projections: 2/3 of the MLP hidden
    width, padded up to ``cfg.swiglu_align``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.embed_dim
        d = int(2 * int(D * cfg.mlp_ratio) / 3)
        hidden = d + (-d % cfg.swiglu_align)
        self.w1 = Linear(D, hidden, cfg.ffn_bias, cfg.dtype)
        self.w2 = Linear(D, hidden, cfg.ffn_bias, cfg.dtype)
        self.w3 = Linear(hidden, D, cfg.ffn_bias, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w3(F.silu(self.w1(x)) * self.w2(x))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, drop_path: float,
                 num_prefix_tokens: int = 1):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = LayerNorm(D, cfg.norm_eps, cfg.dtype)
        self.attn = Attention(cfg, num_prefix_tokens)
        self.norm2 = LayerNorm(D, cfg.norm_eps, cfg.dtype)
        self.mlp = SwiGLU(cfg) if cfg.use_swiglu else Mlp(cfg)
        self.ls1 = self.ls2 = None
        if cfg.layerscale_init is not None:
            self.ls1 = LayerScale(cfg.layerscale_init, D)
            self.ls2 = LayerScale(cfg.layerscale_init, D)
        self.dp1 = DropPath(drop_path)
        self.dp2 = DropPath(drop_path)

    def forward(self, x, train: bool, generator=None, attn_mask=None,
                rope=None):
        h = self.attn(self.norm1(x), rope, attn_mask)
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + self.dp1(h, train, generator)
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + self.dp2(h, train, generator)


def checkpointed_block(block: "Block", x: torch.Tensor, train: bool,
                       generator: Optional[torch.Generator], rope,
                       saved_ops: tuple) -> torch.Tensor:
    """``block(x, ...)`` whose activations are recomputed in the backward
    pass, keeping the outputs of ``saved_ops`` (every other op is
    recomputed).

    Drop path draws from ``generator``, which torch's checkpoint does not
    stash: the recompute restores the generator's state at the block's
    start, so that it draws the forward's masks, and then puts back the
    state it found, so that no later draw of the step moves."""
    start = generator.get_state() if generator is not None else None
    calls = [0]

    def run(h: torch.Tensor) -> torch.Tensor:
        calls[0] += 1
        if calls[0] == 1 or start is None:
            return block(h, train, generator, rope=rope)
        found = generator.get_state()
        generator.set_state(start)
        try:
            return block(h, train, generator, rope=rope)
        finally:
            generator.set_state(found)

    kwargs = {}
    if saved_ops:
        def policy(ctx, op, *args, **kw):
            return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    return checkpoint(run, x, use_reentrant=False, **kwargs)


class VisionTransformer(nn.Module):
    """ViT trunk returning the cls token, patch tokens and the feature map.

    ``forward(images, mask=None, train=False, generator=None)``: images is
    (B, H, W, 3); mask an optional (B, N) bool of patches to replace with the
    learned mask token (the iBOT student path); ``generator`` drives the
    per-sample drop path when training. Returns ``cls_token``,
    ``patch_tokens``, ``features`` (B, gh, gw, D) and ``register_tokens``.
    """

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D = cfg.embed_dim
        self.num_prefix_tokens = 1 + cfg.num_register_tokens
        self.patch_embed = nn.Conv2d(3, D, cfg.patch_size, cfg.patch_size)
        self.mask_token = nn.Parameter(torch.zeros(D))
        self.pos_embed = (nn.Parameter(
            torch.zeros(1, cfg.pos_embed_size * cfg.pos_embed_size, D))
            if cfg.use_pos_embed else None)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.register_tokens = (
            nn.Parameter(torch.zeros(1, cfg.num_register_tokens, D))
            if cfg.num_register_tokens else None)
        dp_rates = [cfg.drop_path_rate * i / max(cfg.depth - 1, 1)
                    for i in range(cfg.depth)]
        self.blocks = nn.ModuleList(Block(cfg, r, self.num_prefix_tokens)
                                    for r in dp_rates)
        self.norm = LayerNorm(D, cfg.norm_eps, cfg.dtype)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Flax's initializers: lecun-normal kernels, zero biases, normal
        (0.02) cls and register tokens and position embedding, zero mask
        token, LayerNorm scale 1 and bias 0, LayerScale at its init value.
        Every parameter is set, so a module made with ``to_empty`` (on the
        card) is initialised in full; the draws come from ``generator`` in
        one order whatever the device, so a seed gives the same values on
        the card as on the CPU."""
        w = self.patch_embed.weight
        lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)
        self.patch_embed.bias.data.zero_()
        self.mask_token.data.zero_()
        for p in (self.pos_embed, self.cls_token, self.register_tokens):
            if p is not None:
                _drawn(p.data, lambda t: t.normal_(0.0, 0.02,
                                                   generator=generator),
                       generator)
        for m in self.modules():
            if isinstance(m, Linear):
                m.reset_parameters(generator)
            elif isinstance(m, LayerNorm):
                m.weight.data.fill_(1.0)
                m.bias.data.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.data.fill_(self.cfg.layerscale_init)

    def embed(self, images: torch.Tensor,
              mask: Optional[torch.Tensor] = None):
        """The token sequence before the first block: (x (B, N, D), the
        RoPE tables or None, the patch grid (gh, gw))."""
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
        if self.pos_embed is not None:
            x = x + interpolate_pos_embed(self.pos_embed,
                                          (gh, gw)).to(x.dtype)
        tokens = [self.cls_token.to(x.dtype).expand(B, 1, cfg.embed_dim)]
        if self.register_tokens is not None:
            tokens.append(self.register_tokens.to(x.dtype).expand(
                B, cfg.num_register_tokens, cfg.embed_dim))
        x = torch.cat(tokens + [x], dim=1)
        rope = (rope_tables((gh, gw), cfg.embed_dim // cfg.num_heads,
                            cfg.rope_base, cfg.dtype, x.device)
                if cfg.use_rope else None)
        return x, rope, (gh, gw)

    def forward(
        self,
        images: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        tap_indices: Optional[Tuple[int, ...]] = None,
    ) -> Dict[str, torch.Tensor]:
        """``tap_indices`` adds ``taps``: the final norm of the named blocks'
        outputs, as (B, gh, gw, D) patch maps."""
        cfg = self.cfg
        B = images.shape[0]
        x, rope, (gh, gw) = self.embed(images, mask)
        saved_ops = REMAT_POLICIES[cfg.remat_policy]
        remat = (cfg.remat_every > 0 and saved_ops is not None
                 and torch.is_grad_enabled())
        depth = len(self.blocks)
        wanted = {i % depth for i in tap_indices or ()}
        taps = {}
        for i, block in enumerate(self.blocks):
            if remat and i % cfg.remat_every == 0:
                x = checkpointed_block(block, x, train, generator, rope,
                                       saved_ops)
            else:
                x = block(x, train, generator, rope=rope)
            if i in wanted:
                taps[i] = x
        x = self.norm(x)
        p = self.num_prefix_tokens
        patch_tokens = x[:, p:]
        out = {
            "cls_token": x[:, 0],
            "patch_tokens": patch_tokens,
            "features": patch_tokens.reshape(B, gh, gw, cfg.embed_dim),
            "register_tokens": x[:, 1:p],
        }
        if tap_indices is not None:
            out["taps"] = [self.norm(taps[i % depth])[:, p:].reshape(
                B, gh, gw, cfg.embed_dim) for i in tap_indices]
        return out


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

# DINOv3 hub presets: size: (embed_dim, depth, num_heads, ffn_ratio,
# use_swiglu, swiglu_align, qkv_bias). All have 4 register tokens, a key
# projection without bias, LayerNorm eps 1e-5, LayerScale 1e-5 and RoPE
# base 100.
_DINOV3_SIZES = {
    "vitt": (192, 12, 3, 4.0, False, 8, True),
    "vittplus": (192, 12, 3, 6.0, False, 8, True),
    "vits": (384, 12, 6, 4.0, False, 8, True),
    "vitsplus": (384, 12, 6, 6.0, True, 8, True),
    "vitb": (768, 12, 12, 4.0, False, 8, True),
    "vitl": (1024, 24, 16, 4.0, False, 8, True),
    "vitlplus": (1024, 24, 16, 6.0, True, 8, True),
    "vithplus": (1280, 32, 20, 6.0, True, 8, True),
    "vit7b": (4096, 40, 32, 3.0, True, 64, False),
    "vittest": (32, 2, 2, 4.0, False, 8, True),
}


def vit_config(
    size: str,
    patch_size: int,
    *,
    flavor: str = "dinov2",
    dtype: torch.dtype = torch.float32,
    drop_path_rate: float = 0.0,
    remat_every: int = 0,
    remat_policy: Optional[str] = None,
) -> ViTConfig:
    """A ViTConfig for a reference-parity model name: flavour "dinov2"
    (learned position embedding, no registers, GELU MLP but SwiGLU on
    ViT-g, LayerNorm eps 1e-6) or "dinov3" (the hub presets of
    ``_DINOV3_SIZES``). ``remat_policy`` takes the names of
    :data:`REMAT_POLICIES`; the factories of ``jax.checkpoint_policies``
    (``save_only_these_names``, ...) are no policy as a name."""
    if remat_policy not in REMAT_POLICIES:
        raise ConfigError(
            f"Unknown remat_policy {remat_policy!r}. Options: "
            f"{sorted(n for n in REMAT_POLICIES if n is not None)} or None "
            "(the jax.checkpoint_policies names that are policies "
            "themselves)."
        )
    if flavor not in ("dinov2", "dinov3"):
        raise ValueError(f"Unknown ViT flavor '{flavor}' (dinov2|dinov3)")
    sizes = _SIZES if flavor == "dinov2" else _DINOV3_SIZES
    if size not in sizes:
        raise ValueError(f"Unknown ViT size '{size}'. Options: {sorted(sizes)}")
    common = dict(patch_size=patch_size, pos_embed_size=224 // patch_size,
                  drop_path_rate=drop_path_rate, remat_every=remat_every,
                  remat_policy=remat_policy, dtype=dtype)
    if flavor == "dinov3":
        embed_dim, depth, num_heads, ratio, swiglu, align, qkv_bias = (
            _DINOV3_SIZES[size])
        return ViTConfig(
            embed_dim=embed_dim, depth=depth, num_heads=num_heads,
            mlp_ratio=ratio, num_register_tokens=4, use_rope=True,
            use_swiglu=swiglu, swiglu_align=align, qkv_bias=qkv_bias,
            mask_k_bias=True, use_pos_embed=False, norm_eps=1e-5, **common)
    embed_dim, depth, num_heads = _SIZES[size]
    # DINOv2's ViT-g has a SwiGLU FFN (align 8).
    return ViTConfig(embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                     use_swiglu=size == "vitg", **common)
