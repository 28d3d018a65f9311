"""LT-DETR's encoder and decoder.

Port of ``lightly_train_tpu/tasks/detection/components.py``, module for
module and with the Flax module names, so that ``models/from_jax.py``
carries a JAX parameter tree over by name:

- :class:`ConvNormLayer`, :class:`RepVggBlock`, :class:`CSPRepLayer` and
  :class:`ConvBNAct`: convolution and BatchNorm stacks (NCHW, through
  ``models/conv.py``). BatchNorm keeps fp32 statistics as buffers, with
  Flax's momentum 0.9 (torch's 0.1);
- :class:`TorchMHA`: multi-head attention over torch's fused
  ``in_proj_weight`` (3D, D) in plain ops, the masked logits set to
  float32's lowest value in the logits' dtype (-inf in bf16);
- :class:`TransformerEncoderLayer` (post-norm AIFI) and
  :class:`HybridEncoder` (input projections, AIFI on the coarsest level,
  top-down FPN, bottom-up PAN);
- :func:`grid_sample_zeros` and :class:`MSDeformableAttention`, D-FINE's
  (no value or output projection) and RT-DETRv2's (with both);
- :class:`MLPRef`, :class:`Gate`, :class:`LQE`,
  :class:`TransformerDecoderLayer`, :func:`generate_anchors`,
  :func:`inverse_sigmoid` and :class:`DETRDecoder` for ``decoder="dfine"``
  and ``"rtdetrv2"`` with the denoising groups' self-attention mask.

Feature maps cross module boundaries as (B, H, W, C), as in the JAX
package. The decoder returns D-FINE's per-layer corner distributions and
each layer's query states as values (the JAX module sows them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.models.conv import BatchNorm, Conv
from lightly_train_tpu_torch.models.vit import LayerNorm, Linear, _drawn
from lightly_train_tpu_torch.tasks.detection.box_utils import clip
from lightly_train_tpu_torch.tasks.detection.dfine_utils import (
    distance2bbox,
    integral,
    weighting_function,
)

# torch's defaults in the reference detector, in Flax's convention
# (BatchNorm2d momentum 0.1 is Flax's 0.9).
BN_MOMENTUM = 0.9
BN_EPS = 1e-5
LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class DetrConfig:
    d_model: int = 256
    enc_d_model: Optional[int] = None
    num_heads: int = 8
    num_levels: int = 3
    num_points: Any = (4, 4, 4)
    num_queries: int = 300
    num_decoder_layers: int = 6
    dim_feedforward: int = 1024
    num_classes: int = 80
    use_dfine: bool = False
    dfine_bins: int = 33
    dfine_reg_scale: float = 4.0
    dfine_up: float = 0.5
    csp_blocks: int = 3
    expansion: float = 1.0
    upsample: bool = True
    enc_dim_feedforward: int = 1024
    enc_act: str = "gelu"
    act: str = "silu"
    pe_temperature: float = 10000.0
    anchor_eps: float = 1e-2
    offset_scale: float = 0.5
    dtype: torch.dtype = torch.float32

    @property
    def enc_dim(self) -> int:
        return (self.enc_d_model if self.enc_d_model is not None
                else self.d_model)

    @property
    def points_list(self) -> Tuple[int, ...]:
        p = self.num_points
        if isinstance(p, int):
            return (p,) * self.num_levels
        return tuple(p)

    @property
    def reg_max(self) -> int:
        return self.dfine_bins - 1


def get_act(name: Optional[str]):
    """Flax's activations by name; ``gelu`` is Flax's tanh approximation."""
    if name is None or name == "identity":
        return lambda x: x
    name = name.lower()
    if name in ("silu", "swish"):
        return F.silu
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation: {name}")


def rtdetr_sincos_pe(w: int, h: int, dim: int,
                     temperature: float = 10000.0,
                     device=None) -> torch.Tensor:
    """RT-DETR's 2-D sincos embedding (w*h, dim): a meshgrid over (w, h)
    flattened w-major, [sin(w), cos(w), sin(h), cos(h)]."""
    f32 = dict(dtype=torch.float32, device=device)
    gw, gh = torch.meshgrid(torch.arange(w, **f32), torch.arange(h, **f32),
                            indexing="ij")
    d4 = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(
        d4, dtype=torch.float32, device=device) / d4))
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)


def sincos_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
              device=None) -> torch.Tensor:
    """An h-major 2-D sincos embedding (h*w, dim): [sin(x), cos(x), sin(y),
    cos(y)]."""
    ys = torch.arange(h, dtype=torch.float32, device=device)
    xs = torch.arange(w, dtype=torch.float32, device=device)
    d4 = dim // 4
    omega = 1.0 / (temperature ** (torch.arange(
        d4, dtype=torch.float32, device=device) / d4))
    out_y, out_x = ys[:, None] * omega[None], xs[:, None] * omega[None]
    pe = torch.cat([
        out_x.sin()[None].expand(h, w, d4), out_x.cos()[None].expand(h, w, d4),
        out_y.sin()[:, None].expand(h, w, d4),
        out_y.cos()[:, None].expand(h, w, d4)], -1)
    return pe.reshape(h * w, -1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvBNAct(nn.Module):
    """conv ("SAME") + BatchNorm (Flax's defaults) + silu, over NCHW."""

    def __init__(self, in_ch: int, filters: int, kernel: int = 3,
                 strides: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv(in_ch, filters, kernel, strides, "SAME", bias=False,
                         dtype=dtype)
        self.bn = BatchNorm(filters, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x), train))


class ConvNormLayer(nn.Module):
    """conv (no bias, padding (k - 1) // 2) + BatchNorm + optional act,
    over NCHW."""

    def __init__(self, in_ch: int, ch_out: int, kernel: int = 1,
                 stride: int = 1, act: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        p = (kernel - 1) // 2
        self.conv = Conv(in_ch, ch_out, kernel, stride, ((p, p), (p, p)),
                         bias=False, dtype=dtype)
        self.norm = BatchNorm(ch_out, dtype, momentum=BN_MOMENTUM, eps=BN_EPS)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.act(self.norm(self.conv(x), train))


class RepVggBlock(nn.Module):
    """3x3 + BN plus 1x1 + BN, then the act (training form)."""

    def __init__(self, in_ch: int, ch_out: int, act: Optional[str] = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvNormLayer(in_ch, ch_out, 3, 1, None, dtype)
        self.conv2 = ConvNormLayer(in_ch, ch_out, 1, 1, None, dtype)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.act(self.conv1(x, train) + self.conv2(x, train))


class CSPRepLayer(nn.Module):
    """CSP block over RepVgg bottlenecks."""

    def __init__(self, in_ch: int, ch_out: int, num_blocks: int = 3,
                 expansion: float = 1.0, act: Optional[str] = "silu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(ch_out * expansion)
        self.num_blocks = num_blocks
        self.conv1 = ConvNormLayer(in_ch, hidden, 1, 1, act, dtype)
        for i in range(num_blocks):
            setattr(self, f"bottlenecks{i}",
                    RepVggBlock(hidden, hidden, act, dtype))
        self.conv2 = ConvNormLayer(in_ch, hidden, 1, 1, act, dtype)
        self.conv3 = (ConvNormLayer(hidden, ch_out, 1, 1, act, dtype)
                      if hidden != ch_out else None)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x1 = self.conv1(x, train)
        for i in range(self.num_blocks):
            x1 = getattr(self, f"bottlenecks{i}")(x1, train)
        y = x1 + self.conv2(x, train)
        return self.conv3(y, train) if self.conv3 is not None else y


def masked_logits_fill(dtype: torch.dtype) -> torch.Tensor:
    """float32's lowest value cast to ``dtype``: itself in fp32, -inf in
    bf16 (it rounds past bf16's largest finite value)."""
    return torch.tensor(torch.finfo(torch.float32).min).to(dtype)


class TorchMHA(nn.Module):
    """Multi-head attention with torch's fused in-projection (3D, D) and
    bias (3D,), applied as separate q/k/v projections (q and k may carry a
    position embedding, v does not), in plain ops."""

    def __init__(self, d_model: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.num_heads, self.dtype = d_model, num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, True, dtype)

    def reset_special(self, generator) -> None:
        D = self.d_model
        bound = math.sqrt(6.0 / (D + 3 * D))  # Flax's xavier_uniform
        _drawn(self.in_proj_weight.data,
               lambda t: t.uniform_(-bound, bound, generator=generator),
               generator)
        self.in_proj_bias.data.zero_()

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        D, H, dt = self.d_model, self.num_heads, self.dtype
        hd = D // H
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        qp = F.linear(q.to(dt), w[:D], b[:D])
        kp = F.linear(k.to(dt), w[D:2 * D], b[D:2 * D])
        vp = F.linear(v.to(dt), w[2 * D:], b[2 * D:])
        B, Q, K = qp.shape[0], qp.shape[1], kp.shape[1]
        qh = qp.reshape(B, Q, H, hd).transpose(1, 2)
        kh = kp.reshape(B, K, H, hd).transpose(1, 2)
        vh = vp.reshape(B, K, H, hd).transpose(1, 2)
        logits = torch.matmul(qh, kh.transpose(-1, -2)) / torch.sqrt(
            torch.tensor(float(hd), dtype=qh.dtype, device=qh.device))
        if mask_keep is not None:
            logits = torch.where(mask_keep, logits,
                                 masked_logits_fill(logits.dtype).to(
                                     logits.device))
        attn = torch.softmax(logits.float(), dim=-1).to(vh.dtype)
        out = torch.matmul(attn, vh).transpose(1, 2).reshape(B, Q, D)
        return self.out_proj(out)


class TransformerEncoderLayer(nn.Module):
    """Post-norm AIFI layer."""

    def __init__(self, cfg: DetrConfig):
        super().__init__()
        D, dt = cfg.enc_dim, cfg.dtype
        self.self_attn = TorchMHA(D, cfg.num_heads, dt)
        self.norm1 = LayerNorm(D, LN_EPS, dt)
        self.linear1 = Linear(D, cfg.enc_dim_feedforward, True, dt)
        self.linear2 = Linear(cfg.enc_dim_feedforward, D, True, dt)
        self.norm2 = LayerNorm(D, LN_EPS, dt)
        self.act = get_act(cfg.enc_act)

    def forward(self, src: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        qk = src + pos
        src = self.norm1(src + self.self_attn(qk, qk, src))
        h = self.linear2(self.act(self.linear1(src)))
        return self.norm2(src + h)


def resize_nearest_nchw(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")``: the source index ``floor((i +
    0.5) * in / out)`` (torch's "nearest-exact")."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="nearest-exact")


class HybridEncoder(nn.Module):
    """Input projections -> AIFI on the coarsest level -> FPN -> PAN.
    ``in_channels``: the channels of the three input levels."""

    def __init__(self, cfg: DetrConfig, in_channels: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        D, dt, n = cfg.enc_dim, cfg.dtype, len(in_channels)
        self.n = n
        for i, c in enumerate(in_channels):
            setattr(self, f"input_proj{i}_conv",
                    Conv(c, D, 1, 1, "SAME", bias=False, dtype=dt))
            setattr(self, f"input_proj{i}_norm",
                    BatchNorm(D, dt, momentum=BN_MOMENTUM, eps=BN_EPS))
        self.encoder0_layer0 = TransformerEncoderLayer(cfg)
        for j in range(n - 1):
            setattr(self, f"lateral{j}",
                    ConvNormLayer(D, D, 1, 1, cfg.act, dt))
            setattr(self, f"fpn{j}", CSPRepLayer(
                2 * D, D, cfg.csp_blocks, cfg.expansion, cfg.act, dt))
            if cfg.upsample:
                setattr(self, f"downsample{j}",
                        ConvNormLayer(D, D, 3, 2, cfg.act, dt))
            setattr(self, f"pan{j}", CSPRepLayer(
                2 * D, D, cfg.csp_blocks, cfg.expansion, cfg.act, dt))

    def forward(self, features: Sequence[torch.Tensor],
                train: bool = False) -> List[torch.Tensor]:
        """(B, H, W, C) levels -> (B, H, W, D) levels."""
        cfg = self.cfg
        D, n = cfg.enc_dim, self.n
        proj = []
        for i, f in enumerate(features):
            x = getattr(self, f"input_proj{i}_conv")(_nchw(f))
            proj.append(getattr(self, f"input_proj{i}_norm")(x, train))
        top = proj[-1]
        B, _, Ht, Wt = top.shape
        tokens = top.flatten(2).transpose(1, 2)  # (B, Ht Wt, D)
        pe = rtdetr_sincos_pe(Wt, Ht, D, cfg.pe_temperature,
                              tokens.device).to(tokens.dtype)
        tokens = self.encoder0_layer0(tokens, pe[None])
        proj[-1] = tokens.transpose(1, 2).reshape(B, D, Ht, Wt)

        inner = [proj[-1]]
        for idx in range(n - 1, 0, -1):
            j = n - 1 - idx
            feat_high = getattr(self, f"lateral{j}")(inner[0], train)
            inner[0] = feat_high
            feat_low = proj[idx - 1]
            up = (resize_nearest_nchw(feat_high, feat_low.shape[2:])
                  if cfg.upsample else feat_high)
            inner.insert(0, getattr(self, f"fpn{j}")(
                torch.cat([up, feat_low], 1), train))
        outs = [inner[0]]
        for idx in range(n - 1):
            down = (getattr(self, f"downsample{idx}")(outs[-1], train)
                    if cfg.upsample else outs[-1])
            outs.append(getattr(self, f"pan{idx}")(
                torch.cat([down, inner[idx + 1]], 1), train))
        return [_nhwc(o) for o in outs]


# ---------------------------------------------------------------------------
# The decoder.
# ---------------------------------------------------------------------------


def grid_sample_zeros(level: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """torch ``grid_sample(mode="bilinear", padding_mode="zeros",
    align_corners=False)``'s function, written as the JAX package writes
    it: four corners gathered by advanced indexing (whose backward adds
    into the map in a repeatable order on the card), each weighted and
    zeroed outside the map.

    level: (B, Hl, Wl, NH, hd) per-head map; locs: (B, Q, NH, P, 2)
    locations in [0, 1] (x, y). Returns (B, Q, NH, P, hd)."""
    B, Hl, Wl, NH, hd = level.shape
    Q, P = locs.shape[1], locs.shape[3]
    x = locs[..., 0].float() * Wl - 0.5
    y = locs[..., 1].float() * Hl - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx = (x - x0)[..., None].to(level.dtype)
    wy = (y - y0)[..., None].to(level.dtype)
    x0i, y0i = x0.long(), y0.long()
    flat = level.permute(0, 3, 1, 2, 4).reshape(B * NH, Hl * Wl, hd)
    rows = torch.arange(B * NH, device=level.device)[:, None]

    def corner(xi, yi):
        inb = (xi >= 0) & (xi < Wl) & (yi >= 0) & (yi < Hl)
        idx = yi.clamp(0, Hl - 1) * Wl + xi.clamp(0, Wl - 1)
        idx_t = idx.transpose(1, 2).reshape(B * NH, Q * P)
        g = flat[rows, idx_t].reshape(B, NH, Q, P, hd).transpose(1, 2)
        return g * inb[..., None].to(level.dtype)

    f00 = corner(x0i, y0i)
    f01 = corner(x0i + 1, y0i)
    f10 = corner(x0i, y0i + 1)
    f11 = corner(x0i + 1, y0i + 1)
    return (f00 * (1 - wx) * (1 - wy) + f01 * wx * (1 - wy)
            + f10 * (1 - wx) * wy + f11 * wx * wy)


def offset_bias(num_heads: int, points_list: Sequence[int]) -> np.ndarray:
    """``sampling_offsets``' initial bias: a ring of directions, scaled
    1..n per level."""
    total = sum(points_list)
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(num_heads, 1, 2), (1, total, 1))
    scaling = np.concatenate([np.arange(1, n + 1, dtype=np.float32)
                              for n in points_list]).reshape(1, -1, 1)
    return (grid * scaling).reshape(-1).astype(np.float32)


def _prob_bias(p: float) -> float:
    return float(-np.log((1.0 - p) / p))


class MSDeformableAttention(nn.Module):
    """Deformable attention: D-FINE's (``with_value_proj`` False: no value
    or output projection, per-level point counts, one softmax over all
    points, offsets scaled by the 4-d reference box) or RT-DETRv2's
    (``value_proj`` before the sampling, ``output_proj`` after)."""

    def __init__(self, cfg: DetrConfig, with_value_proj: bool = False):
        super().__init__()
        self.cfg, self.with_value_proj = cfg, with_value_proj
        D, H, dt = cfg.d_model, cfg.num_heads, cfg.dtype
        total = sum(cfg.points_list)
        if with_value_proj:
            self.value_proj = Linear(D, D, True, dt)
            self.output_proj = Linear(D, D, True, dt)
        self.sampling_offsets = Linear(D, H * total * 2, True, dt)
        self.attention_weights = Linear(D, H * total, True, dt)
        self.register_buffer("num_points_scale", torch.from_numpy(
            np.concatenate([np.full((p,), 1.0 / p, np.float32)
                            for p in cfg.points_list])), persistent=False)

    def reset_special(self, generator) -> None:
        cfg = self.cfg
        self.sampling_offsets.weight.data.zero_()
        self.sampling_offsets.bias.data.copy_(torch.from_numpy(
            offset_bias(cfg.num_heads, cfg.points_list)))
        self.attention_weights.weight.data.zero_()
        self.attention_weights.bias.data.zero_()

    def forward(self, query: torch.Tensor, ref_points: torch.Tensor,
                value_levels: Sequence[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        B, Q, D = query.shape
        H = cfg.num_heads
        hd = D // H
        pts = cfg.points_list
        total = sum(pts)
        if self.with_value_proj:
            value_levels = [self.value_proj(v) for v in value_levels]
        offsets = self.sampling_offsets(query).reshape(B, Q, H, total, 2)
        attn = torch.softmax(
            self.attention_weights(query).reshape(B, Q, H, total).float(),
            dim=-1).to(query.dtype)
        ref_xy = ref_points[..., :2][:, :, None, None, :]
        ref_wh = ref_points[..., 2:][:, :, None, None, :]
        offset = (offsets * self.num_points_scale[None, None, None, :, None]
                  * ref_wh.to(offsets.dtype) * cfg.offset_scale)
        locs = ref_xy.to(offsets.dtype) + offset  # (B, Q, H, total, 2)
        out = torch.zeros((B, Q, H, hd), dtype=query.dtype,
                          device=query.device)
        start = 0
        for lv, val in enumerate(value_levels):
            p = pts[lv]
            Hl, Wl = val.shape[1], val.shape[2]
            sampled = grid_sample_zeros(val.reshape(B, Hl, Wl, H, hd),
                                        locs[:, :, :, start:start + p])
            w_l = attn[:, :, :, start:start + p]
            out = out + (sampled * w_l[..., None]).sum(3)
            start += p
        out = out.reshape(B, Q, D)
        if self.with_value_proj:
            out = self.output_proj(out)
        return out


class MLPRef(nn.Module):
    """Linear layers ``layers{i}`` with an act between them (none after
    the last); ``last_zero`` starts the last one at zero."""

    def __init__(self, in_dim: int, dims: Sequence[int], act: str = "relu",
                 last_zero: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n, self.act, self.last_zero = len(dims), get_act(act), last_zero
        prev = in_dim
        for i, d in enumerate(dims):
            setattr(self, f"layers{i}", Linear(prev, d, True, dtype))
            prev = d

    def reset_special(self, generator) -> None:
        if self.last_zero:
            last = getattr(self, f"layers{self.n - 1}")
            last.weight.data.zero_()
            last.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"layers{i}")(x)
            if i < self.n - 1:
                x = self.act(x)
        return x


class Gate(nn.Module):
    """Gated fusion of the self- and cross-attention paths."""

    def __init__(self, d_model: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gate = Linear(2 * d_model, 2 * d_model, True, dtype)
        self.norm = LayerNorm(d_model, LN_EPS, dtype)

    def reset_special(self, generator) -> None:
        self.gate.weight.data.zero_()
        self.gate.bias.data.fill_(_prob_bias(0.5))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        gates = torch.sigmoid(self.gate(torch.cat([x1, x2], -1)))
        g1, g2 = gates.chunk(2, -1)
        return self.norm(g1 * x1 + g2 * x2)


class LQE(nn.Module):
    """Location quality estimator: class logits plus an MLP of each edge's
    top-k bin probabilities and their mean."""

    def __init__(self, cfg: DetrConfig, k: int = 4, hidden: int = 64):
        super().__init__()
        self.cfg, self.k = cfg, k
        self.reg_conf = MLPRef(4 * (k + 1), (hidden, 1), "relu", True,
                               cfg.dtype)

    def forward(self, scores: torch.Tensor,
                corners: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, Q = corners.shape[:2]
        prob = torch.softmax(
            corners.reshape(B, Q, 4, cfg.reg_max + 1).float(), dim=-1)
        topk = prob.topk(self.k, dim=-1).values
        stat = torch.cat([topk, topk.mean(-1, keepdim=True)], -1).reshape(
            B, Q, 4 * (self.k + 1))
        return scores + self.reg_conf(stat.to(cfg.dtype)).to(scores.dtype)


class TransformerDecoderLayer(nn.Module):
    """Post-norm decoder layer: D-FINE's with the gated cross-attention,
    or RT-DETRv2's (plain residual and ``norm2`` after a projected
    deformable attention) where ``cfg.use_dfine`` is False."""

    def __init__(self, cfg: DetrConfig):
        super().__init__()
        D, dt = cfg.d_model, cfg.dtype
        self.use_dfine = cfg.use_dfine
        self.self_attn = TorchMHA(D, cfg.num_heads, dt)
        self.norm1 = LayerNorm(D, LN_EPS, dt)
        self.cross_attn = MSDeformableAttention(cfg, not cfg.use_dfine)
        if cfg.use_dfine:
            self.gateway = Gate(D, dt)
        else:
            self.norm2 = LayerNorm(D, LN_EPS, dt)
        self.linear1 = Linear(D, cfg.dim_feedforward, True, dt)
        self.linear2 = Linear(cfg.dim_feedforward, D, True, dt)
        self.norm3 = LayerNorm(D, LN_EPS, dt)

    def forward(self, target: torch.Tensor, ref_points: torch.Tensor,
                value_levels: Sequence[torch.Tensor],
                query_pos: torch.Tensor,
                mask_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        qk = target + query_pos
        target = self.norm1(target + self.self_attn(qk, qk, target,
                                                    mask_keep))
        ca = self.cross_attn(target + query_pos, ref_points, value_levels)
        if self.use_dfine:
            target = self.gateway(target, ca)
        else:
            target = self.norm2(target + ca)
        h = self.linear2(F.relu(self.linear1(target)))
        return self.norm3(clip(target + h, -65504.0, 65504.0))


def generate_anchors(spatial_shapes: Sequence[Tuple[int, int]],
                     grid_size: float = 0.05, eps: float = 1e-2
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-level centre grids with wh = 0.05 * 2^level, in logit space,
    +inf outside the [eps, 1 - eps] band, and the band's (N, 1) flags."""
    anchors = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        gxy = np.stack([gx, gy], -1)
        gxy = (gxy + 0.5) / np.asarray([w, h], np.float32)
        wh = np.ones_like(gxy) * grid_size * (2.0 ** lvl)
        anchors.append(np.concatenate([gxy, wh], -1).reshape(h * w, 4))
    a = np.concatenate(anchors, 0)
    valid = ((a > eps) & (a < 1 - eps)).all(-1, keepdims=True)
    with np.errstate(divide="ignore"):
        a = np.log(a / (1 - a))
    return np.where(valid, a, np.inf).astype(np.float32), valid


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def stable_topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest values along the last axis, in
    descending order, ties to the lower index (``jax.lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


class DETRDecoder(nn.Module):
    """The reference ``DFINETransformer``: input projection, anchor and
    top-k query selection, denoising queries and the refinement loop.
    ``in_channels``: the channels of the encoder's three levels."""

    def __init__(self, cfg: DetrConfig, in_channels: Sequence[int]):
        super().__init__()
        self.cfg = cfg
        D, C, dt = cfg.d_model, cfg.num_classes, cfg.dtype
        self.projected = []
        for i, c in enumerate(in_channels):
            proj = c != D or not cfg.use_dfine
            self.projected.append(proj)
            if proj:
                setattr(self, f"input_proj{i}_conv",
                        Conv(c, D, 1, 1, "SAME", bias=False, dtype=dt))
                setattr(self, f"input_proj{i}_norm",
                        BatchNorm(D, dt, momentum=BN_MOMENTUM, eps=BN_EPS))
        self.enc_output_proj = Linear(D, D, True, dt)
        self.enc_output_norm = LayerNorm(D, LN_EPS, dt)
        self.enc_score_head = Linear(D, C, True, dt)
        self.enc_bbox_head = MLPRef(D, (D, D, 4), last_zero=True, dtype=dt)
        self.denoising_class_embed = nn.Parameter(torch.zeros(C + 1, D))
        self.query_pos_head = MLPRef(4, (2 * D, D), dtype=dt)
        if cfg.use_dfine:
            self.pre_bbox_head = MLPRef(D, (D, D, 4), last_zero=True,
                                        dtype=dt)
        nb = 4 * (cfg.reg_max + 1) if cfg.use_dfine else 4
        for i in range(cfg.num_decoder_layers):
            setattr(self, f"layer{i}", TransformerDecoderLayer(cfg))
            setattr(self, f"dec_score_head{i}", Linear(D, C, True, dt))
            setattr(self, f"dec_bbox_head{i}",
                    MLPRef(D, (D, D, nb), last_zero=True, dtype=dt))
            if cfg.use_dfine:
                setattr(self, f"lqe{i}", LQE(cfg))
        self.register_buffer("project", torch.from_numpy(weighting_function(
            cfg.reg_max, cfg.dfine_up, cfg.dfine_reg_scale)),
            persistent=False)
        self._anchor_cache = {}

    def reset_special(self, generator) -> None:
        b = _prob_bias(0.01)
        self.enc_score_head.bias.data.fill_(b)
        for i in range(self.cfg.num_decoder_layers):
            getattr(self, f"dec_score_head{i}").bias.data.fill_(b)
        w = self.denoising_class_embed
        _drawn(w.data, lambda t: t.normal_(0.0, 1.0, generator=generator),
               generator)
        w.data[-1].zero_()

    def _anchors(self, spatial_shapes, device):
        key = (tuple(spatial_shapes), str(device))
        if key not in self._anchor_cache:
            a, v = generate_anchors(spatial_shapes, eps=self.cfg.anchor_eps)
            self._anchor_cache[key] = (
                torch.from_numpy(a)[None].to(device),
                torch.from_numpy(v.astype(np.float32))[None].to(device))
        return self._anchor_cache[key]

    def forward(self, levels: Sequence[torch.Tensor], train: bool = False,
                dn_labels: Optional[torch.Tensor] = None,
                dn_boxes: Optional[torch.Tensor] = None,
                dn_group_size: int = 0):
        """(outputs, dists, query_states): ``outputs`` the [(class logits
        (B, Q, C) fp32, cxcywh boxes (B, Q, 4) fp32)] of the encoder's
        top-k, the pre level (D-FINE only) and each decoder layer; ``dists``
        D-FINE's [(corner logits (B, Q, 4, nb), anchor (B, Q, 4))] per
        decoder layer (empty for RT-DETRv2); ``query_states`` each decoder
        layer's output queries (B, Q, D), the last of them the final
        queries (the JAX module sows both)."""
        cfg = self.cfg
        D, dt = cfg.d_model, cfg.dtype
        B = levels[0].shape[0]
        proj = []
        for i, f in enumerate(levels):
            if self.projected[i]:
                x = getattr(self, f"input_proj{i}_conv")(_nchw(f))
                proj.append(_nhwc(getattr(self, f"input_proj{i}_norm")(
                    x, train)))
            else:
                proj.append(f)
        spatial = [(f.shape[1], f.shape[2]) for f in proj]
        memory = torch.cat([f.reshape(B, -1, D) for f in proj], 1)
        anchors, valid = self._anchors(spatial, memory.device)
        out_mem = self.enc_output_norm(self.enc_output_proj(
            memory * valid.to(memory.dtype)))
        enc_logits = self.enc_score_head(out_mem)
        k = min(cfg.num_queries, memory.shape[1])
        topk = stable_topk_indices(enc_logits.float().max(-1).values, k)
        topk_mem = out_mem.gather(1, topk[..., None].expand(-1, -1, D))
        topk_logits = enc_logits.gather(
            1, topk[..., None].expand(-1, -1, enc_logits.shape[-1]))
        topk_anchors = anchors.expand(B, -1, -1).gather(
            1, topk[..., None].expand(-1, -1, 4))
        enc_bbox_unact = self.enc_bbox_head(topk_mem).float() + topk_anchors
        enc_boxes = torch.sigmoid(enc_bbox_unact)
        content = topk_mem.detach()
        ref_unact = enc_bbox_unact.detach()

        mask_keep = None
        if dn_labels is not None:
            n_dn = dn_labels.shape[1]
            dn_content = self.denoising_class_embed[dn_labels.long()].to(
                content.dtype)
            content = torch.cat([dn_content, content], 1)
            ref_unact = torch.cat([inverse_sigmoid(dn_boxes.float()),
                                   ref_unact], 1)
            mask_keep = dn_mask_keep(n_dn, k, dn_group_size, memory.device)

        outputs = [(topk_logits.float(), enc_boxes)]
        dists, query_states = [], []
        ref_detach = torch.sigmoid(ref_unact)
        output = content
        output_detach = corners_undetach = ref_initial = None
        for i in range(cfg.num_decoder_layers):
            qpe = self.query_pos_head(ref_detach.to(dt))
            if cfg.use_dfine:
                qpe = clip(qpe, -10.0, 10.0)
            output = getattr(self, f"layer{i}")(output, ref_detach.to(dt),
                                                proj, qpe, mask_keep)
            query_states.append(output)
            out32 = output.float()
            score_head = getattr(self, f"dec_score_head{i}")
            if cfg.use_dfine:
                if i == 0:
                    pre_boxes = torch.sigmoid(
                        self.pre_bbox_head(output).float()
                        + inverse_sigmoid(ref_detach))
                    ref_initial = pre_boxes.detach()
                    outputs.append((score_head(output).float(), pre_boxes))
                head_in = out32
                if output_detach is not None:
                    head_in = head_in + output_detach
                corners = getattr(self, f"dec_bbox_head{i}")(
                    head_in.to(dt)).float()
                if corners_undetach is not None:
                    corners = corners + corners_undetach
                corners4 = corners.reshape(corners.shape[0],
                                           corners.shape[1], 4,
                                           cfg.reg_max + 1)
                new_boxes = distance2bbox(
                    ref_initial, integral(corners4, self.project),
                    cfg.dfine_reg_scale)
                dists.append((corners4, ref_initial))
                scores = score_head(out32.to(dt)).float()
                scores = getattr(self, f"lqe{i}")(scores, corners)
                outputs.append((scores, new_boxes))
                corners_undetach = corners
                ref_detach = new_boxes.detach()
                output_detach = out32.detach()
            else:
                logits = score_head(output).float()
                delta = getattr(self, f"dec_bbox_head{i}")(output).float()
                new_boxes = torch.sigmoid(delta + inverse_sigmoid(ref_detach))
                outputs.append((logits, new_boxes))
                ref_detach = new_boxes.detach()
        return outputs, dists, query_states


def dn_mask_keep(n_dn: int, k: int, group_size: int,
                 device=None) -> torch.Tensor:
    """(1, 1, N, N) bool self-attention mask of ``n_dn`` denoising queries
    in groups of ``group_size`` before ``k`` matching queries: a denoising
    key is seen by the queries of its own group only."""
    idx = torch.arange(n_dn + k, device=device)
    group = torch.where(idx < n_dn, idx // max(group_size, 1), -1)
    is_dn_col = (idx < n_dn)[None, :]
    same = group[:, None] == group[None, :]
    return torch.where(is_dn_col, same, True)[None, None]


def reset_detr_parameters(root: nn.Module, generator) -> None:
    """The Flax initializers of the LT-DETR modules under ``root``:
    lecun-normal kernels and zero biases, norms at one and zero, then each
    module's own (``reset_special``): xavier-uniform in-projections, the
    offset ring, zero last layers, the prior-probability biases and the
    denoising embedding."""
    for m in root.modules():
        if isinstance(m, (Linear, Conv, BatchNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, LayerNorm):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()
    for m in root.modules():
        if hasattr(m, "reset_special"):
            m.reset_special(generator)
