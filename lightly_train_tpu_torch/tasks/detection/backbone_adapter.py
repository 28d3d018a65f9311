"""ViT -> multi-scale pyramid adapter for LT-DETR (DINOSTAs).

Port of ``lightly_train_tpu/tasks/detection/backbone_adapter.py``: three
final-norm ViT taps resized to /8, /16 and /32, fused with a small conv
"spatial prior" stem on the raw image, and projected per level by a 1x1
conv and BatchNorm. Pyramid backbones (ECViT, ResNet, ConvNeXt, the YOLOs)
bypass it: their last three ``stage_features`` feed the encoder.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from lightly_train_tpu_torch.models.conv import BatchNorm, Conv, max_pool
from lightly_train_tpu_torch.tasks.detection.components import (
    BN_EPS,
    BN_MOMENTUM,
    get_act,
)

_gelu = get_act("gelu")


def _bilinear_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) float32 weights of a half-pixel bilinear resize along
    one axis, the taps clamped to the edge (``antialias=False``)."""
    x = ((torch.arange(n_out, dtype=torch.float64, device=device) + 0.5)
         * n_in / n_out - 0.5).clamp(min=0.0)
    x0 = x.floor().clamp(max=n_in - 1)
    w1 = x - x0
    rows = torch.arange(n_out, device=device)
    m = torch.zeros(n_out, n_in, dtype=torch.float64, device=device)
    m.index_put_((rows, x0.long()), 1.0 - w1, accumulate=True)
    m.index_put_((rows, (x0 + 1).clamp(max=n_in - 1).long()), w1,
                 accumulate=True)
    return m.float()


def _resize_bilinear(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW ``jax.image.resize(..., "bilinear", antialias=False)`` as two
    products with the axes' weight matrices, in float32: its backward is
    products too, bitwise repeatable on the card, where
    ``F.interpolate``'s adds atomically."""
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    my = _bilinear_matrix(x.shape[2], hw[0], x.device)
    mx = _bilinear_matrix(x.shape[3], hw[1], x.device)
    return torch.einsum("oh,bchw,pw->bcop", my, x.float(), mx).to(x.dtype)


class _UnfoldConv(Conv):
    """A 3x3, stride 2, pad 1 convolution without bias as an unfold and a
    product: its backward (a product and a fold) repeats bitwise on the
    card, where cuDNN's data gradient of these strided convolutions does
    not."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        cols = torch.nn.functional.unfold(x.to(self.dtype), 3, padding=1,
                                          stride=2)
        out = self.weight.to(self.dtype).flatten(1) @ cols
        return out.reshape(B, -1, (H + 1) // 2, (W + 1) // 2)


class SpatialPriorModule(nn.Module):
    """Conv stem giving /8, /16 and /32 detail features of the image."""

    def __init__(self, inplanes: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        ip = inplanes

        def conv(i, o):
            return _UnfoldConv(i, o, 3, 2, ((1, 1), (1, 1)), bias=False,
                               dtype=dtype)

        def bn(c):
            return BatchNorm(c, dtype, momentum=BN_MOMENTUM, eps=BN_EPS)

        self.stem_conv, self.stem_norm = conv(3, ip), bn(ip)
        self.conv2_conv, self.conv2_norm = conv(ip, 2 * ip), bn(2 * ip)
        self.conv3_conv, self.conv3_norm = conv(2 * ip, 4 * ip), bn(4 * ip)
        self.conv4_conv, self.conv4_norm = conv(4 * ip, 4 * ip), bn(4 * ip)

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """NCHW image -> NCHW (c2, c3, c4)."""
        c1 = _gelu(self.stem_norm(self.stem_conv(x), train))
        c1 = max_pool(c1, 3, 2, ((1, 1), (1, 1)))
        c2 = self.conv2_norm(self.conv2_conv(c1), train)
        c3 = self.conv3_norm(self.conv3_conv(_gelu(c2)), train)
        c4 = self.conv4_norm(self.conv4_conv(_gelu(c3)), train)
        return c2, c3, c4


class DINOSTAs(nn.Module):
    """Fuse three ViT taps with the STA pyramid and project them.
    ``embed_dim``: the taps' channels."""

    def __init__(self, embed_dim: int, hidden_dim: int, use_sta: bool = True,
                 conv_inplane: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_sta = use_sta
        if use_sta:
            self.sta = SpatialPriorModule(conv_inplane, dtype)
        for i in range(3):
            # The STA's levels have 2, 4 and 4 times conv_inplane channels.
            c = embed_dim + ((2 if i == 0 else 4) * conv_inplane
                             if use_sta else 0)
            setattr(self, f"convs{i}",
                    Conv(c, hidden_dim, 1, 1, "SAME", bias=False, dtype=dtype))
            setattr(self, f"norms{i}", BatchNorm(
                hidden_dim, dtype, momentum=BN_MOMENTUM, eps=BN_EPS))

    def forward(self, image: torch.Tensor, taps: Sequence[torch.Tensor],
                train: bool = False) -> List[torch.Tensor]:
        """image (B, H, W, 3), taps 3 x (B, h, w, C) -> 3 x (B, H', W',
        hidden) at /8, /16, /32 of the tap grid's scale."""
        assert len(taps) == 3
        H_c, W_c = taps[0].shape[1:3]
        num_scales = len(taps) - 2
        resized = []
        for i, t in enumerate(taps):
            s = 2 ** (num_scales - i)
            resized.append(_resize_bilinear(t.permute(0, 3, 1, 2),
                                            (int(H_c * s), int(W_c * s))))
        if self.use_sta:
            details = self.sta(image.permute(0, 3, 1, 2), train)
            resized = [torch.cat([sem, _resize_bilinear(
                det, sem.shape[2:]).to(sem.dtype)], 1)
                for sem, det in zip(resized, details)]
        out = []
        for i, f in enumerate(resized):
            x = getattr(self, f"convs{i}")(f)
            out.append(getattr(self, f"norms{i}")(x, train).permute(
                0, 2, 3, 1))
        return out


def resolve_vit_adapter(embed_dim: int, depth: int
                        ) -> Tuple[Tuple[int, int, int], int]:
    """(interaction_indexes, conv_inplane factor) by model size."""
    if depth >= 40:
        idx, factor = (19, 29, 39), 4
    elif depth >= 24:
        idx, factor = (11, 17, 23), 4
    elif embed_dim <= 256:
        idx, factor = (3, 7, 11), 1
    elif embed_dim <= 384:
        idx, factor = (5, 8, 11), 2
    else:
        idx, factor = (5, 8, 11), 4
    # Test trunks (depth < 12): the taps clamped into range.
    return tuple(min(i, depth - 1) for i in idx), factor
