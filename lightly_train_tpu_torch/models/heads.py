"""Projection heads: the DINO head with a weight-normalized prototype layer,
and the single linear projection of distillation.

Port of ``lightly_train_tpu/models/heads.py`` (``WeightNormDense``,
``DINOHead``, ``ProjectionHead``). Like the ViT, heads keep float32
parameters and compute in ``dtype``; the l2 normalization and the weight
norm run in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.models.vit import Linear


class WeightNormDense(nn.Module):
    """Dense layer with a weight-normalized kernel and a TRAINABLE per-output
    gain: ``W[o] = g[o] * v[o] / ||v[o]||``.

    ``v`` is (out, in) like a ``Linear`` weight (the JAX kernel is (in, out)
    and normalizes its columns), ``g`` is (out,).
    """

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.v = nn.Parameter(torch.empty(out_features, in_features))
        self.g = nn.Parameter(torch.ones(out_features))
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.trunc_normal_(self.v.data, std=0.02, a=-0.04, b=0.04,
                              generator=generator)
        self.g.data.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v32 = self.v.float()
        norm = torch.linalg.vector_norm(v32, dim=1, keepdim=True)
        w = v32 * (self.g.float()[:, None] / torch.clamp(norm, min=1e-8))
        return F.linear(x.to(self.dtype), w.to(self.dtype))


class DINOHead(nn.Module):
    """3-layer MLP -> l2-normalize -> weight-normed prototypes (hidden 2048,
    bottleneck 256, exact GELU: the reference defaults)."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int = 65536,
        hidden_dim: int = 2048,
        bottleneck_dim: int = 256,
        n_layers: int = 3,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        dims = [in_dim] + [hidden_dim] * (n_layers - 1)
        self.mlp = nn.ModuleList(
            Linear(dims[i], dims[i + 1], dtype=dtype)
            for i in range(n_layers - 1)
        )
        self.bottleneck = Linear(dims[-1], bottleneck_dim, dtype=dtype)
        self.prototypes = WeightNormDense(bottleneck_dim, out_dim, dtype)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        for layer in (*self.mlp, self.bottleneck, self.prototypes):
            layer.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.dtype)
        for layer in self.mlp:
            h = F.gelu(layer(h))
        h32 = self.bottleneck(h).float()
        norm = torch.linalg.vector_norm(h32, dim=-1, keepdim=True)
        h32 = h32 / torch.clamp(norm, min=1e-8)
        return self.prototypes(h32.to(self.dtype))


class ProjectionHead(nn.Module):
    """One Dense layer (distillation's global and local heads). Its compute
    dtype defaults to fp32, as the JAX head's does, whatever the run's
    precision."""

    def __init__(self, in_dim: int, out_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Linear(in_dim, out_dim, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.proj.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)
