"""Embedding projection: backbone + trainable linear embedding head.

Port of ``lightly_train_tpu/models/embedding.py``, the ``embed_dim`` path:
during pretraining :func:`project_wrapped` joins one shared linear layer
(``embed``) to every feature output; at inference ``embed`` applies the
exported layer to pooled features (the same map, since pooling commutes
with it; the JAX ``_EmbedHead``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from lightly_train_tpu_torch.models.vit import Linear
from lightly_train_tpu_torch.models.wrapper import WrappedModel


class ProjectedFeaturesModule(nn.Module):
    """Backbone + shared linear projection of every feature output.

    The features, CLS token and patch tokens all go through ``embed``, so
    the SSL heads size from ``embed_dim`` and the projection trains with the
    backbone. Parameters ``backbone.*`` and ``embed.*``, as the JAX scopes
    ``backbone`` and ``embed``: the bare backbone exports unchanged.
    """

    def __init__(self, backbone: nn.Module, in_dim: int, embed_dim: int,
                 dtype: torch.dtype = torch.float32,
                 supports_mask: bool = True):
        super().__init__()
        self.backbone = backbone
        self.embed = Linear(in_dim, embed_dim, dtype=dtype)
        self.supports_mask = supports_mask

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.backbone.reset_parameters(generator)
        self.embed.reset_parameters(generator)

    def forward(self, images: torch.Tensor,
                mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, torch.Tensor]:
        kwargs = {"train": train, "generator": generator}
        if self.supports_mask:
            kwargs["mask"] = mask
        out = dict(self.backbone(images, **kwargs))
        for key in ("features", "cls_token", "patch_tokens"):
            if out.get(key) is not None:
                out[key] = self.embed(out[key])
        return out


def project_wrapped(wrapped: WrappedModel, embed_dim: int,
                    dtype: torch.dtype) -> WrappedModel:
    """``wrapped`` with every feature output projected to ``embed_dim``."""
    module = ProjectedFeaturesModule(wrapped.module, wrapped.feature_dim,
                                     embed_dim, dtype, wrapped.supports_mask)
    return dataclasses.replace(wrapped, module=module, feature_dim=embed_dim)
