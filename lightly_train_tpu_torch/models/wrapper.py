"""Model-wrapper protocol.

Port of ``lightly_train_tpu/models/wrapper.py``: every backbone exposes the
same feature-extraction contract. The JAX wrapper holds a Flax module and
pure functions over a variables tree; here the module owns its parameters:

  wrapped.module                                   -> nn.Module
  wrapped.forward_features(x, mask, train, gen)    -> {features, cls_token,
                                                       patch_tokens}
  wrapped.forward_pool(features)                   -> (B, D)
  wrapped.feature_dim                              -> D

Feature maps are (B, H, W, D) channels-last, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

FeatureDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WrappedModel:
    """A backbone + its feature contract metadata."""

    name: str
    module: nn.Module
    feature_dim: int
    patch_size: Optional[int] = None  # None for CNN backbones
    architecture: str = "transformer"
    supports_mask: bool = True

    def forward_features(
        self,
        images: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        module: Optional[nn.Module] = None,
    ) -> FeatureDict:
        """Run ``module`` (default: the wrapped one; the EMA teacher passes
        its copy) on (B, H, W, 3) images."""
        module = self.module if module is None else module
        kwargs = {"train": train, "generator": generator}
        if self.supports_mask:
            kwargs["mask"] = mask
        return module(images, **kwargs)

    def forward_pool(self, out: FeatureDict) -> torch.Tensor:
        """Pooled (B, D) embedding: the CLS token for ViTs, global average
        pooling of the feature map otherwise."""
        cls = out.get("cls_token")
        if cls is not None:
            return cls
        return out["features"].mean(dim=(1, 2))
