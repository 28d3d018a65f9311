"""Optimizer arguments and per-parameter rules.

Port of ``lightly_train_tpu/_optim/optimizers.py`` for the slice: the AdamW
arguments and the per-parameter rules the DINOv2 update uses (weight-decay
masks and layerwise LR decay). Parameters are named by their PyTorch state
names (``student.blocks.3.attn.q.weight``); each rule gives the same answer
for a parameter as the JAX rule gives for its Flax path
(``student/block3/attn/q/kernel``). SGD, LARS and AdamW8bit wait
(ROADMAP item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Mapping, Tuple, Union

import torch

from lightly_train_tpu_torch._configs.config import AUTO, Auto, Config


@dataclasses.dataclass
class OptimizerArgs(Config):
    type: str = "adamw"
    lr: Union[float, Auto] = AUTO
    weight_decay: float = 0.0


@dataclasses.dataclass
class AdamWArgs(OptimizerArgs):
    type: Literal["adamw"] = "adamw"
    lr: Union[float, Auto] = AUTO
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 1e-2


OPTIMIZER_ARGS_TYPES = {"adamw": AdamWArgs}
# Every optimizer name the JAX package takes (its OPTIMIZER_ARGS_TYPES): a
# name here but not above is not ported yet, any other is unknown.
JAX_OPTIMIZERS = ("adamw", "adamw8bit", "lars", "sgd")

# Names exempt from weight decay in the generic task rule.
_NO_DECAY_NAMES = ("cls_token", "mask_token", "register_tokens", "pos_embed",
                   "queries")


def no_weight_decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """False for 1-D params (biases, norm scales, layerscale gammas) and for
    tokens / position embeddings; True elsewhere (the generic task rule)."""
    return {
        name: p.ndim > 1 and name.split(".")[-1] not in _NO_DECAY_NAMES
        for name, p in params.items()
    }


def dinov2_wd_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """The reference DINOv2 weight-decay rule: decay everything EXCEPT params
    whose name ends with ``bias``, or whose name contains ``norm`` or
    ``gamma``. Tokens, the position embedding, the patch-embed kernel and the
    weight-norm prototype gain all decay."""
    out = {}
    for name in params:
        parts = name.split(".")
        out[name] = not (
            parts[-1] == "bias" or "norm" in name or "gamma" in name
        )
    return out


def layerwise_lr_scales(
    params: Mapping[str, torch.Tensor],
    decay: float,
    num_layers: int,
    patch_embed_multiplier: float = 1.0,
) -> Dict[str, float]:
    """Per-parameter LR multipliers implementing DINOv2 layerwise decay.

    ``blocks.{i}`` params get ``decay^(num_layers - i)``; embedding-level
    params (patch_embed, pos_embed, cls/register/mask tokens) get
    ``decay^(num_layers + 1)``, times ``patch_embed_multiplier`` for
    patch_embed params only; everything else (final norm, heads) gets 1.0.
    """
    out = {}
    for name in params:
        parts = name.split(".")
        scale = 1.0
        for i, part in enumerate(parts[:-1]):
            if part == "blocks" and parts[i + 1].isdigit():
                scale = float(decay ** (num_layers - int(parts[i + 1])))
                break
        else:
            if any(n in name for n in ("patch_embed", "pos_embed", "cls_token",
                                       "mask_token", "register_tokens")):
                scale = float(decay ** (num_layers + 1))
                if "patch_embed" in name:
                    scale *= patch_embed_multiplier
        out[name] = scale
    return out
