"""Optimizer arguments and per-parameter rules.

Port of ``lightly_train_tpu/_optim/optimizers.py``: the AdamW, SGD and
LARS arguments and the per-parameter rules of the updates (weight-decay
masks and layerwise LR decay); the update chain itself is in ``update.py``
(and, for AdamW with an EMA teacher, ``fused_update.py``). Parameters are
named by their PyTorch state names (``student.blocks.3.attn.q.weight``);
each rule gives the same answer for a parameter as the JAX rule gives for
its Flax path (``student/block3/attn/q/kernel``). AdamW8bit's arguments are in
``adamw8bit.py``, registered here as in the JAX package.
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


@dataclasses.dataclass
class SGDArgs(OptimizerArgs):
    type: Literal["sgd"] = "sgd"
    lr: Union[float, Auto] = AUTO
    momentum: float = 0.9
    weight_decay: float = 0.0


@dataclasses.dataclass
class LARSArgs(OptimizerArgs):
    type: Literal["lars"] = "lars"
    lr: Union[float, Auto] = AUTO
    momentum: float = 0.9
    weight_decay: float = 0.0
    trust_coefficient: float = 0.001


OPTIMIZER_ARGS_TYPES = {"adamw": AdamWArgs, "sgd": SGDArgs, "lars": LARSArgs}
# Every optimizer name the JAX package takes (its OPTIMIZER_ARGS_TYPES): a
# name here but not in OPTIMIZER_ARGS_TYPES is not ported yet, any other is
# unknown.
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


# Registered here (bottom) to avoid a circular import with adamw8bit.py.
from lightly_train_tpu_torch._optim.adamw8bit import (  # noqa: E402
    AdamW8bitArgs,
)

OPTIMIZER_ARGS_TYPES["adamw8bit"] = AdamW8bitArgs
