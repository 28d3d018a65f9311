"""Carry the JAX package's parameters and method state into the port.

``params_from_jax`` turns a Flax parameter tree, given as nested dicts of
numpy arrays, into a PyTorch state dict for the port's modules:

- Dense ``kernel`` (in, out) -> ``weight`` (out, in); ``bias`` unchanged;
- the patch-embed Conv kernel HWIO -> OIHW;
- LayerNorm ``scale`` -> ``weight``;
- q/k/v stay separate projections (both packages split them);
- ``WeightNormDense`` keeps ``v`` (transposed to (out, in)) and ``g``;
- ``block{i}`` -> ``blocks.{i}``, head ``mlp{i}`` -> ``mlp.{i}``;
- scope names stay, so an ``embed_dim`` model's ``backbone/...`` and
  ``embed/kernel|bias`` become ``backbone.*`` and ``embed.weight|bias``,
  a SwiGLU FFN's ``mlp/w1|w2|w3`` become ``mlp.w1|w2|w3``, and
  distillation's ``global_head/proj`` and ``local_head/proj`` become
  ``global_head.proj`` and ``local_head.proj``;
- a DINOv3 ViT's leaves carry over as they are: its ``register_tokens``,
  and the ``k`` projection without ``bias`` and the model without
  ``pos_embed`` have nothing to carry.

It takes numpy only and imports nothing of JAX.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def _convert_leaf(name: str, value: np.ndarray):
    parts = name.split(".")
    leaf = parts[-1]
    if leaf == "kernel":
        parts[-1] = "weight"
        if value.ndim == 4:  # HWIO conv -> OIHW
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"unexpected kernel rank at {name}: {value.shape}")
    elif leaf == "scale":
        parts[-1] = "weight"
    elif leaf == "v":
        value = value.T
    path = ".".join(parts)
    path = re.sub(r"(^|\.)block(\d+)(?=\.)", r"\1blocks.\2", path)
    path = re.sub(r"(^|\.)mlp(\d+)(?=\.)", r"\1mlp.\2", path)
    return path, value


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict (float32 tensors) for a Flax parameter tree of numpy
    arrays: a ViT's params, or a method's tree (DINOv2's ``{"student",
    "dino_head", "ibot_head"}``, distillation's ``{"student",
    "global_head", "local_head"}``)."""
    state = {}
    for name, value in _flatten(tree).items():
        path, value = _convert_leaf(name, value)
        state[path] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def method_state_from_jax(method_state: Mapping[str, Any]) -> Dict[str, Any]:
    """A method's state: the teacher tree becomes a state dict (DINOv2's EMA
    teacher params, or distillation's frozen teacher variables, whose
    ``params`` collection is unwrapped); DINOv2's ``dino_center`` and
    ``ibot_center`` and distillation's ``queue`` become float32 tensors,
    and distillation's ``queue_ptr`` and ``queue_filled`` host integers."""
    teacher = method_state["teacher"]
    if set(teacher) == {"params"}:
        teacher = teacher["params"]
    out: Dict[str, Any] = {"teacher": params_from_jax(teacher)}
    for key in ("dino_center", "ibot_center", "queue"):
        if key in method_state:
            out[key] = torch.from_numpy(
                np.array(method_state[key], dtype=np.float32))
    for key in ("queue_ptr", "queue_filled"):
        if key in method_state:
            out[key] = int(method_state[key])
    return out
