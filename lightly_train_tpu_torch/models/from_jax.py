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
  ``embed/kernel|bias`` become ``backbone.*`` and ``embed.weight|bias``.

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
    arrays: a ViT's params, or a method's ``{"student", "dino_head",
    "ibot_head"}`` tree."""
    state = {}
    for name, value in _flatten(tree).items():
        path, value = _convert_leaf(name, value)
        state[path] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def method_state_from_jax(method_state: Mapping[str, Any]) -> Dict[str, Any]:
    """DINOv2 method state: the EMA teacher tree becomes a state dict; the
    ``dino_center`` and ``ibot_center`` vectors become tensors."""
    out: Dict[str, Any] = {"teacher": params_from_jax(method_state["teacher"])}
    for key in ("dino_center", "ibot_center"):
        out[key] = torch.from_numpy(
            np.array(method_state[key], dtype=np.float32))
    return out
