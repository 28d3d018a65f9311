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
  a SwiGLU FFN's ``mlp/w1|w2|w3`` become ``mlp.w1|w2|w3``,
  distillation's ``global_head/proj`` and ``local_head/proj`` become
  ``global_head.proj`` and ``local_head.proj``, and the two-layer heads of
  SimCLR, DenseCL and DetCon (``fc1``, ``fc2`` without bias) and the PaKA
  head of DINOv31 (``fc1``-``fc3``) keep their names;
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
    arrays: a ViT's params, or a method's tree (``student`` and the
    method's heads: DINOv2's ``dino_head`` and ``ibot_head``,
    distillation's ``global_head`` and ``local_head``, DINO's and SimCLR's
    ``head``, and so on)."""
    state = {}
    for name, value in _flatten(tree).items():
        path, value = _convert_leaf(name, value)
        state[path] = torch.from_numpy(np.array(value, dtype=np.float32))
    return state


def method_state_from_jax(method_state: Mapping[str, Any]) -> Dict[str, Any]:
    """A method's state: the teacher tree, where there is one, becomes a
    state dict (an EMA teacher's params: DINOv2's, DINO's, DINOv31's with
    its PaKA head, DenseCL's, DetCon-B's backbone and projector; or
    distillation's frozen teacher variables, whose ``params`` collection
    is unwrapped); the centers (DINOv2's ``dino_center`` and
    ``ibot_center``, DINO's ``center``) and the queues (distillation's
    ``queue``, DenseCL's ``queue_global`` and ``queue_dense``) become
    float32 tensors, and ``queue_ptr`` and ``queue_filled`` host
    integers."""
    out: Dict[str, Any] = {}
    if "teacher" in method_state:
        teacher = method_state["teacher"]
        if set(teacher) == {"params"}:
            teacher = teacher["params"]
        out["teacher"] = params_from_jax(teacher)
    for key in ("dino_center", "ibot_center", "center", "queue",
                "queue_global", "queue_dense"):
        if key in method_state:
            out[key] = torch.from_numpy(
                np.array(method_state[key], dtype=np.float32))
    for key in ("queue_ptr", "queue_filled"):
        if key in method_state:
            out[key] = int(method_state[key])
    return out
