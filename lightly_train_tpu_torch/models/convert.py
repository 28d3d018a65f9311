"""Meta DINOv2/DINOv3 and timm ViT torch checkpoints -> the port's state dict.

Port of the ViT part of ``lightly_train_tpu/models/convert.py``.
:func:`convert_torch_vit_state_dict` is the JAX package's converter, copied
as it is (numpy only): it maps a Meta-named state dict onto the JAX ViT's
parameter tree:

- ``patch_embed.proj.weight`` (D, 3, p, p) -> ``patch_embed.kernel``
  (p, p, 3, D);
- the fused ``blocks.{i}.attn.qkv.weight`` (3D, D) split into q, k and v,
  and DINOv3's ``qkv.bias_mask`` applied (its k projection has no bias);
- the CLS entry of ``pos_embed`` folded into ``cls_token``;
- ``register_tokens`` or DINOv3's ``storage_tokens``;
- ``ls1/ls2.gamma``, or identity gammas where a checkpoint has no
  LayerScale (timm);
- ``mlp.fc1/fc2``, DINOv2's fused SwiGLU ``w12``/``w3`` and DINOv3's
  ``w1/w2/w3``;
- FSDP-chunked ``blocks.{chunk}.{i}`` names.

:func:`load_torch_checkpoint_for_model` reads a ``.pth``/``.pt`` file for a
``dinov2/*`` or ``dinov3/*`` ViT and composes the converter with
``from_jax.params_from_jax``, so its state dict is the one the JAX package's
conversion carries into the port. The ConvNeXt, ResNet, ultralytics and
ECViT converters wait for their backbones (ROADMAP item 10).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch.models.from_jax import params_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model

logger = get_logger("convert")

# Name parts of the checkpoints whose backbones are not ported.
_UNPORTED = ("ultralytics/", "ecvit/", "convnext", "resnet")


def _t(x: Any) -> np.ndarray:
    arr = np.asarray(x, dtype=np.float32)
    return arr


def convert_torch_vit_state_dict(
    state_dict: Mapping[str, Any], depth: int
) -> Dict[str, Any]:
    """Meta DINOv2/v3 ViT state dict -> Flax params for VisionTransformer."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    params: Dict[str, Any] = {}

    cls = sd["cls_token"]  # (1, 1, D)
    if "pos_embed" in sd:  # DINOv2; DINOv3 is RoPE-only with no pos_embed
        pos = sd["pos_embed"]  # (1, 1+N, D) or (1, N, D)
        if pos.shape[1] % 2 == 1:  # has a CLS positional entry
            cls = cls + pos[:, :1]
            pos = pos[:, 1:]
        params["pos_embed"] = pos
    params["cls_token"] = cls
    params["mask_token"] = sd.get(
        "mask_token", np.zeros((1, cls.shape[-1]), np.float32)
    ).reshape(-1)
    if "register_tokens" in sd:
        params["register_tokens"] = sd["register_tokens"]
    elif "storage_tokens" in sd:  # DINOv3 naming
        params["register_tokens"] = sd["storage_tokens"]

    w = sd["patch_embed.proj.weight"]  # (D, 3, p, p)
    params["patch_embed"] = {
        "kernel": w.transpose(2, 3, 1, 0),
        "bias": sd["patch_embed.proj.bias"],
    }

    for i in range(depth):
        p = f"blocks.{i}."
        if f"{p}norm1.weight" not in sd:
            # FSDP block-chunked naming: blocks.{chunk}.{i}.*
            alt = [k for k in sd if k.startswith("blocks.") and
                   k.endswith(f".{i}.norm1.weight")]
            if alt:
                p = alt[0][: -len("norm1.weight")]
            else:
                raise KeyError(f"Missing block {i} in state dict")
        wqkv = sd[f"{p}attn.qkv.weight"]  # (3D, D), rows [q; k; v]
        d = wqkv.shape[0] // 3
        block: Dict[str, Any] = {
            "norm1": {"scale": sd[f"{p}norm1.weight"],
                      "bias": sd[f"{p}norm1.bias"]},
            "norm2": {"scale": sd[f"{p}norm2.weight"],
                      "bias": sd[f"{p}norm2.bias"]},
            "attn": {
                "q": {"kernel": wqkv[:d].T},
                "k": {"kernel": wqkv[d : 2 * d].T},
                "v": {"kernel": wqkv[2 * d :].T},
                "proj": {"kernel": sd[f"{p}attn.proj.weight"].T,
                         "bias": sd[f"{p}attn.proj.bias"]},
            },
        }
        if f"{p}attn.qkv.bias" in sd:
            bqkv = sd[f"{p}attn.qkv.bias"]
            if f"{p}attn.qkv.bias_mask" in sd:
                # DINOv3 LinearKMaskedBias (``attention.py:37-53``): the
                # effective bias is bias*mask with the k section masked to
                # zero — the Flax k projection has no bias parameter.
                bqkv = bqkv * sd[f"{p}attn.qkv.bias_mask"]
                block["attn"]["q"]["bias"] = bqkv[:d]
                block["attn"]["v"]["bias"] = bqkv[2 * d :]
            else:
                block["attn"]["q"]["bias"] = bqkv[:d]
                block["attn"]["k"]["bias"] = bqkv[d : 2 * d]
                block["attn"]["v"]["bias"] = bqkv[2 * d :]
        if f"{p}ls1.gamma" in sd:
            block["ls1"] = {"gamma": sd[f"{p}ls1.gamma"]}
            block["ls2"] = {"gamma": sd[f"{p}ls2.gamma"]}
        else:
            # No layerscale in the checkpoint (timm vanilla ViT / Meta
            # init_values=None): identity gammas so the Flax LayerScale is a
            # no-op rather than keeping its tiny fresh init.
            block["ls1"] = {"gamma": np.ones((d,), np.float32)}
            block["ls2"] = {"gamma": np.ones((d,), np.float32)}
        if f"{p}mlp.fc1.weight" in sd:
            block["mlp"] = {
                "fc1": {"kernel": sd[f"{p}mlp.fc1.weight"].T,
                        "bias": sd[f"{p}mlp.fc1.bias"]},
                "fc2": {"kernel": sd[f"{p}mlp.fc2.weight"].T,
                        "bias": sd[f"{p}mlp.fc2.bias"]},
            }
        elif f"{p}mlp.w12.weight" in sd:
            # DINOv2 SwiGLUFFNFused: split the fused w12 rows into w1/w2
            # (the Flax FFN uses separate projections, no strided split).
            w12 = sd[f"{p}mlp.w12.weight"]  # (2h, D), rows [w1; w2]
            h = w12.shape[0] // 2
            b12 = sd[f"{p}mlp.w12.bias"]
            block["mlp"] = {
                "w1": {"kernel": w12[:h].T, "bias": b12[:h]},
                "w2": {"kernel": w12[h:].T, "bias": b12[h:]},
                "w3": {"kernel": sd[f"{p}mlp.w3.weight"].T,
                       "bias": sd[f"{p}mlp.w3.bias"]},
            }
        else:  # DINOv3 SwiGLUFFN: w1/w2/w3 map directly
            block["mlp"] = {
                "w1": {"kernel": sd[f"{p}mlp.w1.weight"].T},
                "w2": {"kernel": sd[f"{p}mlp.w2.weight"].T},
                "w3": {"kernel": sd[f"{p}mlp.w3.weight"].T},
            }
            for name in ("w1", "w2", "w3"):
                if f"{p}mlp.{name}.bias" in sd:
                    block["mlp"][name]["bias"] = sd[f"{p}mlp.{name}.bias"]
        params[f"block{i}"] = block

    params["norm"] = {"scale": sd["norm.weight"], "bias": sd["norm.bias"]}
    return params


def load_torch_checkpoint_for_model(
    checkpoint_path: Path, model_name: str
) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``model_name`` from a torch checkpoint: a
    Meta DINOv2/DINOv3 or timm ViT state dict, bare or as ``{"model": sd}``,
    its names optionally prefixed ``module.`` or ``backbone.``."""
    if any(part in model_name for part in _UNPORTED):
        raise NotImplementedError(
            f"Converting a torch checkpoint for '{model_name}' waits for its "
            "backbone (ROADMAP item 10); the port converts dinov2/* and "
            "dinov3/* ViT checkpoints."
        )
    with torch.device("meta"):
        depth = get_wrapped_model(model_name).module.cfg.depth
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt and not hasattr(
        ckpt["model"], "numpy"
    ):
        ckpt = ckpt["model"]
    sd = {
        k.removeprefix("module.").removeprefix("backbone."):
            v.float().numpy()
        for k, v in ckpt.items()
    }
    if "conv1.weight" in sd:
        raise NotImplementedError(
            f"{checkpoint_path} holds a ResNet state dict: its conversion "
            "waits for the backbone (ROADMAP item 10)."
        )
    state = params_from_jax(convert_torch_vit_state_dict(sd, depth))
    logger.info("Converted %d torch tensors for %s", len(sd), model_name)
    return state
