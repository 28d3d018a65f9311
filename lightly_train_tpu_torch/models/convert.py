"""Torch checkpoints (Meta DINOv2/DINOv3 and timm ViTs, DINOv3 ConvNeXts,
torchvision/timm ResNets, ultralytics YOLOs, EdgeCrafter ECViTs) -> the
port's state dict.

Port of ``lightly_train_tpu/models/convert.py``.
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
conversion carries into the port.

:func:`convert_torch_convnext_state_dict` (DINOv3 ConvNeXt naming) and
:func:`convert_torch_resnet_state_dict` (torchvision and timm ResNets, with
their BatchNorm running statistics) are the JAX package's too; the loader
picks among the three as the JAX one does (``convnext`` in the model name,
then ``resnet`` in it or a ``conv1.weight`` in the file, else the ViT).

:func:`convert_ultralytics_state_dict` (YOLOv8), :func:`convert_yolov5_state_dict`
and :func:`convert_yolo11_state_dict` rename ultralytics' ``model.model.{i}.*``
(or ``model.{i}.*``) keys onto ``layer{i}``, with the running statistics;
:func:`convert_yolov8_to_ultralytics_state_dict` is the inverse for the
port's YOLOv8 state dict; :func:`convert_ecvit_state_dict` takes an
EdgeCrafter ``ECViTModelWrapper`` state dict (``backbone.*``,
``projector.*``), its fused qkv split into q, k and v. The loader routes
``ultralytics/*`` and ``ecvit/*`` names to them, as the JAX one does. A
pickled ultralytics module cannot be read with ``weights_only=True``, in
either package; its state dict can.

The other way, for ``export``: :func:`params_to_jax` turns the port's state
dict back into the Flax parameter tree (the inverse of
``from_jax.params_from_jax``), and :func:`convert_flax_vit_to_torch_state_dict`
(the JAX package's, copied) writes a DINOv2/DINOv3 ViT's tree with Meta's
names.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch.models.from_jax import variables_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model

logger = get_logger("convert")


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


def convert_torch_convnext_state_dict(
    state_dict: Mapping[str, Any], depths: Sequence[int]
) -> Dict[str, Any]:
    """DINOv3 ConvNeXt torch state dict -> Flax params for the ConvNeXt.

    Torch naming: ``downsample_layers.0.{0,1}`` stem conv+LN,
    ``downsample_layers.i.{0,1}`` LN+conv, ``stages.i.j.{dwconv,norm,
    pwconv1,pwconv2,gamma}``, final ``norm``. Conv kernels transpose
    (O,I,kh,kw) -> (kh,kw,I,O); the depthwise kernel (C,1,7,7) ->
    (7,7,1,C).
    """
    sd = {k: _t(v) for k, v in state_dict.items()}
    params: Dict[str, Any] = {
        "stem_conv": {
            "kernel": sd["downsample_layers.0.0.weight"].transpose(2, 3, 1, 0),
            "bias": sd["downsample_layers.0.0.bias"],
        },
        "stem_norm": {"scale": sd["downsample_layers.0.1.weight"],
                      "bias": sd["downsample_layers.0.1.bias"]},
        "norm": {"scale": sd["norm.weight"], "bias": sd["norm.bias"]},
    }
    for i in range(1, 4):
        params[f"down{i}_norm"] = {
            "scale": sd[f"downsample_layers.{i}.0.weight"],
            "bias": sd[f"downsample_layers.{i}.0.bias"],
        }
        params[f"down{i}_conv"] = {
            "kernel": sd[f"downsample_layers.{i}.1.weight"].transpose(
                2, 3, 1, 0),
            "bias": sd[f"downsample_layers.{i}.1.bias"],
        }
    for stage, depth in enumerate(depths):
        for b in range(depth):
            p = f"stages.{stage}.{b}."
            params[f"stage{stage}_block{b}"] = {
                "dwconv": {
                    "kernel": sd[f"{p}dwconv.weight"].transpose(2, 3, 1, 0),
                    "bias": sd[f"{p}dwconv.bias"],
                },
                "norm": {"scale": sd[f"{p}norm.weight"],
                         "bias": sd[f"{p}norm.bias"]},
                "pwconv1": {"kernel": sd[f"{p}pwconv1.weight"].T,
                            "bias": sd[f"{p}pwconv1.bias"]},
                "pwconv2": {"kernel": sd[f"{p}pwconv2.weight"].T,
                            "bias": sd[f"{p}pwconv2.bias"]},
                "gamma": sd[f"{p}gamma"],
            }
    return params


def convert_torch_resnet_state_dict(
    state_dict: Mapping[str, Any], stage_sizes: Sequence[int]
) -> Dict[str, Any]:
    """torchvision/timm ResNet state dict -> Flax variables.

    Naming (shared by torchvision and timm resnets): ``conv1``/``bn1``
    stem, ``layer{s+1}.{b}.conv{k}``/``bn{k}`` blocks,
    ``layer{s+1}.{b}.downsample.0/1`` projection shortcuts. The ``fc``
    classifier head is dropped. Returns ``{"params": ..., "batch_stats":
    ...}``.
    """
    sd = {k: _t(v) for k, v in state_dict.items()}

    def conv(prefix: str) -> Dict[str, Any]:
        return {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0)}

    def bn(prefix: str):
        p = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
        s = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
        return p, s

    params: Dict[str, Any] = {"stem_conv": conv("conv1")}
    stats: Dict[str, Any] = {}
    params["stem_bn"], stats["stem_bn"] = bn("bn1")
    for s, n_blocks in enumerate(stage_sizes):
        for b in range(n_blocks):
            tp = f"layer{s + 1}.{b}"
            name = f"stage{s}_block{b}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            for k in (1, 2, 3):
                if f"{tp}.conv{k}.weight" not in sd:
                    break
                bp[f"conv{k}"] = conv(f"{tp}.conv{k}")
                bp[f"bn{k}"], bs[f"bn{k}"] = bn(f"{tp}.bn{k}")
            if f"{tp}.downsample.0.weight" in sd:
                bp["down_conv"] = conv(f"{tp}.downsample.0")
                bp["down_bn"], bs["down_bn"] = bn(f"{tp}.downsample.1")
            params[name] = bp
            stats[name] = bs
    return {"params": params, "batch_stats": stats}


def load_torch_checkpoint_for_model(
    checkpoint_path: Path, model_name: str
) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``model_name`` from a torch checkpoint,
    bare or as ``{"model": sd}``, its names optionally prefixed ``module.``
    or ``backbone.``: a DINOv3 ConvNeXt's, a torchvision/timm ResNet's
    (its running statistics become the BatchNorm buffers) or a Meta
    DINOv2/DINOv3 or timm ViT's; for an ``ultralytics/*`` name an
    ultralytics YOLOv8, YOLOv5 or YOLO11 state dict, for an ``ecvit/*`` one
    an EdgeCrafter one (names kept whole)."""
    with torch.device("meta"):
        cfg = get_wrapped_model(model_name).module.cfg
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt and not hasattr(
        ckpt["model"], "numpy"
    ):
        ckpt = ckpt["model"]
    if model_name.startswith("ultralytics/"):
        sd = {k: v.float().numpy() for k, v in ckpt.items()}
        short = model_name.split("/", 1)[1]
        if short.startswith("yolov5"):
            variables = convert_yolov5_state_dict(sd, {
                i: cfg.n({2: 3, 4: 6, 6: 9, 8: 3}[i]) for i in (2, 4, 6, 8)})
        elif short.startswith("yolo11"):
            variables = convert_yolo11_state_dict(
                sd, {i: cfg.n(2) for i in (2, 4, 6, 8, 10)})
        else:
            variables = convert_ultralytics_state_dict(sd, {
                i: cfg.n(3 if i in (2, 8) else 6) for i in (2, 4, 6, 8)})
    elif model_name.startswith("ecvit/"):
        # ECViTModelWrapper checkpoints keep the backbone. prefix.
        sd = {k: v.float().numpy() for k, v in ckpt.items()}
        variables = convert_ecvit_state_dict(
            sd, cfg.depth, 1 if cfg.proj_dim is None else 3)
    else:
        sd = {
            k.removeprefix("module.").removeprefix("backbone."):
                v.float().numpy()
            for k, v in ckpt.items()
        }
        if "convnext" in model_name:
            variables = {"params": convert_torch_convnext_state_dict(
                sd, cfg.depths)}
        elif "resnet" in model_name or "conv1.weight" in sd:
            # The torchvision/timm ResNet layout (both name it so).
            variables = convert_torch_resnet_state_dict(sd, cfg.stage_sizes)
        else:
            variables = {"params": convert_torch_vit_state_dict(
                sd, cfg.depth)}
    state = variables_from_jax(variables)
    logger.info("Converted %d torch tensors for %s", len(sd), model_name)
    return state


# ---------------------------------------------------------------------------
# ultralytics YOLOv8, YOLOv5 and YOLO11 (models/yolo.py)
# ---------------------------------------------------------------------------


class _ConvUnits:
    """Flax variables of ultralytics ``Conv`` units (conv + bn), filled by
    :meth:`put` from a state dict with ``model.model.`` / ``model.``
    stripped from its keys."""

    def __init__(self, state_dict: Mapping[str, Any]):
        self.sd = {k.removeprefix("model.model.").removeprefix("model."):
                   _t(v) for k, v in state_dict.items()}
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    def put(self, layer: str, sub: Tuple[str, ...], prefix: str) -> None:
        """The unit ``prefix.{conv,bn}`` at ``layer/sub...``."""
        sd = self.sd
        p = {"conv": {"kernel": sd[f"{prefix}.conv.weight"].transpose(
                 2, 3, 1, 0)},
             "bn": {"scale": sd[f"{prefix}.bn.weight"],
                    "bias": sd[f"{prefix}.bn.bias"]}}
        s = {"bn": {"mean": sd[f"{prefix}.bn.running_mean"],
                    "var": sd[f"{prefix}.bn.running_var"]}}
        dp = self.params.setdefault(layer, {})
        ds = self.stats.setdefault(layer, {})
        for part in sub:
            dp, ds = dp.setdefault(part, {}), ds.setdefault(part, {})
        dp.update(p)
        ds.update(s)

    def variables(self) -> Dict[str, Any]:
        return {"params": self.params, "batch_stats": self.stats}


def convert_ultralytics_state_dict(
    state_dict: Mapping[str, Any], n_per_c2f: Mapping[int, int]
) -> Dict[str, Any]:
    """ultralytics YOLOv8 checkpoint -> Flax variables of the YOLOv8
    backbone (layers 0-9). ``n_per_c2f`` maps each C2f layer's index to its
    bottleneck count. Returns ``{"params": ..., "batch_stats": ...}``."""
    u = _ConvUnits(state_dict)
    for i in (0, 1, 3, 5, 7):  # plain Conv layers
        u.put(f"layer{i}", (), str(i))
    for i in (2, 4, 6, 8):  # C2f layers
        u.put(f"layer{i}", ("cv1",), f"{i}.cv1")
        u.put(f"layer{i}", ("cv2",), f"{i}.cv2")
        for j in range(n_per_c2f[i]):
            u.put(f"layer{i}", (f"m{j}", "cv1"), f"{i}.m.{j}.cv1")
            u.put(f"layer{i}", (f"m{j}", "cv2"), f"{i}.m.{j}.cv2")
    u.put("layer9", ("cv1",), "9.cv1")
    u.put("layer9", ("cv2",), "9.cv2")
    return u.variables()


def convert_yolov5_state_dict(
    state_dict: Mapping[str, Any], n_per_c3: Mapping[int, int]
) -> Dict[str, Any]:
    """ultralytics YOLOv5 checkpoint -> Flax variables of the YOLOv5
    backbone (layers 0-8; the SPPF at index 9 is dropped)."""
    u = _ConvUnits(state_dict)
    for i in (0, 1, 3, 5, 7):
        u.put(f"layer{i}", (), str(i))
    for i in (2, 4, 6, 8):  # C3 layers
        for cv in ("cv1", "cv2", "cv3"):
            u.put(f"layer{i}", (cv,), f"{i}.{cv}")
        for j in range(n_per_c3[i]):
            u.put(f"layer{i}", (f"m{j}", "cv1"), f"{i}.m.{j}.cv1")
            u.put(f"layer{i}", (f"m{j}", "cv2"), f"{i}.m.{j}.cv2")
    return u.variables()


def convert_yolo11_state_dict(
    state_dict: Mapping[str, Any], n_per_block: Mapping[int, int],
    c3k_layers: tuple = (6, 8),
) -> Dict[str, Any]:
    """ultralytics YOLO11 checkpoint -> Flax variables of the YOLO11
    backbone (layers 0-10, SPPF and C2PSA included)."""
    u = _ConvUnits(state_dict)
    for i in (0, 1, 3, 5, 7):
        u.put(f"layer{i}", (), str(i))
    for i in (2, 4, 6, 8):  # C3k2 layers
        u.put(f"layer{i}", ("cv1",), f"{i}.cv1")
        u.put(f"layer{i}", ("cv2",), f"{i}.cv2")
        for j in range(n_per_block[i]):
            if i in c3k_layers:  # m{j} is a C3k: cv1-cv3 + 2 bottlenecks
                for cv in ("cv1", "cv2", "cv3"):
                    u.put(f"layer{i}", (f"m{j}", cv), f"{i}.m.{j}.{cv}")
                for b in range(2):
                    for cv in ("cv1", "cv2"):
                        u.put(f"layer{i}", (f"m{j}", f"m{b}", cv),
                              f"{i}.m.{j}.m.{b}.{cv}")
            else:
                u.put(f"layer{i}", (f"m{j}", "cv1"), f"{i}.m.{j}.cv1")
                u.put(f"layer{i}", (f"m{j}", "cv2"), f"{i}.m.{j}.cv2")
    u.put("layer9", ("cv1",), "9.cv1")
    u.put("layer9", ("cv2",), "9.cv2")
    u.put("layer10", ("cv1",), "10.cv1")  # C2PSA
    u.put("layer10", ("cv2",), "10.cv2")
    for j in range(n_per_block[10]):
        for name, torch_name in (("qkv", "attn.qkv"), ("proj", "attn.proj"),
                                 ("pe", "attn.pe")):
            u.put("layer10", (f"m{j}", "attn", name), f"10.m.{j}.{torch_name}")
        for name, torch_name in (("ffn0", "ffn.0"), ("ffn1", "ffn.1")):
            u.put("layer10", (f"m{j}", name), f"10.m.{j}.{torch_name}")
    return u.variables()


def convert_yolov8_to_ultralytics_state_dict(
    state_dict: Mapping[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`convert_ultralytics_state_dict` on the port's
    YOLOv8 state dict: ``model.{i}.*`` keys (``m{j}`` as ``m.{j}``, the
    BatchNorm buffers as ``running_mean`` / ``running_var``), loadable into
    an ultralytics ``DetectionModel`` with ``strict=False``."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        parts[0] = f"model.{parts[0].removeprefix('layer')}"
        parts = [f"m.{p[1:]}" if p[:1] == "m" and p[1:].isdigit() else p
                 for p in parts]
        parts[-1] = {"mean": "running_mean", "var": "running_var"}.get(
            parts[-1], parts[-1])
        out[".".join(parts)] = value.float()
    return out


# ---------------------------------------------------------------------------
# ECViT / EdgeCrafter (models/ecvit.py)
# ---------------------------------------------------------------------------


def convert_ecvit_state_dict(
    state_dict: Mapping[str, Any], depth: int, n_projector: int
) -> Dict[str, Any]:
    """EdgeCrafter ``ECViTModelWrapper`` state dict -> Flax variables of the
    ECViT: ``backbone.patch_embed.convs.{i}.{conv,norm}``,
    ``backbone.patch_embed.proj``, ``backbone.register_token``,
    ``backbone.blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
    mlp.fc2}`` (the fused qkv rows split into q, k and v) and
    ``projector.{i}.{conv,norm}``. Returns ``{"params": ...,
    "batch_stats": ...}``."""
    sd = {k: _t(v) for k, v in state_dict.items()}
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def conv_norm(dst: str, prefix: str) -> None:
        params[dst] = {
            "conv": {"kernel": sd[f"{prefix}.conv.weight"].transpose(
                2, 3, 1, 0)},
            "norm": {"scale": sd[f"{prefix}.norm.weight"],
                     "bias": sd[f"{prefix}.norm.bias"]},
        }
        stats[dst] = {"norm": {"mean": sd[f"{prefix}.norm.running_mean"],
                               "var": sd[f"{prefix}.norm.running_var"]}}

    for i in range(3):
        conv_norm(f"pe_conv{i}", f"backbone.patch_embed.convs.{i}")
    params["pe_proj"] = {
        "kernel": sd["backbone.patch_embed.proj.weight"].transpose(
            2, 3, 1, 0),
        "bias": sd["backbone.patch_embed.proj.bias"],
    }
    params["register_token"] = sd["backbone.register_token"]
    for i in range(depth):
        p = f"backbone.blocks.{i}."
        qkv_w = sd[f"{p}attn.qkv.weight"]  # (3D, D), rows [q; k; v]
        D = qkv_w.shape[1]
        attn = {
            "q": {"kernel": qkv_w[:D].T},
            "k": {"kernel": qkv_w[D:2 * D].T},
            "v": {"kernel": qkv_w[2 * D:].T},
            "proj": {"kernel": sd[f"{p}attn.proj.weight"].T,
                     "bias": sd[f"{p}attn.proj.bias"]},
        }
        if f"{p}attn.qkv.bias" in sd:
            b = sd[f"{p}attn.qkv.bias"]
            attn["q"]["bias"] = b[:D]
            attn["k"]["bias"] = b[D:2 * D]
            attn["v"]["bias"] = b[2 * D:]
        params[f"block{i}"] = {
            "norm1": {"scale": sd[f"{p}norm1.weight"],
                      "bias": sd[f"{p}norm1.bias"]},
            "norm2": {"scale": sd[f"{p}norm2.weight"],
                      "bias": sd[f"{p}norm2.bias"]},
            "attn": attn,
            "mlp": {
                "fc1": {"kernel": sd[f"{p}mlp.fc1.weight"].T,
                        "bias": sd[f"{p}mlp.fc1.bias"]},
                "fc2": {"kernel": sd[f"{p}mlp.fc2.weight"].T,
                        "bias": sd[f"{p}mlp.fc2.bias"]},
            },
        }
    for i in range(n_projector):
        conv_norm(f"projector{i}", f"projector.{i}")
    return {"params": params, "batch_stats": stats}


def _to_flax_leaf(name: str, value: np.ndarray) -> Tuple[list, np.ndarray]:
    """(Flax path, array) of one state-dict entry: the inverse of
    ``from_jax._convert_leaf``."""
    name = re.sub(r"(^|\.)blocks\.(\d+)(?=\.)", r"\1block\2", name)
    name = re.sub(r"(^|\.)mlp\.(\d+)(?=\.)", r"\1mlp\2", name)
    parts = name.split(".")
    if parts[-1] == "weight":
        if value.ndim == 4:  # OIHW -> HWIO (depthwise (C, 1, h, w) too)
            parts[-1], value = "kernel", value.transpose(2, 3, 1, 0)
        elif value.ndim == 2:  # (out, in) -> (in, out)
            parts[-1], value = "kernel", value.T
        elif value.ndim == 1:  # a norm's
            parts[-1] = "scale"
        else:
            raise ValueError(f"unexpected weight rank at {name}: "
                             f"{value.shape}")
    elif parts[-1] == "v":  # WeightNormDense's direction, (out, in)
        value = value.T
    return parts, value


def params_to_jax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The Flax parameter tree (nested dicts of float32 numpy arrays) of a
    state dict of the port's parameters (no buffers): ``weight`` (out, in)
    -> ``kernel`` (in, out), OIHW -> HWIO, a norm's 1-d ``weight`` ->
    ``scale``, ``v`` transposed back, ``blocks.{i}`` -> ``block{i}`` and
    ``mlp.{i}`` -> ``mlp{i}``; every other name, and 0-d leaves, as they
    are."""
    tree: Dict[str, Any] = {}
    for name, value in state.items():
        arr = value.detach().cpu().float().numpy() if isinstance(
            value, torch.Tensor) else np.asarray(value, np.float32)
        parts, arr = _to_flax_leaf(name, arr)
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return tree


def convert_flax_vit_to_torch_state_dict(
    params: Mapping[str, Any], depth: int
) -> Dict[str, np.ndarray]:
    """Flax VisionTransformer params -> Meta torch naming (the JAX
    package's inverse of :func:`convert_torch_vit_state_dict`), which
    ``export(format="torch_state_dict")`` writes for a DINOv2/DINOv3 ViT.
    The CLS entry of ``pos_embed`` was folded into ``cls_token`` at import;
    a zero row stands in its place (the same forward)."""
    p = {k: _np_tree(v) for k, v in params.items()}
    sd: Dict[str, np.ndarray] = {}
    d_model = p["cls_token"].shape[-1]
    sd["cls_token"] = p["cls_token"]
    sd["mask_token"] = p["mask_token"].reshape(1, d_model)
    if "pos_embed" in p:
        pos = p["pos_embed"]  # (1, N, D)
        sd["pos_embed"] = np.concatenate(
            [np.zeros((1, 1, d_model), np.float32), pos], axis=1
        )
    if "register_tokens" in p:
        key = "register_tokens" if "pos_embed" in p else "storage_tokens"
        sd[key] = p["register_tokens"]
    sd["patch_embed.proj.weight"] = p["patch_embed"]["kernel"].transpose(
        3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = p["patch_embed"]["bias"]
    for i in range(depth):
        b = p[f"block{i}"]
        o = f"blocks.{i}."
        sd[f"{o}norm1.weight"] = b["norm1"]["scale"]
        sd[f"{o}norm1.bias"] = b["norm1"]["bias"]
        sd[f"{o}norm2.weight"] = b["norm2"]["scale"]
        sd[f"{o}norm2.bias"] = b["norm2"]["bias"]
        attn = b["attn"]
        sd[f"{o}attn.qkv.weight"] = np.concatenate(
            [attn["q"]["kernel"].T, attn["k"]["kernel"].T,
             attn["v"]["kernel"].T], axis=0)
        if "bias" in attn["q"]:
            k_bias = attn.get("k", {}).get(
                "bias", np.zeros((d_model,), np.float32))
            sd[f"{o}attn.qkv.bias"] = np.concatenate(
                [attn["q"]["bias"], k_bias, attn["v"]["bias"]], axis=0)
        sd[f"{o}attn.proj.weight"] = attn["proj"]["kernel"].T
        sd[f"{o}attn.proj.bias"] = attn["proj"]["bias"]
        if "ls1" in b:
            sd[f"{o}ls1.gamma"] = b["ls1"]["gamma"]
            sd[f"{o}ls2.gamma"] = b["ls2"]["gamma"]
        mlp = b["mlp"]
        if "fc1" in mlp:
            sd[f"{o}mlp.fc1.weight"] = mlp["fc1"]["kernel"].T
            sd[f"{o}mlp.fc1.bias"] = mlp["fc1"]["bias"]
            sd[f"{o}mlp.fc2.weight"] = mlp["fc2"]["kernel"].T
            sd[f"{o}mlp.fc2.bias"] = mlp["fc2"]["bias"]
        else:  # SwiGLU
            sd[f"{o}mlp.w1.weight"] = mlp["w1"]["kernel"].T
            sd[f"{o}mlp.w2.weight"] = mlp["w2"]["kernel"].T
            sd[f"{o}mlp.w3.weight"] = mlp["w3"]["kernel"].T
            for name in ("w1", "w2", "w3"):
                if "bias" in mlp[name]:
                    sd[f"{o}mlp.{name}.bias"] = mlp[name]["bias"]
    sd["norm.weight"] = p["norm"]["scale"]
    sd["norm.bias"] = p["norm"]["bias"]
    return sd


def _np_tree(tree: Any) -> Any:
    """(Nested) arrays as float32 numpy."""
    if isinstance(tree, Mapping):
        return {k: _np_tree(v) for k, v in tree.items()}
    return _t(tree)
