"""A user's own ``torch.nn.Module`` as a backbone, and the live timm and
ultralytics models.

Port of ``lightly_train_tpu/models/torch_bridge.py::wrap_torch_module``
with its feature adapter, and of ``models/torch_packages.py``. The JAX
package compiles a torch module's graph into XLA; here the module runs as
it is, on the run's device:

- its input is the port's (B, H, W, 3) batch permuted to NCHW and cast to
  the module's parameter dtype (its parameters stay as they are, fp32 in a
  bf16 run too, as the JAX bridge keeps them);
- it runs in train mode for the student and in eval mode otherwise, so its
  own buffers (an ``nn.BatchNorm2d``'s running statistics and
  ``num_batches_tracked``) move as torch moves them, which is what the JAX
  bridge runs; they travel with the student through the EMA teacher, the
  checkpoint, resume and the export;
- its output's last (B, C, H, W) map (:func:`pick_feature_map`, the JAX
  ``_pick_feature_map``) becomes ``features`` (B, H, W, C), with
  ``patch_tokens`` and the mean as ``cls_token``.

The module's weights at wrap time are its initial weights: a method's
``reset_parameters`` puts them back after the module is allocated on the
device. Its parameter names are the module's own under ``inner.``.
"""

from __future__ import annotations

import copy
import importlib.util
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.wrapper import WrappedModel


def pick_feature_map(result: Any) -> torch.Tensor:
    """The last 4-D (B, C, H, W) map of a module's output: a tensor, or the
    maps of lists, tuples and dicts (a dict's ``features`` entry where it
    has one) in order."""
    candidates: List[torch.Tensor] = []

    def visit(v: Any) -> None:
        if isinstance(v, torch.Tensor) and v.ndim == 4:
            candidates.append(v)
        elif isinstance(v, (list, tuple)):
            for u in v:
                visit(u)
        elif isinstance(v, dict):
            if "features" in v:
                visit(v["features"])
            else:
                for u in v.values():
                    visit(u)

    visit(result)
    if not candidates:
        raise ConfigError(
            "The torch module produced no 4D (B, C, H, W) feature map; wrap "
            "a features-only backbone (e.g. timm features_only=True).")
    return candidates[-1]


class TorchModuleBackbone(nn.Module):
    """``forward(images, train=False, generator=None)`` of a torch module
    ``inner`` on (B, H, W, 3) images: the port's feature dict."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner
        self.initial_state = {k: v.detach().cpu().clone()
                              for k, v in inner.state_dict().items()}

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The weights and buffers ``inner`` had when it was wrapped."""
        with torch.no_grad():
            for k, v in self.inner.state_dict().items():
                v.copy_(self.initial_state[k])

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                ) -> Dict[str, torch.Tensor]:
        param = next(self.inner.parameters(), None)
        dtype = torch.float32 if param is None else param.dtype
        self.inner.train(train)
        out = self.inner(images.permute(0, 3, 1, 2).to(dtype))
        feats = pick_feature_map(out).permute(0, 2, 3, 1)
        B, H, W, D = feats.shape
        return {
            "features": feats,
            "patch_tokens": feats.reshape(B, H * W, D),
            "cls_token": feats.mean(dim=(1, 2)),
        }


def _feature_dim(backbone: TorchModuleBackbone,
                 sample_hw: Tuple[int, int]) -> int:
    """The feature width of ``backbone`` on one zero image of
    ``sample_hw``, run in eval mode without gradients (its buffers stay as
    they are)."""
    param = next(backbone.inner.parameters(), None)
    device = torch.device("cpu") if param is None else param.device
    try:
        with torch.no_grad():
            out = backbone(torch.zeros((1, *sample_hw, 3), device=device))
    except ConfigError:
        raise
    except Exception as e:  # noqa: BLE001 - a user's module, any error
        raise ConfigError(
            f"torch module could not be run as a backbone: {e}") from e
    return int(out["features"].shape[-1])


def wrap_torch_module(module: nn.Module, name: Optional[str] = None,
                      sample_hw: Tuple[int, int] = (64, 64)) -> WrappedModel:
    """A torch backbone as a ``WrappedModel`` named ``torch/<class>``
    (lower case), its feature width found on a ``sample_hw`` input. The
    module itself is not changed: the backbone holds a copy."""
    backbone = TorchModuleBackbone(copy.deepcopy(module))
    return WrappedModel(
        name=name or f"torch/{type(module).__name__.lower()}",
        module=backbone,
        feature_dim=_feature_dim(backbone, sample_hw),
        patch_size=None,
        architecture="conv",
        supports_mask=False,
    )


def timm_available() -> bool:
    return importlib.util.find_spec("timm") is not None


def ultralytics_available() -> bool:
    return importlib.util.find_spec("ultralytics") is not None


def wrap_timm_model(model_name: str, **timm_kwargs: Any) -> WrappedModel:
    """``timm/<name>``: timm's ``features_only`` model of that name (not
    pretrained), wrapped at its configured input size."""
    import timm

    module = timm.create_model(model_name, pretrained=False,
                               features_only=True, **timm_kwargs)
    module.eval()
    cfg = getattr(module, "pretrained_cfg", None) or {}
    size = cfg.get("input_size", (3, 224, 224))
    return wrap_torch_module(module, name=f"timm/{model_name}",
                             sample_hw=(int(size[1]), int(size[2])))


class UltralyticsBackbone(nn.Module):
    """An ultralytics model's layers without the last (its head), routed as
    ultralytics' ``BaseModel`` routes them: each layer's ``f`` names its
    input (-1 the previous output, an index, or a list of them). Returns
    the deepest 4-D output."""

    def __init__(self, layers: Any):
        super().__init__()
        modules = list(layers)
        if not modules:
            raise ConfigError("ultralytics model has no layers")
        self.layers = nn.ModuleList(modules[:-1])
        self.froms = [getattr(m, "f", -1) for m in modules[:-1]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        saved: List[Any] = []
        out: Any = x
        for layer, f in zip(self.layers, self.froms):
            if f != -1:
                out = (saved[f] if isinstance(f, int)
                       else [out if j == -1 else saved[j] for j in f])
            out = layer(out)
            saved.append(out)
        for candidate in reversed(saved):
            if isinstance(candidate, torch.Tensor) and candidate.ndim == 4:
                return candidate
        raise ConfigError("ultralytics backbone produced no 4D feature map")


def wrap_ultralytics_model(model_name: str,
                           sample_hw: Tuple[int, int] = (640, 640)
                           ) -> WrappedModel:
    """``ultralytics/<name>``: the model ultralytics' ``YOLO(name)`` builds,
    cut before its head."""
    from ultralytics import YOLO

    det = YOLO(model_name).model
    det.eval()
    return wrap_torch_module(UltralyticsBackbone(det.model),
                             name=f"ultralytics/{model_name}",
                             sample_hw=sample_hw)
