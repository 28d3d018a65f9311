"""Checkpoints of the train state, and the exported inference artifact.

Port of ``lightly_train_tpu/_checkpoint/checkpoint.py``. The card has no
orbax, so both tiers are torch files:

- ``out/checkpoints/step_<n>.pt``: the resumable train state (step, student
  and method state, the updater's Adam moments and counter, the model and
  method names). Each is written to a temporary name in the same folder and
  renamed into place, so a run killed mid-save never leaves a newest
  checkpoint that cannot be read; the 2 newest are kept, as the JAX
  manager's ``max_to_keep=2``.
- ``out/exported_models/exported_last/``: ``metadata.json`` with the JAX
  artifact's keys, the bare backbone's state dict (``model.pt``) and, for a
  run with ``embed_dim``, the state dict of its linear embedding head
  (``embed_head.pt``: ``weight``, ``bias``).

Also :func:`merge_pretrained`, the port of ``_commands/train_task.py``'s
``_merge_pretrained`` over flat state dicts.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from lightly_train_tpu_torch._env import Env
from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch.errors import ConfigError

logger = get_logger("checkpoint")

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def _save_atomic(obj: Any, path: Path) -> None:
    """``torch.save`` to a temporary name beside ``path``, then rename."""
    tmp = path.with_name(f".{path.name}.tmp")
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _to_host(obj: Any) -> Any:
    """``obj`` with every tensor on the CPU and every module as its state
    dict, through nested dicts."""
    if isinstance(obj, nn.Module):
        obj = obj.state_dict()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj.detach().cpu() if isinstance(obj, torch.Tensor) else obj


class CheckpointManager:
    """Save and restore the train state as ``step_<n>.pt`` files."""

    def __init__(self, ckpt_dir: Path, max_to_keep: int = 2):
        self.ckpt_dir = Path(ckpt_dir).resolve()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list:
        return sorted(int(m.group(1)) for p in self.ckpt_dir.iterdir()
                      if (m := _STEP_FILE.fullmatch(p.name)))

    def path(self, step: int) -> Path:
        return self.ckpt_dir / f"step_{step}.pt"

    def save(self, step: int, state: Any, model: str, method: str) -> None:
        """Write ``state`` (a TrainState) as ``step_<step>.pt``; drop all
        but the ``max_to_keep`` newest."""
        _save_atomic(_to_host({
            "step": int(state.step),
            "model": model,
            "method": method,
            "params": state.params,
            "method_state": state.method_state,
            "optimizer": state.updater.state_dict(),
        }), self.path(step))
        for old in self._steps()[:-self.max_to_keep]:
            self.path(old).unlink(missing_ok=True)

    def wait(self) -> None:
        """Saves finish before :meth:`save` returns (the JAX manager's are
        asynchronous); nothing is left to wait for."""

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load checkpoint ``step`` (default: the newest) into ``state`` in
        place, on the devices its tensors are on; returns it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint found in {self.ckpt_dir}")
        ckpt = torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
        state.params.load_state_dict(ckpt["params"])
        for key, value in state.method_state.items():
            saved = ckpt["method_state"][key]
            if isinstance(value, nn.Module):
                value.load_state_dict(saved)
            else:
                value.copy_(saved)
        state.updater.load_state_dict(ckpt["optimizer"])
        state.step = ckpt["step"]
        return state

    def close(self) -> None:
        """Nothing to release (see :meth:`wait`)."""


def export_model(
    out_path: Path,
    model_name: str,
    backbone_state: Mapping[str, torch.Tensor],
    extra_meta: Optional[Dict[str, Any]] = None,
    embed_head: Optional[Mapping[str, torch.Tensor]] = None,
) -> None:
    """Write the inference artifact: ``model.pt`` (the bare backbone's state
    dict), ``embed_head.pt`` when given, and ``metadata.json`` last."""
    out_path = Path(out_path).resolve()
    out_path.mkdir(parents=True, exist_ok=True)
    _save_atomic(_to_host(dict(backbone_state)), out_path / "model.pt")
    if embed_head is not None:
        _save_atomic(_to_host(dict(embed_head)), out_path / "embed_head.pt")
    meta = {"model_name": model_name, "format_version": 1}
    if extra_meta:
        meta.update(extra_meta)
    tmp = out_path / ".metadata.json.tmp"
    tmp.write_text(json.dumps(meta, indent=2))
    os.replace(tmp, out_path / "metadata.json")
    logger.info("Exported model '%s' to %s", model_name, out_path)


def load_exported_model(path: Path) -> Dict[str, Any]:
    """Read an exported artifact: ``{**metadata, "state_dict": ...,
    "embed_head": ...}`` (``embed_head`` only where the artifact has one),
    tensors on the CPU."""
    path = Path(path).resolve()
    meta = json.loads((path / "metadata.json").read_text())
    out = {**meta, "state_dict": torch.load(
        path / "model.pt", map_location="cpu", weights_only=True)}
    if (path / "embed_head.pt").exists():
        out["embed_head"] = torch.load(path / "embed_head.pt",
                                       map_location="cpu", weights_only=True)
    return out


def resolve_pretrained_source(
    checkpoint: str,
) -> Tuple[Dict[str, torch.Tensor], str, Optional[Dict[str, torch.Tensor]]]:
    """A user ``checkpoint`` argument as (backbone state dict, the model
    name it was exported under, embed head state dict or None).

    Takes an exported-artifact folder. A raw torch ``.pt``/``.pth`` file
    (which the JAX package converts with ``models/convert.py``) and
    ``"auto"`` (a download of public weights) are not ported yet.
    """
    path = Path(checkpoint)
    if checkpoint == "auto" or path.is_file() or path.suffix in (".pt",
                                                                 ".pth"):
        raise NotImplementedError(
            f"checkpoint={checkpoint!r}: only an exported artifact folder "
            "(exported_models/exported_last) loads in the port; raw torch "
            "checkpoints and checkpoint='auto' wait for ROADMAP item 20."
        )
    artifact = load_exported_model(path)
    return (artifact["state_dict"], artifact["model_name"],
            artifact.get("embed_head"))


def merge_pretrained(
    init: Mapping[str, torch.Tensor], pretrained: Mapping[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """Key-wise overlay of ``pretrained`` onto ``init`` (state dicts).

    Keys only in ``init`` keep their value; keys only in ``pretrained`` are
    ignored. A shape mismatch is an error (a wrong checkpoint must not
    silently train from scratch), except for ``pos_embed`` (interpolated at
    run time) or under ``LIGHTLY_TRAIN_ALLOW_SHAPE_MISMATCH=1``: then the
    leaf keeps its init, with a warning.
    """
    out = dict(init)
    for name, value in pretrained.items():
        if name not in out:
            continue
        if out[name].shape != value.shape:
            if ("pos_embed" in name
                    or Env.LIGHTLY_TRAIN_ALLOW_SHAPE_MISMATCH.value == "1"):
                logger.warning(
                    "Pretrained param %s shape %s != model shape %s; keeping "
                    "fresh init for this leaf", name, tuple(value.shape),
                    tuple(out[name].shape))
                continue
            raise ConfigError(
                f"Pretrained checkpoint param '{name}' has shape "
                f"{tuple(value.shape)} but the model expects "
                f"{tuple(out[name].shape)}. This checkpoint does not match "
                "the model. Set LIGHTLY_TRAIN_ALLOW_SHAPE_MISMATCH=1 to keep "
                "the fresh init for mismatched leaves instead."
            )
        out[name] = value
    return out
