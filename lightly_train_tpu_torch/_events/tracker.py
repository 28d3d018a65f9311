"""Usage events: the reference's event API, written to a local file only.

Port of ``lightly_train_tpu/_events/tracker.py``: ``track_event``,
``track_training_started`` and ``track_inference_started`` with the same
semantics. Events are disabled by default
(``LIGHTLY_TRAIN_EVENTS_DISABLED`` is true unless set otherwise); when
enabled they are appended to a local JSONL file
(``LIGHTLY_TRAIN_EVENTS_FILE``, by default ``<cache>/events.jsonl``) and
never sent over the network. Each event name is reported at most once a
minute, the queue holds at most 128 events, only the main process reports,
and an anonymous user id is kept under the cache dir. The device fields
come from ``torch.cuda``: ``platform`` is ``gpu`` where a card is visible,
else ``cpu``, and ``device_kind`` the first card's name.
"""

from __future__ import annotations

import json
import os
import platform
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from lightly_train_tpu_torch._env import Env
from lightly_train_tpu_torch.parallel.distributed import is_main_process

_RATE_LIMIT_SECONDS = 60.0
_MAX_QUEUE_SIZE = 128

_events: List[Dict[str, Any]] = []
_last_event_time: Dict[str, float] = {}
_user_id: Optional[str] = None


def _load_user_id() -> str:
    """A stable anonymous id kept under the cache dir."""
    path = Env.LIGHTLY_TRAIN_CACHE_DIR.value / "user_id"
    try:
        if path.exists():
            uid = path.read_text().strip()
            if uid:
                return uid
        uid = str(uuid.uuid4())
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(uid)
        return uid
    except OSError:
        return "anonymous"


def _get_system_info() -> Dict[str, Any]:
    import torch

    info: Dict[str, Any] = {
        "os": platform.system(),
        "python_version": platform.python_version(),
        "is_ci": _is_ci(),
        "is_container": _is_container(),
    }
    if torch.cuda.is_available():
        info["platform"] = "gpu"
        info["device_kind"] = torch.cuda.get_device_name(0)
    else:
        info["platform"] = "cpu"
        info["device_kind"] = platform.processor() or "cpu"
    return info


def _get_model_name(model: object) -> str:
    """The ``model_name`` attribute first, then the class name."""
    name = getattr(model, "model_name", None)
    if isinstance(name, str):
        return name
    if isinstance(model, str):
        return model
    return type(model).__name__


def _get_device_count(devices: Union[int, str, List[int]]) -> int:
    if isinstance(devices, int):
        return devices
    if isinstance(devices, list):
        return len(devices)
    import torch

    return max(torch.cuda.device_count(), 1)


def _is_ci() -> bool:
    return os.environ.get("CI") is not None


def _is_container() -> bool:
    if os.path.isfile("/.dockerenv") or os.path.isfile("/run/.containerenv"):
        return True
    if (os.environ.get("SINGULARITY_CONTAINER") is not None
            or os.environ.get("APPTAINER_CONTAINER") is not None):
        return True
    try:
        with open("/proc/self/cgroup", encoding="utf-8") as f:
            content = f.read()
        return ("docker" in content or "kubepods" in content
                or "containerd" in content)
    except OSError:
        return False


def _flush() -> None:
    """Appends the queued events to the local JSONL file."""
    global _events
    if not _events:
        return
    path = os.environ.get(
        "LIGHTLY_TRAIN_EVENTS_FILE",
        str(Env.LIGHTLY_TRAIN_CACHE_DIR.value / "events.jsonl"),
    )
    drained, _events = _events, []
    try:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            for e in drained:
                f.write(json.dumps(e) + "\n")
    except OSError:
        pass


def track_event(event_name: str, properties: Dict[str, Any]) -> None:
    """Queues an event (main process only, once a minute per name, at most
    128 queued) and flushes it to the file."""
    if not is_main_process():
        return
    now = time.time()
    if Env.LIGHTLY_TRAIN_EVENTS_DISABLED.value or (
        now - _last_event_time.get(event_name, -100.0) < _RATE_LIMIT_SECONDS
    ):
        return
    global _user_id
    if _user_id is None:
        _user_id = _load_user_id()
    if len(_events) >= _MAX_QUEUE_SIZE:
        return
    _last_event_time[event_name] = now
    import lightly_train_tpu_torch

    _events.append({
        "event": event_name,
        "distinct_id": _user_id,
        "properties": {
            **properties,
            **_get_system_info(),
            "version": getattr(lightly_train_tpu_torch, "__version__",
                               "unknown"),
        },
    })
    _flush()


def track_training_started(
    *,
    task_type: str,
    model: object,
    method: str,
    batch_size: Union[int, str],
    devices: Union[int, str, List[int]],
    epochs: Optional[Union[int, str]] = None,
    steps: Optional[Union[int, str]] = None,
) -> None:
    properties: Dict[str, Any] = {
        "task_type": task_type,
        "model_name": _get_model_name(model),
        "method": method,
        "batch_size": batch_size,
        "devices": _get_device_count(devices),
    }
    if epochs is not None:
        properties["epochs"] = epochs
    if steps is not None:
        properties["steps"] = steps
    track_event("training_started", properties)


def track_inference_started(
    *,
    task_type: str,
    model: object,
    batch_size: Optional[int] = None,
    devices: Union[int, str, List[int]] = 1,
) -> None:
    properties: Dict[str, Any] = {
        "task_type": task_type,
        "model_name": _get_model_name(model),
        "devices": _get_device_count(devices),
    }
    if batch_size is not None:
        properties["batch_size"] = batch_size
    track_event("inference_started", properties)
