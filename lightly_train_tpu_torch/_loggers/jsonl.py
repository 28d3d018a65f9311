"""JSONL metrics logger.

Port of ``lightly_train_tpu/_loggers/jsonl.py``: appends one JSON object per
log call to ``<out>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict


class JSONLLogger:
    def __init__(self, out_dir: Path, filename: str = "metrics.jsonl"):
        self.path = Path(out_dir) / filename
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self.path, "a")

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        self._file.write(json.dumps({"hyperparams": params}, default=str) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
