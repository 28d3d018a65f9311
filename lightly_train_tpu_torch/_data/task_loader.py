"""The validation loader of the fine-tuning tasks.

Port of ``lightly_train_tpu/_data/task_loader.py::TaskValLoader`` for one
process. Training reads ``_data/loader.py::PretrainLoader``, whose index
stream (``default_rng(seed + epoch).permutation``, a dataset smaller than a
batch tiled, the tail dropped, the ``start_step`` skip) is the JAX task
loader's too.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator

import numpy as np
import torch

from lightly_train_tpu_torch._data.loader import _collate, _to_device


class TaskValLoader:
    """One pass in order over dict items, the last batch padded with index
    0 and flagged by ``valid`` (bool (B,))."""

    def __init__(self, dataset: Any, batch_size: int, device: torch.device,
                 num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.num_workers = max(1, num_workers)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        n = len(self.dataset)
        with ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, n, self.batch_size):
                idx = np.arange(start, min(start + self.batch_size, n))
                pad = self.batch_size - len(idx)
                items = list(pool.map(
                    lambda i: self.dataset[int(i)],
                    np.concatenate([idx, np.zeros(pad, np.int64)])))
                batch = _collate(items, self.device)
                batch["valid"] = _to_device(np.concatenate(
                    [np.ones(len(idx), bool), np.zeros(pad, bool)]),
                    self.device)
                yield batch
