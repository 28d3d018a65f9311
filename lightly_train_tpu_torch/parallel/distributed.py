"""The process's place in a run.

Port of ``process_index`` and ``is_main_process`` of
``lightly_train_tpu/parallel/distributed.py``: the rank of
``torch.distributed`` where a process group is initialised, else 0 (one
process). The process group itself waits for ROADMAP item 7.6.
"""

from __future__ import annotations

import torch.distributed as dist


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    return process_index() == 0
