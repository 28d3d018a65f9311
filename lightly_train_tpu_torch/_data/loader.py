"""Host-side data loader feeding the device augmentation stage.

Port of ``lightly_train_tpu/_data/loader.py`` for one process: a thread pool
decodes images to canonical uint8 batches, a background producer keeps
``prefetch`` batches in flight, and each batch is collated into pinned host
memory and copied to the device without blocking the host. A dataset with
``mask_dir`` yields ``{"images", "masks"}`` items, collated key by key.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

import numpy as np
import torch

from lightly_train_tpu_torch._data.image_dataset import ImageDataset

logger = logging.getLogger("lightly_train_tpu_torch.data")


def _to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(batch)
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def _collate(items: list, device: torch.device):
    """Stack decoded items into one device batch: a tensor, or a dict of
    tensors for dict items."""
    if isinstance(items[0], dict):
        return {k: _to_device(np.stack([it[k] for it in items]), device)
                for k in items[0]}
    return _to_device(np.stack(items), device)


class PretrainLoader:
    """Infinite shuffled loader of uint8 (B, H0, W0, 3) device batches
    (``{"images", "masks"}`` with the int32 (B, H0, W0) masks where the
    dataset has ``mask_dir``)."""

    def __init__(
        self,
        dataset: ImageDataset,
        batch_size: int,
        device: torch.device,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        # On resume: the batches steps [0, start_step) consumed are skipped
        # in the index stream, undecoded, so the run goes on with the same
        # images in the same order.
        self.start_step = 0

    def _index_stream(self) -> Iterator[np.ndarray]:
        """Index arrays of batch_size, reshuffled every epoch, from batch
        ``start_step`` on; a dataset smaller than a batch is tiled so
        batches keep their full shape."""
        n = len(self.dataset)
        epoch = 0
        skip = self.start_step
        while True:
            perm = np.random.default_rng(self.seed + epoch).permutation(n)
            if len(perm) < self.batch_size:
                perm = np.tile(perm, -(-self.batch_size // len(perm)))
            usable = len(perm) - len(perm) % self.batch_size
            for start in range(0, usable, self.batch_size):
                if skip:
                    skip -= 1
                    continue
                yield perm[start:start + self.batch_size]
            epoch += 1

    def __iter__(self) -> Iterator[torch.Tensor]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                  thread_name_prefix="lt-decode")

        def offer(item) -> bool:
            """Bounded put that re-checks stop, so an abandoned iterator
            never leaves the producer parked on a full queue."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                stream = self._index_stream()
                window = [
                    [pool.submit(self.dataset.__getitem__, int(i))
                     for i in next(stream)]
                    for _ in range(self.prefetch + 1)
                ]
                while not stop.is_set():
                    futures = window.pop(0)
                    batch = _collate([f.result() for f in futures],
                                     self.device)
                    if not offer(batch):
                        return
                    window.append([pool.submit(self.dataset.__getitem__,
                                               int(i)) for i in next(stream)])
            except Exception as e:  # surfaced to the consumer
                if not stop.is_set():
                    offer(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)
            thread.join(timeout=5.0)


class SyntheticLoader:
    """Random-image loader for runs without a data directory."""

    def __init__(self, batch_size: int, device: torch.device,
                 canonical_hw: Tuple[int, int] = (256, 256), seed: int = 0):
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.canonical_hw = canonical_hw
        self.seed = seed

    def __iter__(self) -> Iterator[torch.Tensor]:
        h, w = self.canonical_hw
        batch = np.random.default_rng(self.seed).integers(
            0, 256, size=(self.batch_size, h, w, 3), dtype=np.uint8)
        on_device = _to_device(batch, self.device)
        while True:
            yield on_device
