"""The file list's lifecycle: its path, a reference count, reuse.

Port of ``lightly_train_tpu/_data/mmap_lifecycle.py``:

- The file list lives in the cache's ``data`` folder under the sha256 of
  the run's ``out`` dir (or of ``data`` under
  ``LIGHTLY_TRAIN_MMAP_REUSE_FILE=1``) and the node rank, so every process
  of a run on a node finds the same path without talking to the others.
- A ``.ref_count`` file beside it, under a lock on a ``.lock`` file,
  counts the processes using it; the last one out deletes both, unless
  reuse mode keeps them as a cache across runs. The lock is ``fcntl``'s
  ``flock`` (the JAX package takes ``filelock``'s, a package the port
  does not depend on).
- A file list that exists already, without ``resume_interrupted`` or
  ``overwrite``, means another run (or a crashed one) owns the out dir,
  which is an error.

The node rank is ``torch.distributed``'s rank where a process group is
initialised, else 0. The file has the port's own suffix
(``memory_mapped_sequence.SUFFIX``).
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import time
from pathlib import Path
from typing import Any, Generator, Union

from lightly_train_tpu_torch._data.memory_mapped_sequence import SUFFIX
from lightly_train_tpu_torch._env import Env
from lightly_train_tpu_torch._logging import get_logger
from lightly_train_tpu_torch.parallel.distributed import process_index

logger = get_logger("mmap")


def _data_cache_dir() -> Path:
    d = Path(Env.LIGHTLY_TRAIN_CACHE_DIR.value) / "data"
    d.mkdir(parents=True, exist_ok=True)
    return d


@contextlib.contextmanager
def _file_lock(path: Path, timeout: float = 300.0) -> Generator[None, None,
                                                                 None]:
    """An exclusive ``flock`` on ``path`` (created if missing), waited for
    up to ``timeout`` seconds."""
    with open(path, "a") as f:
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"could not lock {path}") from None
                time.sleep(0.05)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _increment_ref_count(ref_file: Path) -> None:
    with _file_lock(ref_file.with_suffix(".lock")):
        ref_file.touch()
        with open(ref_file, "r+") as f:
            count = int(f.read() or "0")
            f.seek(0)
            f.write(str(count + 1))
            f.truncate()


def _decrement_and_cleanup_if_zero(mmap_file: Path, ref_file: Path) -> None:
    try:
        with _file_lock(ref_file.with_suffix(".lock")):
            with open(ref_file, "r+") as f:
                count = max(0, int(f.read() or "1") - 1)
                f.seek(0)
                f.write(str(count))
                f.truncate()
            if count <= 0 and not Env.LIGHTLY_TRAIN_MMAP_REUSE_FILE.value:
                for p in (mmap_file, ref_file):
                    with contextlib.suppress(FileNotFoundError, OSError):
                        p.unlink()
    except (FileNotFoundError, OSError):
        pass  # another process cleaned up already


@contextlib.contextmanager
def dataset_mmap_path(
    data: Union[str, Path, Any],
    out: Union[str, Path],
    resume_interrupted: bool,
    overwrite: bool,
) -> Generator[Path, None, None]:
    """Yields the run's file-list path, counted while the run uses it."""
    if Env.LIGHTLY_TRAIN_MMAP_REUSE_FILE.value:
        if isinstance(data, (str, Path)):
            data = Path(data).resolve()
        identifier = f"{data}-{process_index()}"
    else:
        identifier = f"{Path(out).resolve()}-{process_index()}"
    digest = hashlib.sha256(identifier.encode()).hexdigest()
    mmap_filepath = (_data_cache_dir() / digest).with_suffix(SUFFIX)
    ref_count_filepath = mmap_filepath.with_suffix(".ref_count")

    if (
        not Env.LIGHTLY_TRAIN_MMAP_REUSE_FILE.value
        and not resume_interrupted
        and not overwrite
        and mmap_filepath.exists()
    ):
        raise RuntimeError(
            f"Detected multiple runs using output directory '{out}' "
            "concurrently! This can also happen if a previous run crashed "
            "without shutting down. If no other run is using this output "
            "directory, delete the leftover files:\n"
            f"  - {mmap_filepath}\n  - {ref_count_filepath}"
        )

    _increment_ref_count(ref_count_filepath)
    try:
        yield mmap_filepath
    finally:
        _decrement_and_cleanup_if_zero(mmap_filepath, ref_count_filepath)
