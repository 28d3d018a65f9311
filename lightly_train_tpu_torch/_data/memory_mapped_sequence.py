"""A file list written once and memory-mapped by every reader.

Port of ``lightly_train_tpu/_data/memory_mapped_sequence.py``. The JAX
package writes an Arrow IPC file through ``pyarrow``, which the port does
not depend on; the port writes its own format, under its own suffix
(``.filelist``), so a JAX ``.arrow`` file is never read as one of the
port's:

- 8 bytes: ``LTFLIST1``;
- a little-endian uint64: the item count n;
- n + 1 little-endian uint64 offsets into the data (the first 0);
- the items' UTF-8 bytes, back to back.

Readers map the file with ``numpy.memmap``, so a list of 100M names costs
no memory per reader, and pickle by path.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterator, Sequence, Union

import numpy as np

MAGIC = b"LTFLIST1"
SUFFIX = ".filelist"
_HEADER = len(MAGIC) + 8


def write_items_to_file(items: Sequence[str], path: Path) -> None:
    """Writes ``items`` to ``path`` under a temporary name, then renames it
    into place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    encoded = [s.encode("utf-8") for s in items]
    offsets = np.zeros(len(encoded) + 1, "<u8")
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(np.asarray([len(encoded)], "<u8").tobytes())
        f.write(offsets.tobytes())
        for b in encoded:
            f.write(b)
    os.replace(tmp, path)


class MemoryMappedSequence(Sequence[str]):
    """The strings of a file of :func:`write_items_to_file`."""

    def __init__(self, path: Path):
        self._path = Path(path)
        self._offsets = None
        self._data = None

    @property
    def path(self) -> Path:
        return self._path

    def _load(self) -> None:
        if self._offsets is not None:
            return
        raw = np.memmap(self._path, dtype=np.uint8, mode="r")
        if bytes(raw[:len(MAGIC)]) != MAGIC:
            raise ValueError(f"{self._path} is not a file list")
        n = int(raw[len(MAGIC):_HEADER].view("<u8")[0])
        end = _HEADER + 8 * (n + 1)
        self._offsets = raw[_HEADER:end].view("<u8")
        self._data = raw[end:]

    def __len__(self) -> int:
        self._load()
        return len(self._offsets) - 1

    def _item(self, i: int) -> str:
        lo, hi = int(self._offsets[i]), int(self._offsets[i + 1])
        return bytes(self._data[lo:hi]).decode("utf-8")

    def __getitem__(self, index: Union[int, slice]):  # type: ignore[override]
        n = len(self)
        if isinstance(index, slice):
            return [self._item(i) for i in range(*index.indices(n))]
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(index)
        return self._item(index)

    def __iter__(self) -> Iterator[str]:
        for i in range(len(self)):
            yield self._item(i)

    # Pickle by path: a reader maps the file again instead of copying it.
    def __getstate__(self):
        return {"path": str(self._path)}

    def __setstate__(self, state):
        self._path = Path(state["path"])
        self._offsets = None
        self._data = None
