#!/usr/bin/env python3
"""Compare the compiled code (SASS) of every CUDA kernel of the port under
ROOT with the same kernel of this checkout's port, function by function.

    python3 compare_sass.py ROOT

ROOT is the root of another checkout, usually the parent commit unpacked
in a directory that ``.gitignore`` lists. Both trees' libraries are built
(``nvcc``, into each tree's ``_build/``), disassembled with ``cuobjdump
--dump-sass`` and compared instruction by instruction; the name of a
function in an anonymous namespace carries a hash of its file's path, which
is normalized away. Needs the CUDA toolkit, not a card.

Prints one line a function (SAME, DIFF, GONE: only under ROOT, NEW: only
here), then one JSON line with the counts. Exits 1 if a function of both
trees differs.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
ANON = re.compile(r"_GLOBAL__N__[0-9A-Za-z]+_")
ADDRESS = re.compile(r"/\*[0-9a-f]{4}\*/")


def native(root: Path, name: str):
    """The ``_native`` module of the port under ``root`` (it imports only
    the standard library, so each tree's loads on its own)."""
    path = root / "lightly_train_tpu_torch" / "_native.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def functions(nat, library: str) -> dict:
    """{normalized function name: [instruction, ...]} of one library."""
    out, current = {}, None
    for line in nat.sass(library).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = ANON.sub("ANON_", m.group(1))
            out[current] = []
        elif current is not None and ADDRESS.search(line):
            instruction = ADDRESS.sub("", line.split(";")[0]).strip()
            out[current].append(ANON.sub("ANON_", instruction))
    return out


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"root": native(Path(sys.argv[1]).resolve(), "_native_root"),
             "here": native(HERE, "_native_here")}
    with ThreadPoolExecutor(len(trees)) as pool:
        for built in [pool.submit(nat.build) for nat in trees.values()]:
            built.result()
    counts = {"same": 0, "diff": 0, "gone": 0, "new": 0}
    for library in sorted(set(trees["root"].LIBRARIES)
                          | set(trees["here"].LIBRARIES)):
        old, new = ({} if library not in nat.LIBRARIES
                    else functions(nat, library)
                    for nat in trees.values())
        for name in sorted(set(old) | set(new)):
            if name not in new:
                verdict = "gone"
            elif name not in old:
                verdict = "new"
            else:
                verdict = "same" if old[name] == new[name] else "diff"
            counts[verdict] += 1
            sizes = [len(f[name]) if name in f else None for f in (old, new)]
            print(f"{verdict.upper():4s} {library} {name} "
                  f"({sizes[0]} / {sizes[1]} instructions)")
    print(json.dumps(counts))
    return 1 if counts["diff"] else 0


if __name__ == "__main__":
    sys.exit(main())
