"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use into ``_build/`` beside this file (listed in
``.gitignore``), from the repository's sources only; a library's file name
carries a hash of its sources and flags, so an edited source rebuilds. Several
libraries build in parallel, one ``nvcc`` process each.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# library name -> (C function, argtypes)
LIBRARIES: Dict[str, tuple] = {
    "flat_attention_fwd_sm90": (
        "lt_attention_fwd_sm90",
        [_P] * 5 + [_I] * 5 + [ctypes.POINTER(_L), _F, _P],
    ),
    "flat_attention_fwd_f32_sm90": (
        "lt_attention_fwd_f32_sm90",
        [_P] * 5 + [_I] * 5 + [ctypes.POINTER(_L), _F, _P],
    ),
    "flat_attention_bwd_sm90": (
        "lt_attention_bwd_sm90",
        [_P] * 10 + [_I] * 5 + [ctypes.POINTER(_L), _F, _P],
    ),
    "flat_attention_bwd_f32_sm90": (
        "lt_attention_bwd_f32_sm90",
        [_P] * 10 + [_I] * 5 + [ctypes.POINTER(_L), _F, _P],
    ),
    "fused_adamw_ema": (
        "lt_fused_adamw_ema",
        [_P, _I, _P, _P, _P] + [_F] * 6 + [_P],
    ),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels build "
            "from csrc/ at first use on a machine with the CUDA toolkit."
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in sorted([src, *CSRC.glob("*.cuh")]):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named libraries that are not built yet, all at once.

    Returns seconds per library built. Raises with the compiler's output if
    any build fails. The compiler's report (registers, shared memory,
    spills from ``-Xptxas -v``) is kept in ``_build/<name>.log``.
    """
    names = list(LIBRARIES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    seconds = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def function(name: str):
    """The C entry point of library ``name``, building it on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            symbol, argtypes = LIBRARIES[name]
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn


def sass(name: str) -> str:
    """The SASS of library ``name`` (``cuobjdump --dump-sass``), building it
    first if needed."""
    path = library_path(name)
    if not path.exists():
        build([name])
    cuobjdump = Path(nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
