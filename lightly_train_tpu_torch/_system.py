"""The system log of a run, and the float32 matmul precision.

Port of ``lightly_train_tpu/_system.py``. :func:`get_system_information`
gathers what a run is reproduced from: Python, the platform, the CPU count,
the versions of torch, CUDA and numpy, the devices (each card's name,
compute capability and memory), the git commit of the working directory
where ``git`` answers and the host's memory where ``psutil`` imports;
:func:`log_system_information` logs it at the start of ``pretrain`` and
``embed``.

``LIGHTLY_TRAIN_MATMUL_PRECISION`` is ported in
:func:`apply_matmul_precision`.
The JAX package maps the variable onto XLA's default matmul precision; the
port maps it onto the CUDA backend's TF32 switches, for cuBLAS (the fp32
GEMMs) and for cuDNN (the patch embedding's convolution) alike:

=========== ================================ ================================
value       fp32 GEMMs                       fp32 convolutions
=========== ================================ ================================
``default`` TF32 on the tensor cores         TF32 on the tensor cores
``high``    TF32 on the tensor cores         TF32 on the tensor cores
``highest`` IEEE fp32                        IEEE fp32
=========== ================================ ================================

``default`` is what XLA's default fp32 matmul runs on this card (TF32).
``high`` is XLA's ``bfloat16_3x``, which cuBLAS does not offer, so it takes
the nearest setting cuBLAS has. Every value is set explicitly, so a process
that ran ``highest`` and then a ``default`` run gets TF32 again (the JAX
package leaves the previous setting in place for ``default``). Only the
CUDA backend's switches move: the CPU path (``torch.backends.mkldnn``)
stays in exact fp32, as the JAX package's CPU path is. The hand-written
attention kernels do not read these switches; their fp32 forms keep the
JAX kernels' ``precision=DEFAULT`` numerics (bf16 hi/lo planes) whatever
the value. An unknown value is logged and changes nothing.
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
from typing import Any, Dict

import torch

from lightly_train_tpu_torch._env import Env
from lightly_train_tpu_torch._logging import get_logger

logger = get_logger("system")

# value -> TF32 allowed in the fp32 GEMMs and convolutions.
MATMUL_PRECISIONS = {"default": True, "high": True, "highest": False}


def set_tf32(allow: bool) -> None:
    """Allows (or forbids) TF32 in the CUDA backend's fp32 GEMMs and
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def apply_matmul_precision() -> None:
    """Applies ``LIGHTLY_TRAIN_MATMUL_PRECISION`` (see the module
    docstring)."""
    value = Env.LIGHTLY_TRAIN_MATMUL_PRECISION.value
    if value not in MATMUL_PRECISIONS:
        logger.warning(
            "Unknown LIGHTLY_TRAIN_MATMUL_PRECISION=%r (default|high|highest)",
            value,
        )
        return
    set_tf32(MATMUL_PRECISIONS[value])
    logger.info("Float32 matmul precision %r: %s in the CUDA fp32 GEMMs and "
                "convolutions", value,
                "TF32" if MATMUL_PRECISIONS[value] else "IEEE fp32")


def get_system_information() -> Dict[str, Any]:
    """The run's system (see the module docstring)."""
    info: Dict[str, Any] = {
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "cpu_count": os.cpu_count(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_count": torch.cuda.device_count(),
        "devices": [],
    }
    for i in range(info["device_count"]):
        props = torch.cuda.get_device_properties(i)
        info["devices"].append({
            "name": props.name,
            "capability": f"{props.major}.{props.minor}",
            "memory_gib": round(props.total_memory / 2 ** 30, 2),
        })
    try:
        info["numpy_version"] = __import__("numpy").__version__
    except Exception:
        pass
    try:
        import psutil

        info["memory_gb"] = round(psutil.virtual_memory().total / 1e9, 1)
    except ImportError:
        pass
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5,
        )
        if rev.returncode == 0:
            info["git_commit"] = rev.stdout.strip()
    except Exception:
        pass
    return info


def log_system_information() -> Dict[str, Any]:
    """Logs :func:`get_system_information` and returns it."""
    info = get_system_information()
    devices = info["devices"]
    logger.info(
        "System: %s | python %s | torch %s (CUDA %s) | %d CPUs | %d x %s",
        info["platform"], info["python"], info["torch_version"],
        info["cuda_version"], info["cpu_count"] or 0, len(devices),
        ", ".join(f"{d['name']} (sm {d['capability']}, "
                  f"{d['memory_gib']} GiB)" for d in devices) or "no card",
    )
    logger.debug("System information: %s", info)
    return info
