"""``LIGHTLY_TRAIN_MATMUL_PRECISION``: the float32 matmul precision of a run.

Port of ``apply_matmul_precision`` in ``lightly_train_tpu/_system.py``.
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
