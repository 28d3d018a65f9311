"""Hand-written CUDA kernels for the hot compute path (the counterpart of
``lightly_train_tpu.ops.pallas``)."""

from lightly_train_tpu_torch.ops.kernels.attention import (
    flat_attention,
    use_vmem_attention,
    vmem_attention,
)

__all__ = ["flat_attention", "use_vmem_attention", "vmem_attention"]
