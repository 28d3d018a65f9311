from lightly_train_tpu_torch._optim.optimizers import (
    JAX_OPTIMIZERS,
    OPTIMIZER_ARGS_TYPES,
    AdamWArgs,
    OptimizerArgs,
    dinov2_wd_mask,
    layerwise_lr_scales,
    no_weight_decay_mask,
)
from lightly_train_tpu_torch._optim.schedules import (
    cosine_warmup,
    scale_lr_for_batch_size,
)

__all__ = [
    "JAX_OPTIMIZERS",
    "OPTIMIZER_ARGS_TYPES",
    "AdamWArgs",
    "OptimizerArgs",
    "cosine_warmup",
    "dinov2_wd_mask",
    "layerwise_lr_scales",
    "no_weight_decay_mask",
    "scale_lr_for_batch_size",
]
