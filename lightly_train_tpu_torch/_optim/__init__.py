from lightly_train_tpu_torch._optim.optimizers import (
    JAX_OPTIMIZERS,
    OPTIMIZER_ARGS_TYPES,
    AdamWArgs,
    LARSArgs,
    OptimizerArgs,
    SGDArgs,
    dinov2_wd_mask,
    layerwise_lr_scales,
    no_weight_decay_mask,
)
# After optimizers, which registers it (a circular import otherwise).
from lightly_train_tpu_torch._optim.adamw8bit import AdamW8bitArgs
from lightly_train_tpu_torch._optim.schedules import (
    cosine_warmup,
    scale_lr_for_batch_size,
)

__all__ = [
    "AdamW8bitArgs",
    "JAX_OPTIMIZERS",
    "OPTIMIZER_ARGS_TYPES",
    "AdamWArgs",
    "LARSArgs",
    "OptimizerArgs",
    "SGDArgs",
    "cosine_warmup",
    "dinov2_wd_mask",
    "layerwise_lr_scales",
    "no_weight_decay_mask",
    "scale_lr_for_batch_size",
]
