from lightly_train_tpu_torch._transforms.task_transforms import (
    TASK_TRANSFORM_ARGS,
    TrainTransform,
    build_train_transform,
    resolve_task_transform_args,
)

__all__ = [
    "TASK_TRANSFORM_ARGS",
    "TrainTransform",
    "build_train_transform",
    "resolve_task_transform_args",
]
