"""Sinkhorn-Knopp re-export, as the JAX package keeps it
(``lightly_train_tpu/ops/sinkhorn.py``); the implementation is
:func:`lightly_train_tpu_torch.ops.losses.sinkhorn_knopp_teacher`."""

from lightly_train_tpu_torch.ops.losses import sinkhorn_knopp_teacher

__all__ = ["sinkhorn_knopp_teacher"]
