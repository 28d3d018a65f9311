"""PyTorch + CUDA port of lightly_train_tpu for NVIDIA Hopper.

The JAX package ``lightly_train_tpu`` is the reference; this package imports
nothing of it (nor of JAX). Entry points run on the card unless the caller
asks for the CPU.
"""

from lightly_train_tpu_torch._commands.embed import embed, embed_from_config
from lightly_train_tpu_torch._commands.train import (
    pretrain,
    pretrain_from_config,
)
from lightly_train_tpu_torch.methods.method_helpers import list_methods

__all__ = ["embed", "embed_from_config", "list_methods", "pretrain",
           "pretrain_from_config"]
