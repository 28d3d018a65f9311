"""8-bit AdamW: int8 moments with per-block fp32 scales.

Port of ``lightly_train_tpu/_optim/adamw8bit.py`` (plain XLA there, plain
tensor ops here). Each parameter's moments are stored flattened in blocks
of 256 (the last one zero-padded) as int8 values and one fp32 scale per
block, the block's absolute maximum over 127, floored at 1e-12:

- mu is quantized with stochastic rounding, ``round(x / scale + U -
  0.5)`` with U uniform in [0, 1);
- nu is stored in the sqrt domain, rounded to nearest (zero-mean noise on
  a squared quantity would bias it upward), and squared when read back;
- the update is Adam's ``mu_hat / (sqrt(nu_hat) + eps)`` with the bias
  corrections of the step count, taken on the fp32 moments before they are
  quantized again.

:func:`quantize` takes the uniform noise as an argument: the unfused update
(``_optim/update.py``) draws it from a generator on the parameters' device,
seeded from the run's seed, whose state is checkpointed with the moments
(the JAX package folds the count and the leaf index into a fixed key; its
noise can be handed in instead). The chain around it is the JAX one: clip
-> adam8bit -> decoupled weight decay -> lr scales -> lr.

:func:`state_bytes` counts what the optimizer holds, for
``package_registry.refuse_pretraining``: two int8 bytes a parameter and two
fp32 scales a block, per leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Literal, Optional, Tuple, Union

import torch

from lightly_train_tpu_torch._configs.config import AUTO, Auto
from lightly_train_tpu_torch._optim.optimizers import OptimizerArgs

BLOCK = 256


@dataclasses.dataclass
class AdamW8bitArgs(OptimizerArgs):
    type: Literal["adamw8bit"] = "adamw8bit"
    lr: Union[float, Auto] = AUTO
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 1e-2


def n_blocks(numel: int) -> int:
    return -(-numel // BLOCK)


def state_bytes(numels: Iterable[int]) -> int:
    """Bytes of the int8 moments and their scales for leaves of these
    sizes: per leaf, 2 x 256 int8 and 2 fp32 scales a block."""
    return sum(2 * (BLOCK + 4) * n_blocks(n) for n in numels)


def _blocks(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK)


def quantize(x: torch.Tensor, noise: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` -> (int8 (n_blocks, 256), fp32 scales (n_blocks, 1)).
    With ``noise`` (uniform in [0, 1), (n_blocks, 256)) the rounding is
    stochastic, ``round(x / scale + noise - 0.5)``; without, to nearest."""
    blocks = _blocks(x.float())
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    scaled = blocks / scale
    if noise is not None:
        scaled = scaled + (noise - 0.5)
    q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               shape: torch.Size) -> torch.Tensor:
    """The fp32 tensor of ``shape`` that ``(q, scale)`` holds."""
    numel = 1
    for s in shape:
        numel *= s
    return (q.float() * scale).reshape(-1)[:numel].reshape(shape)


def zero_state(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A moment of zeros for ``p``: int8 zeros and scales at 1e-12."""
    nb = n_blocks(p.numel())
    return (torch.zeros((nb, BLOCK), dtype=torch.int8, device=p.device),
            torch.full((nb, 1), 1e-12, dtype=torch.float32, device=p.device))
