"""Convolution, BatchNorm and pooling layers of the CNN backbones.

The pieces the port's ResNet, ConvNeXt and ShuffleNet are built from, with
the numerics of the Flax layers the JAX package uses:

- :class:`Conv`: ``nn.Conv`` computing in ``dtype`` (input, kernel and bias
  cast to it), with Flax's padding rules: explicit pairs, ``"VALID"``, or
  ``"SAME"``, which pads ``max((ceil(n / s) - 1) s + k - n, 0)`` with the
  odd pixel after (a stride-2 "SAME" convolution of an even map pads only
  its end);
- :class:`BatchNorm`: ``nn.BatchNorm`` at Flax 0.12's defaults: momentum
  0.99, epsilon 1e-5, statistics in fp32 whatever ``dtype``, the variance
  as ``E[x^2] - E[x]^2`` clipped at 0 (``use_fast_variance``), and the
  running variance updated with that biased batch variance. The running
  statistics are buffers (``mean``, ``var``), the JAX package's
  ``batch_stats`` collection; a train-mode forward updates them in place,
  once a call;
- :func:`max_pool` and :func:`avg_pool`: Flax's pools with "SAME" or
  explicit padding. The max pool pads with -inf; the average pool counts
  the padded zeros in its divisor (``count_include_pad``), which torch's
  ``ceil_mode`` pooling does not.

Layers take NCHW tensors; the models keep them in channels-last memory, so
NCHW here is a view of the JAX package's (B, H, W, C) layout.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from lightly_train_tpu_torch.errors import ModifyScopeVariableError
from lightly_train_tpu_torch.models.vit import LayerNorm, Linear, lecun_normal_

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of Flax's "SAME" along one axis."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, padding: Padding, kernel: Tuple[int, int],
          stride: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if padding == "VALID":
        return (0, 0), (0, 0)
    if padding == "SAME":
        return (same_pads(x.shape[2], kernel[0], stride),
                same_pads(x.shape[3], kernel[1], stride))
    (t, b), (l, r) = padding
    return (t, b), (l, r)


class Conv(nn.Module):
    """``nn.Conv`` of Flax over NCHW: weight (O, I / groups, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: Padding = "SAME", groups: int = 1,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """Flax's default: lecun-normal kernel (fan-in I / groups * kh * kw),
        zero bias."""
        w = self.weight
        lecun_normal_(w.data, w.shape[1] * w.shape[2] * w.shape[3], generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = _pads(x, self.padding, self.weight.shape[2:],
                               self.stride)
        x = x.to(self.dtype)
        stride, pad = self.stride, 0
        if self.weight.shape[2:] == (1, 1) and (t, b, l, r) == (0, 0, 0, 0):
            # A strided 1x1 convolution is one on the strided pixels (and
            # the CPU backward of the strided one on channels-last input
            # crashes in PyTorch 2.13).
            x, stride = x[:, :, ::stride, ::stride], 1
        elif (t, l) == (b, r):
            pad = (t, l)
        else:
            x = F.pad(x, (l, r, t, b))
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, stride, pad,
                        groups=self.groups)


class BatchNorm(nn.Module):
    """``nn.BatchNorm`` of Flax over the channels of NCHW input.

    ``weight``/``bias`` are its ``scale``/``bias`` parameters; ``mean`` and
    ``var`` its ``batch_stats``. In train mode the batch's statistics
    normalize (gradients flow through them) and the running ones move by
    ``ra <- m ra + (1 - m) stat``; in eval mode the running ones normalize.
    ``use_fast_variance = False`` takes the batch variance in two passes,
    ``E[(x - E[x])^2]``, as Flax's field of that name does.
    """

    use_fast_variance = True

    def __init__(self, ch: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))
        self.momentum, self.eps, self.dtype = momentum, eps, dtype

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.float()
        if train:
            dims = (0, 2, 3)
            mean = x.mean(dims)
            if self.use_fast_variance:
                var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            else:
                var = ((x - mean[:, None, None]) ** 2).mean(dims)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)


def max_pool(x: torch.Tensor, kernel: int, stride: int,
             padding: Padding) -> torch.Tensor:
    """``nn.max_pool`` of Flax: the padding holds -inf."""
    (t, b), (l, r) = _pads(x, padding, (kernel, kernel), stride)
    if (t, l) == (b, r) and 2 * t <= kernel and 2 * l <= kernel:
        return F.max_pool2d(x, kernel, stride, (t, l))
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=float("-inf")), kernel,
                        stride)


def avg_pool(x: torch.Tensor, kernel: int, stride: int,
             padding: Padding) -> torch.Tensor:
    """``nn.avg_pool`` of Flax: padded zeros count in the divisor."""
    (t, b), (l, r) = _pads(x, padding, (kernel, kernel), stride)
    if (t, b, l, r) != (0, 0, 0, 0):
        x = F.pad(x, (l, r, t, b))
    return F.avg_pool2d(x, kernel, stride)


def reset_cnn_parameters(module: nn.Module,
                         generator: Optional[torch.Generator]) -> None:
    """Flax's initializers over every layer of a CNN, in module order:
    :class:`Conv` and ``Linear`` lecun-normal with zero biases, norms at
    scale 1 and bias 0, running statistics at mean 0 and variance 1.
    Every parameter and buffer is set, so a module made with ``to_empty``
    is initialised in full."""
    for m in module.modules():
        if isinstance(m, (Conv, Linear, BatchNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, LayerNorm):
            m.weight.data.fill_(1.0)
            m.bias.data.zero_()


@torch.no_grad()
def copy_running_stats(dst: nn.Module, src: nn.Module) -> None:
    """Copy ``src``'s buffers (its BatchNorm running statistics) into
    ``dst``'s, which has the same structure. A model without buffers (the
    ViTs) costs nothing."""
    dst_buffers = list(dst.buffers())
    if dst_buffers:
        torch._foreach_copy_(dst_buffers, list(src.buffers()))


@contextlib.contextmanager
def frozen_buffers(module: nn.Module) -> Iterator[None]:
    """Puts ``module``'s buffers back as they were when the block ends. The
    JAX package's DINOv2 and DINOv31 apply their student without
    ``mutable``: a bridged torch module's running statistics then stay as
    they were (its bridge drops the mutations), which this gives the
    port's train-mode forwards of such a module; the port's own BatchNorm
    is refused before (:func:`refuse_running_stats`). A model without
    buffers (the ViTs) costs nothing."""
    held = [b.detach().clone() for b in module.buffers()]
    try:
        yield
    finally:
        if held:
            # Through ``.data``: a train-mode batch norm's backward holds
            # its running statistics (unread in train mode) under autograd's
            # version check.
            torch._foreach_copy_([b.data for b in module.buffers()], held)


def refuse_running_stats(module: nn.Module) -> None:
    """Raise :class:`ModifyScopeVariableError` where ``module`` has
    BatchNorm running statistics: a method that cannot update them (the
    JAX package's DINOv2 and DINOv31) stops at its student's train-mode
    forward, as Flax stops it there."""
    if next(module.buffers(), None) is None:
        return
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm):
            scope = "/" + name.replace(".", "/")
            raise ModifyScopeVariableError(
                f'Cannot update variable "mean" in "{scope}" because '
                'collection "batch_stats" is immutable: this method runs '
                "its student without BatchNorm state, as the JAX package "
                "does.")
