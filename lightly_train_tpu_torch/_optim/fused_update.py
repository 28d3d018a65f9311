"""Fused AdamW + EMA-teacher parameter update, one device pass per leaf.

Port of ``lightly_train_tpu/_optim/fused_update.py``. The whole post-gradient
update of DINOv2 —

    g'  = g * clip_scale                       (clip by global norm)
    mu' = b1*mu + (1-b1)*g'                    (Adam moments)
    nu' = b2*nu + (1-b2)*g'^2
    u   = mu_hat / (sqrt(nu_hat) + eps) + wd*p (decoupled weight decay)
    p'  = p - lr*s_leaf*live_leaf * u          (lr scales + freeze masking)
    t'  = m*t + (1-m)*p'                       (EMA teacher)

— is one read-modify-write over (g, p, mu, nu, t) per leaf: the kernel K3
(``csrc/fused_adamw_ema.cu``, replacing ``_kernel``) on CUDA tensors, its
plain version :func:`fused_adamw_ema_leaf_plain` on CPU tensors.

p, mu, nu and the teacher t are updated IN PLACE, as the TPU kernel aliases
its outputs to its inputs: the caller's parameter tensors change.

The host side (:class:`FusedAdamWEMA`) computes the global grad norm and the
clip scale on the device, and on the host the lr and wd schedules, the bias
corrections, the per-leaf ``a = lr * lr_scale * update_scale`` and wd (0
where masked) and the EMA momentum. It packs them per leaf into a (leaves, 8)
float32 device array in the TPU kernel's order (cs, bc1, bc2, a, wd, m, 0, 0);
the clip-scale column is filled on the device, so nothing waits on the card.
Unlike the TPU path, which sends leaves under 64K elements or under 2-D to
jnp, every leaf goes through the kernel.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch._optim.optimizers import (
    AdamWArgs,
    no_weight_decay_mask,
)

def fused_adamw_ema_leaf_plain(
    g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
    t: torch.Tensor, scalars: torch.Tensor, *, b1: float, b2: float,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3. Returns new (p', mu', nu', t')."""
    s = scalars.reshape(-1)
    cs, bc1, bc2, a, wd, m = s[0], s[1], s[2], s[3], s[4], s[5]
    g = g.float() * cs
    mu_n = b1 * mu + (1.0 - b1) * g
    nu_n = b2 * nu + (1.0 - b2) * (g * g)
    u = (mu_n * bc1) / (torch.sqrt(nu_n * bc2) + eps) + wd * p
    p_n = p - a * u
    t_n = m * t + (1.0 - m) * p_n
    return p_n, mu_n, nu_n, t_n


def fused_adamw_ema_leaf(
    g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
    t: torch.Tensor, scalars: torch.Tensor, *, b1: float, b2: float,
    eps: float,
) -> None:
    """K3 on one leaf, in place on p, mu, nu and t. ``scalars``: 8 float32
    values (cs, bc1, bc2, a, wd, m, 0, 0) on the leaf's device.

    CUDA tensors launch the kernel (or raise); CPU tensors run the plain
    version and copy its results back in place.
    """
    if p.device.type == "cpu":
        outs = fused_adamw_ema_leaf_plain(g, p, mu, nu, t, scalars,
                                          b1=b1, b2=b2, eps=eps)
        for dst, src in zip((p, mu, nu, t), outs):
            dst.copy_(src)
        return
    n = p.numel()
    for name, x in (("g", g), ("p", p), ("mu", mu), ("nu", nu), ("t", t)):
        if (not x.is_cuda or x.device != p.device or x.dtype != torch.float32
                or not x.is_contiguous() or x.numel() != n
                or x.data_ptr() % 16):
            raise ValueError(
                f"fused_adamw_ema_leaf: {name} must be a contiguous, 16-byte "
                f"aligned float32 CUDA tensor of {n} elements like p"
            )
    if (scalars.device != p.device or scalars.dtype != torch.float32
            or scalars.numel() < 6 or not scalars.is_contiguous()):
        raise ValueError("fused_adamw_ema_leaf: scalars must be float32 on "
                         "the leaf's device")
    fn = _native.function("fused_adamw_ema")
    err = fn(
        g.data_ptr(), p.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        t.data_ptr(), scalars.data_ptr(), n,
        b1, 1.0 - b1, b2, 1.0 - b2, eps,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    _native.check(err, "fused_adamw_ema_leaf")
    fused_adamw_ema_leaf.launches += 1


fused_adamw_ema_leaf.launches = 0


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, on their device."""
    norms = torch._foreach_norm(list(grads))
    return torch.linalg.vector_norm(torch.stack(norms))


class FusedAdamWEMA:
    """AdamW + clip + lr scales + freeze masking + EMA teacher, fused.

    Built from the same ingredients as the JAX class (AdamW arguments, lr
    schedule, clip norm, per-parameter lr scales, wd schedule and mask, the
    method's EMA momentum and per-parameter update scales). Parameters are
    named tensors; the Adam moments and step count live here
    (``state_dict`` carries them into the checkpoint).
    """

    def __init__(
        self,
        args: AdamWArgs,
        learning_rate,
        params: Mapping[str, torch.Tensor],
        *,
        grad_clip_norm: Optional[float] = None,
        lr_scales: Optional[Mapping[str, float]] = None,
        weight_decay_schedule: Optional[Callable[[int], float]] = None,
        momentum_fn: Optional[Callable[[int], float]] = None,
        update_scales_fn: Optional[
            Callable[[int], Mapping[str, float]]] = None,
        wd_mask: Optional[Mapping[str, bool]] = None,
    ) -> None:
        self.args = args
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self.lr_scales = lr_scales
        self.weight_decay_schedule = weight_decay_schedule
        self.momentum_fn = momentum_fn
        self.update_scales_fn = update_scales_fn
        self.wd_mask = (
            dict(wd_mask) if wd_mask is not None
            else no_weight_decay_mask(params)
        )
        self.names = list(params)
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into the moments in place."""
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            for name, value in getattr(self, key).items():
                value.copy_(state[key][name])

    def _host_scalars(self, step: int) -> np.ndarray:
        """(leaves, 8) float32: [cs (filled on device), bc1, bc2, a, wd, m,
        0, 0], computed in float32 as the JAX path does."""
        a = self.args
        f32 = np.float32
        count = self.count
        lr = f32(
            self.learning_rate(count) if callable(self.learning_rate)
            else self.learning_rate
        )
        wd = f32(
            self.weight_decay_schedule(count)
            if self.weight_decay_schedule is not None else a.weight_decay
        )
        m = f32(self.momentum_fn(step) if self.momentum_fn is not None else 1.0)
        cif = f32(count + 1)
        bc1 = f32(1.0) / (f32(1.0) - np.power(f32(a.betas[0]), cif))
        bc2 = f32(1.0) / (f32(1.0) - np.power(f32(a.betas[1]), cif))
        us = (self.update_scales_fn(step)
              if self.update_scales_fn is not None else None)
        out = np.zeros((len(self.names), 8), np.float32)
        for i, name in enumerate(self.names):
            s = f32(self.lr_scales[name]) if self.lr_scales is not None else 1
            u = f32(us[name]) if us is not None else 1
            out[i, 1:6] = (bc1, bc2, lr * f32(s) * f32(u),
                           wd if self.wd_mask[name] else f32(0.0), m)
        return out

    @torch.no_grad()
    def update_and_apply(
        self,
        grads: Mapping[str, Optional[torch.Tensor]],
        params: Mapping[str, torch.Tensor],
        teacher: Mapping[str, torch.Tensor],
        step: int,
    ) -> torch.Tensor:
        """Update ``params`` and ``teacher`` in place; returns the global
        grad norm (a device scalar, before clipping)."""
        a = self.args
        b1, b2, eps = float(a.betas[0]), float(a.betas[1]), float(a.eps)
        first = params[self.names[0]]
        g_list = [
            grads[n] if grads[n] is not None else torch.zeros_like(params[n])
            for n in self.names
        ]
        grad_norm = global_norm(g_list)
        if self.grad_clip_norm is not None:
            clip = float(self.grad_clip_norm)
            cs = torch.where(grad_norm < clip, torch.ones_like(grad_norm),
                             clip / grad_norm)
        else:
            cs = torch.ones_like(grad_norm)
        host = torch.from_numpy(self._host_scalars(step))
        if first.is_cuda:
            host = host.pin_memory()
        scalars = host.to(first.device, non_blocking=True)
        scalars[:, 0] = cs
        for i, (name, g) in enumerate(zip(self.names, g_list)):
            fused_adamw_ema_leaf(
                g.contiguous(), params[name], self.mu[name], self.nu[name],
                teacher[name], scalars[i], b1=b1, b2=b2, eps=eps,
            )
        self.count += 1
        return grad_norm


def build_fused_updater(
    method,
    optim_args,
    learning_rate,
    params: Mapping[str, torch.Tensor],
    total_steps: int,
) -> FusedAdamWEMA:
    """FusedAdamWEMA for an (AdamW, EMA-method) pair.

    The JAX package falls back to an unfused optax chain for other pairs;
    the port has only the fused path so far, so other pairs raise.
    """
    if type(optim_args) is not AdamWArgs:
        raise NotImplementedError(
            f"optimizer {type(optim_args).__name__} is not ported yet: the "
            "port updates with the fused AdamW+EMA kernel only (ROADMAP "
            "item 10)."
        )
    if method.fused_ema_momentum(0, total_steps) is None:
        raise NotImplementedError(
            f"method '{method.name}' has no fused EMA update; the unfused "
            "update path is not ported yet (ROADMAP item 8)."
        )
    return FusedAdamWEMA(
        optim_args,
        learning_rate,
        params,
        grad_clip_norm=method.grad_clip_norm(),
        lr_scales=method.lr_scales(params),
        weight_decay_schedule=method.weight_decay_schedule(total_steps),
        momentum_fn=lambda step: method.fused_ema_momentum(step, total_steps),
        update_scales_fn=(
            (lambda step: method.update_scales(params, step))
            if method.update_scales(params, 0) is not None else None
        ),
        wd_mask=method.wd_mask(params),
    )
