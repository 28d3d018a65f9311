"""The unfused parameter update: AdamW, SGD or LARS as the JAX package
chains them.

Port of the chain ``build_optimizer`` assembles in
``lightly_train_tpu/_optim/optimizers.py`` (optax), for every (optimizer,
method) pair the fused AdamW+EMA update does not take. Per leaf, in the JAX
order:

1. clip by the global norm (where the method gives a clip norm):
   ``g <- g`` below the norm, else ``g / norm * max_norm``;
2. one of
   - Adam (``optax.scale_by_adam``): ``mu <- b1 mu + (1 - b1) g``,
     ``nu <- b2 nu + (1 - b2) g^2``, ``u = mu_hat / (sqrt(nu_hat) + eps)``
     with the bias corrections of the step count;
   - SGD (``optax.trace``, where momentum > 0): ``t <- g + m t``, ``u = t``;
   - LARS (``optax.scale_by_trust_ratio`` then ``optax.trace``): the trust
     ratio ``c ||p|| / ||g||`` (1 where either norm is 0) is taken on the
     clipped gradient, before momentum and weight decay;
3. ``u <- u + wd p`` on the leaves the weight-decay mask decays, with wd
   from the method's schedule where it gives one;
4. ``u <- u s`` with the method's per-leaf lr scales;
5. ``u <- -lr(count) u``.

The method then masks the updates (``Method.mask_updates``), they are added
to the parameters, and the method's ``post_update`` runs (the train step,
``_commands/train_loop.py``). The count, the lr and the weight decay are
host numbers; everything else is plain tensor ops on the parameters'
device, so nothing waits on the card. No ``torch.optim`` class runs.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from lightly_train_tpu_torch._optim.fused_update import global_norm
from lightly_train_tpu_torch._optim.optimizers import (
    AdamWArgs,
    LARSArgs,
    OptimizerArgs,
    SGDArgs,
    no_weight_decay_mask,
)

Schedule = Callable[[int], float]


class UnfusedUpdate:
    """The update chain of one optimizer over named parameters; its state
    (the step count and the Adam moments or the momentum trace) is what
    :meth:`state_dict` carries into a checkpoint."""

    def __init__(
        self,
        args: OptimizerArgs,
        learning_rate: Union[float, Schedule],
        params: Mapping[str, torch.Tensor],
        grad_clip_norm: Optional[float] = None,
        lr_scales: Optional[Mapping[str, float]] = None,
        weight_decay_schedule: Optional[Schedule] = None,
        wd_mask: Optional[Mapping[str, bool]] = None,
    ):
        if type(args) not in (AdamWArgs, SGDArgs, LARSArgs):
            raise ValueError(f"Unknown optimizer args type: {type(args)}")
        self.args = args
        self.learning_rate = learning_rate
        self.grad_clip_norm = grad_clip_norm
        self.weight_decay_schedule = weight_decay_schedule
        self.names = list(params)
        self.lr_scales = (None if lr_scales is None
                          else [float(lr_scales[n]) for n in self.names])
        mask = no_weight_decay_mask(params) if wd_mask is None else wd_mask
        self.decays = [bool(mask[n]) for n in self.names]
        self.count = 0
        # Adam's moments, or the momentum trace of SGD and LARS.
        self.moments: Dict[str, Dict[str, torch.Tensor]] = {}
        if type(args) is AdamWArgs:
            keys = ("mu", "nu")
        else:
            keys = ("trace",) if args.momentum > 0 else ()
        for key in keys:
            self.moments[key] = {n: torch.zeros_like(p, dtype=torch.float32)
                                 for n, p in params.items()}

    def state_dict(self) -> dict:
        return {"count": self.count, **self.moments}

    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into this state in place."""
        self.count = int(state["count"])
        for key, tensors in self.moments.items():
            for name, value in tensors.items():
                value.copy_(state[key][name])

    def _weight_decay(self) -> float:
        if self.weight_decay_schedule is not None:
            return float(np.float32(self.weight_decay_schedule(self.count)))
        return float(self.args.weight_decay)

    @torch.no_grad()
    def update(
        self,
        grads: Mapping[str, Optional[torch.Tensor]],
        params: Mapping[str, torch.Tensor],
    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(updates by name, the global grad norm before clipping). A
        ``None`` gradient counts as zeros. Advances the step count."""
        a = self.args
        p = [params[n] for n in self.names]
        g = [grads[n].float() if grads[n] is not None
             else torch.zeros_like(params[n], dtype=torch.float32)
             for n in self.names]
        norm = global_norm(g)
        if self.grad_clip_norm is not None:
            keep = norm < self.grad_clip_norm
            g = [torch.where(keep, x, x / norm * self.grad_clip_norm)
                 for x in g]
        f32 = np.float32
        if type(a) is AdamWArgs:
            b1, b2 = a.betas
            mu, nu = (list(self.moments[k].values()) for k in ("mu", "nu"))
            n_inc = f32(self.count + 1)
            bc1 = float(f32(1) - f32(b1) ** n_inc)
            bc2 = float(f32(1) - f32(b2) ** n_inc)
            u = []
            for gi, m, v in zip(g, mu, nu):
                m.copy_((1 - b1) * gi + b1 * m)
                v.copy_((1 - b2) * (gi * gi) + b2 * v)
                u.append((m / bc1) / (torch.sqrt(v / bc2) + a.eps))
        else:
            if type(a) is LARSArgs:
                pn = torch.stack(torch._foreach_norm(p))
                gn = torch.stack(torch._foreach_norm(g))
                ratio = torch.where((pn == 0) | (gn == 0), torch.ones_like(pn),
                                    a.trust_coefficient * pn / gn)
                g = [x * r for x, r in zip(g, ratio.unbind())]
            u = g
            if a.momentum > 0:
                trace = list(self.moments["trace"].values())
                for gi, t in zip(g, trace):
                    t.copy_(gi + a.momentum * t)
                u = trace
        wd = self._weight_decay()
        if wd > 0 or self.weight_decay_schedule is not None:
            u = [ui + wd * pi if d else ui
                 for ui, pi, d in zip(u, p, self.decays)]
        if self.lr_scales is not None:
            u = [ui * s for ui, s in zip(u, self.lr_scales)]
        lr = self.learning_rate
        step = -float(f32(lr(self.count) if callable(lr) else lr))
        self.count += 1
        return {n: ui * step for n, ui in zip(self.names, u)}, norm


def apply_updates(params: Mapping[str, torch.Tensor],
                  updates: Mapping[str, torch.Tensor]) -> None:
    """``p <- p + u`` in place (``optax.apply_updates``)."""
    with torch.no_grad():
        for name, u in updates.items():
            params[name].add_(u.to(params[name].dtype))


def build_update(
    method,
    optim_args: OptimizerArgs,
    learning_rate: Union[float, Schedule],
    params: Mapping[str, torch.Tensor],
    total_steps: int,
) -> UnfusedUpdate:
    """The unfused chain with the method's clip norm, lr scales, weight-decay
    schedule and mask (the JAX ``build_optimizer`` call of ``pretrain``)."""
    return UnfusedUpdate(
        optim_args,
        learning_rate,
        params,
        grad_clip_norm=method.grad_clip_norm(),
        lr_scales=method.lr_scales(params),
        weight_decay_schedule=method.weight_decay_schedule(total_steps),
        wd_mask=method.wd_mask(params),
    )
