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
   - AdamW8bit (``adamw8bit.scale_by_adam8bit``): Adam on moments read back
     from int8 blocks, mu requantized with stochastic rounding on noise
     drawn from the update's generator (``adamw8bit.py``);
3. ``u <- u + wd p`` on the leaves the weight-decay mask decays, with wd
   from the method's schedule where it gives one;
4. ``u <- u s`` with the method's per-leaf lr scales;
5. ``u <- -lr(count) u``, or, with ``schedule_groups`` (EoMT's two clocks,
   ``optimizers.py::scale_by_grouped_schedules``), ``u <-
   -schedules[g](count) u`` with the leaf's group ``g``.

The method then masks the updates (``Method.mask_updates``), they are added
to the parameters, and the method's ``post_update`` runs (the train step,
``_commands/train_loop.py``). All of that runs one leaf at a time
(:meth:`UnfusedUpdate.update_and_apply`), so that a model whose parameters
and gradients fill most of the card (a 7B ViT) is updated without a copy of
either tree. The count, the lr and the weight decay are host numbers;
everything else is plain tensor ops on the parameters' device, so nothing
waits on the card. No ``torch.optim`` class runs.
"""

from __future__ import annotations

from typing import (
    Callable,
    Dict,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from lightly_train_tpu_torch._optim import adamw8bit as Q8
from lightly_train_tpu_torch._optim.adamw8bit import AdamW8bitArgs
from lightly_train_tpu_torch._optim.fused_update import global_norm
from lightly_train_tpu_torch._optim.optimizers import (
    AdamWArgs,
    LARSArgs,
    OptimizerArgs,
    SGDArgs,
    no_weight_decay_mask,
)

Schedule = Callable[[int], float]
# (leaf name, noise shape) -> uniform noise in [0, 1) for AdamW8bit's mu.
Noise = Callable[[str, torch.Size], torch.Tensor]


class UnfusedUpdate:
    """The update chain of one optimizer over named parameters; its state
    (the step count and the Adam moments, AdamW8bit's int8 moments with
    their scales and its noise generator's state, or the momentum trace)
    is what :meth:`state_dict` carries into a checkpoint. ``seed`` seeds
    AdamW8bit's noise generator, on the parameters' device."""

    def __init__(
        self,
        args: OptimizerArgs,
        learning_rate: Union[float, Schedule],
        params: Mapping[str, torch.Tensor],
        grad_clip_norm: Optional[float] = None,
        lr_scales: Optional[Mapping[str, float]] = None,
        weight_decay_schedule: Optional[Schedule] = None,
        wd_mask: Optional[Mapping[str, bool]] = None,
        seed: int = 0,
        schedule_groups: Optional[Tuple[Sequence[Schedule],
                                        Mapping[str, int]]] = None,
    ):
        if type(args) not in (AdamWArgs, AdamW8bitArgs, SGDArgs, LARSArgs):
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
        # (schedules, each leaf's index into them) or None.
        self.schedule_groups = None
        if schedule_groups is not None:
            schedules, groups = schedule_groups
            self.schedule_groups = (list(schedules),
                                    [int(groups[n]) for n in self.names])
        self.count = 0
        # Adam's moments, or the momentum trace of SGD and LARS.
        self.moments: Dict[str, Dict[str, torch.Tensor]] = {}
        self.generator = None
        if type(args) is AdamW8bitArgs:
            for key in ("mu", "nu"):
                zeros = {n: Q8.zero_state(p) for n, p in params.items()}
                self.moments[f"{key}_q"] = {n: z[0] for n, z in zeros.items()}
                self.moments[f"{key}_scale"] = {n: z[1]
                                                for n, z in zeros.items()}
            device = next(iter(params.values())).device
            self.generator = torch.Generator(device=device).manual_seed(seed)
            return
        if type(args) is AdamWArgs:
            keys = ("mu", "nu")
        else:
            keys = ("trace",) if args.momentum > 0 else ()
        for key in keys:
            self.moments[key] = {n: torch.zeros_like(p, dtype=torch.float32)
                                 for n, p in params.items()}

    def state_dict(self) -> dict:
        state = {"count": self.count, **self.moments}
        if self.generator is not None:
            state["generator"] = self.generator.get_state()
        return state

    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into this state in place."""
        self.count = int(state["count"])
        for key, tensors in self.moments.items():
            for name, value in tensors.items():
                value.copy_(state[key][name])
        if self.generator is not None:
            self.generator.set_state(state["generator"])

    def _noise(self, name: str, shape: torch.Size) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device)

    def _weight_decay(self) -> float:
        if self.weight_decay_schedule is not None:
            return float(np.float32(self.weight_decay_schedule(self.count)))
        return float(self.args.weight_decay)

    @torch.no_grad()
    def update_and_apply(
        self,
        grads: Dict[str, Optional[torch.Tensor]],
        params: Mapping[str, torch.Tensor],
        mask: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
        noise: Optional[Noise] = None,
    ) -> torch.Tensor:
        """Updates ``params`` in place, leaf by leaf; returns the global grad
        norm before clipping. A ``None`` gradient counts as zeros. Each
        gradient is taken out of ``grads`` as its leaf is updated, so that
        it is freed there when the caller holds no other reference. ``mask``
        (the method's ``mask_updates`` of one leaf) gets each update by
        name before it is added. ``noise`` replaces AdamW8bit's draws from
        its generator (a test hands in the JAX package's). Advances the
        step count.

        The global norm comes first. Then each leaf goes through the whole
        chain (clip, the trust ratio and its two norms, trace or moments,
        weight decay, lr scale, -lr, mask) and is added before the next
        leaf starts: beyond the parameters and gradients the update holds
        a few tensors of one leaf at a time, never a tree of them. The
        arithmetic and its order within a leaf are those of the chain over
        whole trees, so the parameters are bitwise what it gave.
        """
        a = self.args
        f32 = np.float32
        # A missing gradient's norm is that of zeros: a 0-d zero stands in
        # for the leaf.
        zero = torch.zeros((), dtype=torch.float32,
                           device=params[self.names[0]].device)
        norm = global_norm([zero if grads[n] is None else grads[n].float()
                            for n in self.names])
        clip = self.grad_clip_norm
        keep = None if clip is None else norm < clip
        if type(a) in (AdamWArgs, AdamW8bitArgs):
            b1, b2 = a.betas
            n_inc = f32(self.count + 1)
            bc1 = float(f32(1) - f32(b1) ** n_inc)
            bc2 = float(f32(1) - f32(b2) ** n_inc)
        wd = self._weight_decay()
        decay = wd > 0 or self.weight_decay_schedule is not None
        lr = self.learning_rate
        step = -float(f32(lr(self.count) if callable(lr) else lr))
        if self.schedule_groups is not None:
            schedules, groups = self.schedule_groups
            steps = [-float(f32(s(self.count))) for s in schedules]
        for i, name in enumerate(self.names):
            p = params[name]
            g = grads.pop(name)
            g = (g.float() if g is not None
                 else torch.zeros_like(p, dtype=torch.float32))
            if keep is not None:
                g = torch.where(keep, g, g / norm * clip)
            if type(a) is AdamWArgs:
                m, v = self.moments["mu"][name], self.moments["nu"][name]
                m.copy_((1 - b1) * g + b1 * m)
                v.copy_((1 - b2) * (g * g) + b2 * v)
                u = (m / bc1) / (torch.sqrt(v / bc2) + a.eps)
            elif type(a) is AdamW8bitArgs:
                u = self._adam8bit(name, g, b1, b2, bc1, bc2,
                                   noise or self._noise)
            else:
                if type(a) is LARSArgs:
                    pn, gn = torch._foreach_norm([p, g])
                    ratio = torch.where((pn == 0) | (gn == 0),
                                        torch.ones_like(pn),
                                        a.trust_coefficient * pn / gn)
                    g = g * ratio
                u = g
                if a.momentum > 0:
                    trace = self.moments["trace"][name]
                    trace.copy_(g + a.momentum * trace)
                    u = trace
            del g
            if decay and self.decays[i]:
                u = u + wd * p
            if self.lr_scales is not None:
                u = u * self.lr_scales[i]
            u = u * (step if self.schedule_groups is None
                     else steps[groups[i]])
            if mask is not None:
                u = mask(name, u)
            p.add_(u.to(p.dtype))
            del u
        self.count += 1
        return norm

    def _adam8bit(self, name: str, g: torch.Tensor, b1: float, b2: float,
                  bc1: float, bc2: float, noise: Noise) -> torch.Tensor:
        """One leaf of ``scale_by_adam8bit``: its update, with its int8
        moments replaced by the requantized new ones."""
        mo = self.moments
        m = Q8.dequantize(mo["mu_q"][name], mo["mu_scale"][name], g.shape)
        nu_sqrt = Q8.dequantize(mo["nu_q"][name], mo["nu_scale"][name],
                                g.shape)
        m = b1 * m + (1 - b1) * g
        v = b2 * (nu_sqrt * nu_sqrt) + (1 - b2) * g * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + self.args.eps)
        q_m, s_m = Q8.quantize(m, noise(name, mo["mu_q"][name].shape))
        q_v, s_v = Q8.quantize(torch.sqrt(v))
        for key, value in (("mu_q", q_m), ("mu_scale", s_m), ("nu_q", q_v),
                           ("nu_scale", s_v)):
            mo[key][name].copy_(value)
        return u


def build_update(
    method,
    optim_args: OptimizerArgs,
    learning_rate: Union[float, Schedule],
    params: Mapping[str, torch.Tensor],
    total_steps: int,
    seed: int = 0,
) -> UnfusedUpdate:
    """The unfused chain with the method's clip norm, lr scales, weight-decay
    schedule and mask (the JAX ``build_optimizer`` call of ``pretrain``);
    ``seed`` is the run's, for AdamW8bit's noise."""
    return UnfusedUpdate(
        optim_args,
        learning_rate,
        params,
        grad_clip_norm=method.grad_clip_norm(),
        lr_scales=method.lr_scales(params),
        weight_decay_schedule=method.weight_decay_schedule(total_steps),
        wd_mask=method.wd_mask(params),
        seed=seed,
    )
