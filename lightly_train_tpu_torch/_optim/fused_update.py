"""Fused AdamW + EMA-teacher parameter update, one device pass over every
leaf.

Port of ``lightly_train_tpu/_optim/fused_update.py``. The whole post-gradient
update of DINOv2 —

    g'  = g * clip_scale                       (clip by global norm)
    mu' = b1*mu + (1-b1)*g'                    (Adam moments)
    nu' = b2*nu + (1-b2)*g'^2
    u   = mu_hat / (sqrt(nu_hat) + eps) + wd*p (decoupled weight decay)
    p'  = p - lr*s_leaf*live_leaf * u          (lr scales + freeze masking)
    t'  = m*t + (1-m)*p'                       (EMA teacher)

— is one read-modify-write over (g, p, mu, nu, t) of every leaf: on CUDA
tensors the kernel K3 (``csrc/fused_adamw_ema.cu``, replacing ``_kernel``),
one launch a step over all leaves, split into the chunks of
:func:`plan_chunks`; on CPU tensors its plain version
:func:`fused_adamw_ema_leaf_plain`, leaf by leaf.

p, mu, nu and the teacher t are updated IN PLACE, as the TPU kernel aliases
its outputs to its inputs: the caller's parameter tensors change.

The host side (:class:`FusedAdamWEMA`) computes the global grad norm on the
device, and on the host the lr and wd schedules, the bias corrections, the
per-leaf ``a = lr * lr_scale * update_scale`` and wd (0 where masked) and the
EMA momentum, as one (leaves, 8) float32 table in the TPU kernel's order
(cs, bc1, bc2, a, wd, m, 0, 0). The kernel forms the clip scale cs from the
norm on the card, so nothing waits on the device. Unlike the TPU path, which
sends leaves under 64K elements or under 2-D to jnp, every leaf goes through
the kernel.
"""

from __future__ import annotations

import operator
from typing import Callable, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch._optim.optimizers import (
    AdamWArgs,
    no_weight_decay_mask,
)

# Elements of a leaf per chunk of the kernel's plan (a multiple of 4, so
# every chunk but a leaf's last starts and ends on a 16-byte boundary).
# Chosen on the card by chip_smoke.py's sweep of K3 over the ViT-B/14
# leaves: of 8K-64K the smallest was the fastest, by about 1% (likely
# because the persistent grid's last round is shorter with more chunks).
CHUNK_ELEMS = 8192
# One chunk: elements [start, start + count) of leaf ``leaf``; the layout of
# the kernel's ``Chunk``.
CHUNK = np.dtype([("start", np.int64), ("leaf", np.int32),
                  ("count", np.int32)])


def plan_chunks(sizes: Sequence[int],
                chunk_elems: int = CHUNK_ELEMS) -> np.ndarray:
    """Split leaves of ``sizes`` elements into runs of at most
    ``chunk_elems``: a :data:`CHUNK` array, leaf by leaf, in order. Every
    element of every leaf is in exactly one chunk; a leaf of 0 elements has
    none."""
    if chunk_elems <= 0 or chunk_elems % 4 or chunk_elems >= 2 ** 31:
        raise ValueError(f"chunk_elems {chunk_elems}: a positive multiple of "
                         "4 below 2^31")
    sizes = np.asarray(sizes, np.int64).reshape(-1)
    if (sizes < 0).any():
        raise ValueError("leaf sizes must be >= 0")
    per_leaf = -(-sizes // chunk_elems)
    leaf = np.repeat(np.arange(len(sizes)), per_leaf)
    first = np.cumsum(per_leaf) - per_leaf
    start = (np.arange(len(leaf)) - first[leaf]) * chunk_elems
    plan = np.empty(len(leaf), CHUNK)
    plan["start"] = start
    plan["leaf"] = leaf
    plan["count"] = np.minimum(chunk_elems, sizes[leaf] - start)
    return plan


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


def clip_scale_plain(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """where(norm < max_norm, 1, max_norm / norm) in float32, as the JAX
    package forms it (and the kernel, from the norm on the card)."""
    cn = torch.full_like(norm, max_norm)
    return torch.where(norm < cn, torch.ones_like(norm), cn / norm)


class LeafSet:
    """The leaves K3 updates in place: p, mu, nu and t of each leaf (four
    sequences of one tensor per leaf), checked once here.

    Each tensor is float32, contiguous, of its leaf's size and on one
    device; on a card also 16-byte aligned. There the chunk plan goes to the
    device once, and the addresses of p, mu, nu and t are kept for every
    step's table: the tensors are updated in place and must keep their
    storage (no ``.data =``); :meth:`holds` tells whether a step's tensors
    are these.
    """

    def __init__(self, p: Sequence[torch.Tensor], mu: Sequence[torch.Tensor],
                 nu: Sequence[torch.Tensor], t: Sequence[torch.Tensor],
                 chunk_elems: int = CHUNK_ELEMS) -> None:
        self.tensors = tuple(tuple(x) for x in (p, mu, nu, t))
        self.n = len(self.tensors[0])
        if self.n == 0 or any(len(x) != self.n for x in self.tensors):
            raise ValueError("fused_adamw_ema: p, mu, nu and t need one "
                             "tensor per leaf, and at least one leaf")
        self.device = self.tensors[0][0].device
        self.sizes = [x.numel() for x in self.tensors[0]]
        on_card = self.device.type == "cuda"
        for name, xs in zip(("p", "mu", "nu", "t"), self.tensors):
            for i, x in enumerate(xs):
                if (x.device != self.device or x.dtype != torch.float32
                        or not x.is_contiguous() or x.numel() != self.sizes[i]
                        or (on_card and x.data_ptr() % 16)):
                    raise ValueError(
                        f"fused_adamw_ema: {name} of leaf {i} must be a "
                        "contiguous float32 tensor (16-byte aligned on a "
                        f"card) of {self.sizes[i]} elements on {self.device}"
                    )
        if on_card:
            self.ptrs = np.array([[x.data_ptr() for x in xs]
                                  for xs in self.tensors], np.int64).T
            plan = plan_chunks(self.sizes, chunk_elems)
            self.n_chunks = len(plan)
            self.plan = torch.from_numpy(plan.view(np.int64)).to(self.device)

    def holds(self, p: Sequence[torch.Tensor],
              t: Sequence[torch.Tensor]) -> bool:
        """Whether ``p`` and ``t`` are this set's tensors, leaf by leaf."""
        return (len(p) == len(t) == self.n
                and all(map(operator.is_, p, self.tensors[0]))
                and all(map(operator.is_, t, self.tensors[3])))

    def stage(self, grads: Sequence[Optional[torch.Tensor]],
              scalars: np.ndarray) -> torch.Tensor:
        """The step's table on the card: (leaves, 5) addresses of g, p, mu,
        nu and t (0 for a ``None`` gradient), then the (leaves, 8) float32
        ``scalars``; one copy from a fresh pinned buffer, on the current
        stream. Each gradient must be a contiguous float32 tensor of its
        leaf's size on the leaves' device, 16-byte aligned."""
        n = self.n
        if len(grads) != n or np.shape(scalars) != (n, 8):
            raise ValueError(f"fused_adamw_ema: {n} gradients and a ({n}, 8) "
                             "scalar table")
        dev = self.device
        if not all([g is None or (g.dtype is torch.float32 and g.device == dev
                                  and g.is_contiguous()) for g in grads]):
            raise ValueError("fused_adamw_ema: gradients must be contiguous "
                             f"float32 on {dev}")
        g_ptrs = np.array([0 if g is None else g.data_ptr() for g in grads],
                          np.int64)
        g_sizes = [s if g is None else g.numel()
                   for g, s in zip(grads, self.sizes)]
        if (g_ptrs % 16).any() or g_sizes != self.sizes:
            raise ValueError("fused_adamw_ema: gradients must be 16-byte "
                             "aligned and of their leaves' sizes")
        staging = torch.empty(9 * n, dtype=torch.int64, pin_memory=True)
        buf = staging.numpy()
        table = buf[:5 * n].reshape(n, 5)
        table[:, 0] = g_ptrs
        table[:, 1:] = self.ptrs
        buf[5 * n:].view(np.float32).reshape(n, 8)[:] = scalars
        return staging.to(self.device, non_blocking=True)

    def launch(self, table: torch.Tensor,
               clip: Optional[Tuple[torch.Tensor, float]], *, b1: float,
               b2: float, eps: float) -> None:
        """K3 over every leaf with a staged ``table`` (:meth:`stage`). With
        ``clip`` = (grad norm, max norm) the kernel forms each leaf's cs from
        the norm on the card; without, cs is the table's column 0."""
        norm, max_norm = (None, 0.0) if clip is None else clip
        if norm is not None and (norm.device != self.device
                                 or norm.dtype != torch.float32
                                 or norm.numel() != 1):
            raise ValueError("fused_adamw_ema: the grad norm must be one "
                             "float32 value on the leaves' device")
        if self.n_chunks == 0:
            return
        fn = _native.function("fused_adamw_ema")
        err = fn(
            self.plan.data_ptr(), self.n_chunks, table.data_ptr(),
            table.data_ptr() + 40 * self.n,
            None if norm is None else norm.data_ptr(), float(max_norm),
            b1, 1.0 - b1, b2, 1.0 - b2, eps,
            torch.cuda.current_stream(self.device).cuda_stream,
        )
        _native.check(err, "fused_adamw_ema")
        fused_adamw_ema.launches += 1


def fused_adamw_ema(
    leaves: LeafSet, grads: Sequence[Optional[torch.Tensor]],
    scalars: np.ndarray, clip: Optional[Tuple[torch.Tensor, float]] = None,
    *, b1: float, b2: float, eps: float,
) -> None:
    """K3 on every leaf of ``leaves``, in place on p, mu, nu and t.

    ``grads``: one float32 gradient per leaf, ``None`` for zeros.
    ``scalars``: (leaves, 8) float32, a row (cs, bc1, bc2, a, wd, m, 0, 0)
    per leaf. ``clip``: (grad norm, max norm), whose clip scale replaces
    column 0. On a card one launch (or a raise); on the CPU the plain version
    leaf by leaf, its results copied back in place.
    """
    if leaves.device.type == "cuda":
        leaves.launch(leaves.stage(grads, scalars), clip, b1=b1, b2=b2,
                      eps=eps)
        return
    table = torch.from_numpy(np.array(scalars, np.float32))
    if clip is not None:
        table[:, 0] = clip_scale_plain(*clip)
    for i, g in enumerate(grads):
        p, mu, nu, t = (xs[i] for xs in leaves.tensors)
        outs = fused_adamw_ema_leaf_plain(
            torch.zeros_like(p) if g is None else g, p, mu, nu, t, table[i],
            b1=b1, b2=b2, eps=eps)
        for dst, src in zip((p, mu, nu, t), outs):
            dst.copy_(src)


fused_adamw_ema.launches = 0


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
        self.weight_decay_schedule = weight_decay_schedule
        self.momentum_fn = momentum_fn
        self.update_scales_fn = update_scales_fn
        wd_mask = (dict(wd_mask) if wd_mask is not None
                   else no_weight_decay_mask(params))
        self.names = list(params)
        # The per-leaf factors that no step changes, as vectors.
        self._lr_scale = np.array(
            [lr_scales[n] if lr_scales is not None else 1.0
             for n in self.names], np.float32)
        self._decays = np.array([bool(wd_mask[n]) for n in self.names])
        self.count = 0
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in params.items()}
        self._leaves: Optional[LeafSet] = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` into the moments in place."""
        self.count = int(state["count"])
        for key in ("mu", "nu"):
            for name, value in getattr(self, key).items():
                value.copy_(state[key][name])

    def scalar_table(self, step: int) -> np.ndarray:
        """(leaves, 8) float32: [cs, bc1, bc2, a, wd, m, 0, 0], computed in
        float32 as the JAX path does; cs is 1 (the kernel replaces it with
        the clip scale where a clip norm is set)."""
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
        out = np.zeros((len(self.names), 8), np.float32)
        out[:, 0] = 1.0
        out[:, 1] = bc1
        out[:, 2] = bc2
        out[:, 3] = lr * self._lr_scale
        if self.update_scales_fn is not None:
            us = self.update_scales_fn(step)
            out[:, 3] *= np.array([us[n] for n in self.names], np.float32)
        out[:, 4] = np.where(self._decays, wd, f32(0.0))
        out[:, 5] = m
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
        grad norm (a device scalar, before clipping). A ``None`` gradient
        counts as zeros."""
        a = self.args
        g_list = [grads[n] for n in self.names]
        p_list = [params[n] for n in self.names]
        t_list = [teacher[n] for n in self.names]
        if self._leaves is None or not self._leaves.holds(p_list, t_list):
            self._leaves = LeafSet(p_list, [self.mu[n] for n in self.names],
                                   [self.nu[n] for n in self.names], t_list)
        present = [g for g in g_list if g is not None]
        grad_norm = (global_norm(present) if present else torch.zeros(
            (), dtype=torch.float32, device=p_list[0].device))
        clip = (None if self.grad_clip_norm is None
                else (grad_norm, float(self.grad_clip_norm)))
        fused_adamw_ema(self._leaves, g_list, self.scalar_table(step), clip,
                        b1=float(a.betas[0]), b2=float(a.betas[1]),
                        eps=float(a.eps))
        self.count += 1
        return grad_norm


def build_fused_updater(
    method,
    optim_args,
    learning_rate,
    params: Mapping[str, torch.Tensor],
    total_steps: int,
) -> Optional[FusedAdamWEMA]:
    """FusedAdamWEMA for an (AdamW, EMA-method) pair, else None: plain AdamW
    and a method whose ``post_update`` is exactly the teacher EMA (its
    ``fused_ema_momentum``). Other pairs take the unfused chain
    (``_optim/update.py``), as in the JAX package."""
    if type(optim_args) is not AdamWArgs:
        return None
    if method.fused_ema_momentum(0, total_steps) is None:
        return None
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
