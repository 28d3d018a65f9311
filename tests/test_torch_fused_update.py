"""The port's fused AdamW+EMA update against the JAX package's.

The plain version of the kernel is held against the Pallas kernel run by the
interpreter (a leaf of at least 64K elements, which the JAX package sends to
its kernel) and against the jnp expression (a small leaf, which it does
not); ``FusedAdamWEMA`` is held against the JAX class in ``jnp`` mode for 3
steps with grad clipping, lr scales, a wd mask, the prototype freeze and an
EMA momentum schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightly_train_tpu._optim import AdamWArgs as JaxAdamWArgs
from lightly_train_tpu._optim.fused_update import (
    FusedAdamWEMA as JaxFusedAdamWEMA,
)
from lightly_train_tpu._optim.fused_update import _jnp_leaf, fused_adamw_ema_leaf
from lightly_train_tpu_torch._optim import AdamWArgs
from lightly_train_tpu_torch._optim import fused_update as F

HP = dict(b1=0.9, b2=0.999, eps=1e-8)
SCALARS = np.array([[0.7, 1.5, 1.1, 2e-3, 0.04, 0.995, 0.0, 0.0]], np.float32)


def _leaf_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    g, p, t = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mu = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    nu = (rng.random(shape) * 0.01).astype(np.float32)
    return g, p, mu, nu, t


@pytest.mark.parametrize("shape,pallas", [((256, 512), True), ((10, 10), False)])
def test_plain_leaf_matches_jax(shape, pallas):
    arrays = _leaf_inputs(shape, seed=shape[0])
    jargs = [jnp.asarray(a) for a in arrays] + [jnp.asarray(SCALARS)]
    if pallas:
        ref = fused_adamw_ema_leaf(*jargs, interpret=True, **HP)
    else:
        ref = _jnp_leaf(*jargs, **HP)
    tensors = [torch.tensor(a) for a in arrays]
    F.fused_adamw_ema_leaf(*tensors, torch.tensor(SCALARS[0]), **HP)
    # Same fp32 arithmetic in the same order; only XLA's fusion may contract
    # a multiply-add.
    for got, r in zip(tensors[1:], ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "student": {"w": rng.standard_normal((64, 32)).astype(np.float32),
                    "b": rng.standard_normal((32,)).astype(np.float32)},
        "prototypes": {"v": rng.standard_normal((16, 8)).astype(np.float32)},
        "cls_token": rng.standard_normal((1, 5, 8)).astype(np.float32),
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


LR_SCALES = {"student.w": 0.5, "student.b": 0.5, "prototypes.v": 1.0,
             "cls_token": 0.25}
WD_MASK = {"student.w": True, "student.b": False, "prototypes.v": True,
           "cls_token": False}
FREEZE_STEPS = 2


def _nest(flat):
    out = {}
    for name, v in flat.items():
        *head, leaf = name.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = v
    return out


def test_fused_updater_matches_jax_for_three_steps():
    params_np = _tree(0)
    names = list(_flat(params_np))

    lr = lambda c: 1e-3 * (1.0 + 0.1 * c)  # noqa: E731
    wd = lambda c: 0.04 + 0.001 * c  # noqa: E731
    momentum = lambda s: 0.99 + 0.001 * s  # noqa: E731

    def jax_scales(step):
        live = (jnp.asarray(step) >= FREEZE_STEPS).astype(jnp.float32)
        return _nest({n: live if n.startswith("prototypes") else 1.0
                      for n in names})

    args_j = JaxAdamWArgs(lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=0.04)
    j_params = jax.tree_util.tree_map(jnp.asarray, params_np)
    j_teacher = jax.tree_util.tree_map(jnp.copy, j_params)
    j_opt = (optax.scale_by_adam(0.9, 0.999, 1e-8).init(j_params),)
    j_upd = JaxFusedAdamWEMA(
        args_j, lr, j_params, grad_clip_norm=3.0,
        lr_scales=_nest(LR_SCALES), weight_decay_schedule=wd,
        momentum_fn=momentum, update_scales_fn=jax_scales,
        wd_mask=_nest(WD_MASK), mode="jnp",
    )

    t_params = {n: torch.tensor(v) for n, v in _flat(params_np).items()}
    t_teacher = {n: v.clone() for n, v in t_params.items()}
    t_upd = F.FusedAdamWEMA(
        AdamWArgs(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.04),
        lr, t_params, grad_clip_norm=3.0, lr_scales=LR_SCALES,
        weight_decay_schedule=wd, momentum_fn=momentum,
        update_scales_fn=lambda s: {
            n: float(s >= FREEZE_STEPS) if n.startswith("prototypes") else 1.0
            for n in names},
        wd_mask=WD_MASK,
    )

    rng = np.random.default_rng(1)
    for step in range(3):
        # Step 1 has huge gradients, so the global-norm clip triggers.
        grads_np = {n: (rng.standard_normal(v.shape)
                        * (100.0 if step == 1 else 0.1)).astype(np.float32)
                    for n, v in _flat(params_np).items()}
        j_params, j_teacher, j_opt, j_norm = j_upd.update_and_apply(
            jax.tree_util.tree_map(jnp.asarray, _nest(grads_np)), j_opt,
            j_params, j_teacher, jnp.asarray(step))
        t_norm = t_upd.update_and_apply(
            {n: torch.tensor(g) for n, g in grads_np.items()}, t_params,
            t_teacher, step)
        np.testing.assert_allclose(float(t_norm), float(j_norm), rtol=1e-5)
        for name, ref in _flat(j_params).items():
            np.testing.assert_allclose(t_params[name].numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        for name, ref in _flat(j_teacher).items():
            np.testing.assert_allclose(t_teacher[name].numpy(),
                                       np.asarray(ref), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    adam = j_opt[0]
    assert int(adam.count) == t_upd.count == 3
    for name, ref in _flat(adam.mu).items():
        np.testing.assert_allclose(t_upd.mu[name].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-8)
    for name, ref in _flat(adam.nu).items():
        np.testing.assert_allclose(t_upd.nu[name].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-9)
    # The prototypes were frozen for the first FREEZE_STEPS steps only.
    assert not np.allclose(t_params["prototypes.v"].numpy(),
                           params_np["prototypes"]["v"])


def test_leaf_wrapper_runs_plain_in_place_on_cpu():
    """On the CPU the wrapper runs the plain version in place and never
    touches the kernel library (no nvcc here)."""
    before = F.fused_adamw_ema_leaf.launches
    g, p, mu, nu, t = (torch.tensor(a) for a in _leaf_inputs((3, 5), 2))
    p0 = p.clone()
    F.fused_adamw_ema_leaf(g, p, mu, nu, t, torch.tensor(SCALARS[0]), **HP)
    assert not torch.equal(p, p0)
    assert F.fused_adamw_ema_leaf.launches == before
