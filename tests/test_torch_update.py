"""The port's unfused update chain against the JAX package's
``build_optimizer`` (optax), and DINOv2 on it with LARS.

Each case runs three steps of AdamW, SGD or LARS, with and without a clip
norm, and with the generic weight-decay mask, with a given mask and lr
scales, or with a weight-decay schedule, on the same parameters and
gradients in both packages (float32). The parameters, the returned grad
norm and the count are compared after every step. The update runs leaf by
leaf; it is held bitwise to the chain over whole trees that it replaced,
kept here as ``listwise_update``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightly_train_tpu._optim import build_optimizer
from lightly_train_tpu._optim import cosine_warmup as jax_cw
from lightly_train_tpu._optim.optimizers import AdamWArgs as JaxAdamWArgs
from lightly_train_tpu._optim.optimizers import LARSArgs as JaxLARSArgs
from lightly_train_tpu._optim.optimizers import SGDArgs as JaxSGDArgs
from lightly_train_tpu.methods.dinov2 import DINOv2 as JaxDINOv2
from lightly_train_tpu.methods.dinov2 import DINOv2Args as JaxDINOv2Args
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops.ema import cosine_schedule as jax_cosine_schedule
from lightly_train_tpu.ops.masking import random_block_masks
from lightly_train_tpu_torch._commands.train_loop import make_train_step
from lightly_train_tpu_torch._optim import (
    AdamWArgs,
    LARSArgs,
    SGDArgs,
    cosine_warmup,
)
from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
from lightly_train_tpu_torch._optim.fused_update import global_norm
from lightly_train_tpu_torch._optim.update import UnfusedUpdate, build_update
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
from lightly_train_tpu_torch.models.from_jax import (
    method_state_from_jax,
    params_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops.ema import cosine_schedule
from torch_fixtures.threads import one_torch_thread  # noqa: F401

OPTIMIZERS = {
    "adamw": (JaxAdamWArgs(lr=0.1, weight_decay=0.05),
              AdamWArgs(lr=0.1, weight_decay=0.05)),
    "sgd": (JaxSGDArgs(lr=0.1, momentum=0.9, weight_decay=0.05),
            SGDArgs(lr=0.1, momentum=0.9, weight_decay=0.05)),
    "sgd_no_momentum": (JaxSGDArgs(lr=0.1, momentum=0.0),
                        SGDArgs(lr=0.1, momentum=0.0)),
    "lars": (JaxLARSArgs(lr=0.1, weight_decay=0.05, trust_coefficient=0.01),
             LARSArgs(lr=0.1, weight_decay=0.05, trust_coefficient=0.01)),
}
TOTAL = 10


def _tree(rng):
    """A Flax-like tree: a dense layer, a norm and a zero kernel (LARS's
    zero parameter norm)."""
    return {
        "dense": {"kernel": rng.standard_normal((5, 4)),
                  "bias": 0.5 * rng.standard_normal(4)},
        "norm": {"scale": 1.0 + 0.2 * rng.standard_normal(4)},
        "zero": {"kernel": np.zeros((3, 2))},
    }


def _as_jax(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), tree)


@pytest.mark.parametrize("rules", ["generic", "mask_and_scales",
                                   "wd_schedule"])
@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_unfused_chain_matches_optax(opt, clip, rules):
    rng = np.random.default_rng(0)
    j_params = _as_jax(_tree(rng))
    params = {k: v.clone() for k, v in params_from_jax(j_params).items()}
    j_args, args = OPTIMIZERS[opt]
    kw_j, kw_t = {}, {}
    if rules == "mask_and_scales":
        mask = {"dense": {"kernel": False, "bias": True},
                "norm": {"scale": True}, "zero": {"kernel": True}}
        scales = {"dense": {"kernel": 0.5, "bias": 2.0},
                  "norm": {"scale": 1.0}, "zero": {"kernel": 0.25}}
        kw_j = dict(wd_mask=mask, lr_scales=scales)
        kw_t = dict(
            wd_mask={"dense.weight": False, "dense.bias": True,
                     "norm.weight": True, "zero.weight": True},
            lr_scales={"dense.weight": 0.5, "dense.bias": 2.0,
                       "norm.weight": 1.0, "zero.weight": 0.25})
    elif rules == "wd_schedule":
        kw_j = dict(weight_decay_schedule=lambda step: jax_cosine_schedule(
            step, TOTAL, 0.04, 0.4))
        kw_t = dict(weight_decay_schedule=lambda step: cosine_schedule(
            step, TOTAL, 0.04, 0.4))
    j_opt = build_optimizer(j_args, jax_cw(0.1, TOTAL, 2), j_params,
                            grad_clip_norm=clip, **kw_j)
    j_state = j_opt.init(j_params)
    update = UnfusedUpdate(args, cosine_warmup(0.1, TOTAL, 2), params,
                           grad_clip_norm=clip, **kw_t)
    for step in range(3):
        grads = _tree(rng)
        grads["zero"]["kernel"] = rng.standard_normal((3, 2))
        if step == 1:  # a leaf with no gradient: LARS's zero update norm
            grads["norm"]["scale"] = np.zeros(4)
        j_grads = _as_jax(grads)
        updates, j_state = j_opt.update(j_grads, j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_grads = params_from_jax(j_grads)
        if step == 1:
            t_grads["norm.weight"] = None  # None counts as zeros
        norm = update.update_and_apply(t_grads, params)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(j_grads)),
                                   rtol=1e-6)
        for name, ref in params_from_jax(j_params).items():
            np.testing.assert_allclose(params[name].numpy(), ref.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{opt} step {step} {name}")
    assert update.count == 3


def test_unfused_state_round_trips():
    params = {"w": torch.ones(3, 2)}
    for args, keys in ((AdamWArgs(), ["count", "mu", "nu"]),
                       (SGDArgs(), ["count", "trace"]),
                       (SGDArgs(momentum=0.0), ["count"]),
                       (LARSArgs(), ["count", "trace"])):
        a = UnfusedUpdate(args, 0.1, params)
        a.update_and_apply({"w": torch.full((3, 2), 0.5)}, params)
        assert sorted(a.state_dict()) == sorted(keys)
        b = UnfusedUpdate(args, 0.1, params)
        b.load_state_dict(a.state_dict())
        assert b.count == 1
        for key in keys[1:]:
            assert torch.equal(b.moments[key]["w"], a.moments[key]["w"])


@torch.no_grad()
def listwise_update(self: UnfusedUpdate, grads, params, mask=None):
    """The chain as it ran before the leaf-by-leaf update: each step a new
    list over all leaves, then the method's mask and ``p += u`` over the
    whole tree (a copy of the port's earlier ``UnfusedUpdate.update`` and
    ``apply_updates``). Returns the global norm."""
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
    updates = {n: ui * step for n, ui in zip(self.names, u)}
    if mask is not None:
        updates = mask(updates)
    for name, ui in updates.items():
        params[name].add_(ui.to(params[name].dtype))
    return norm


BITWISE_OPTIMIZERS = {
    "adamw": AdamWArgs(lr=0.1, weight_decay=0.05),
    "sgd": SGDArgs(lr=0.1, momentum=0.9, weight_decay=0.05),
    "sgd_no_momentum": SGDArgs(lr=0.1, momentum=0.0, weight_decay=0.05),
    "lars": LARSArgs(lr=0.1, weight_decay=0.05, trust_coefficient=0.01),
    "lars_no_momentum": LARSArgs(lr=0.1, momentum=0.0, weight_decay=1e-6,
                                 trust_coefficient=0.001),
}


@pytest.mark.parametrize("rules", ["generic", "mask_scales_and_freeze"])
@pytest.mark.parametrize("clip", [None, 0.5, 100.0])
@pytest.mark.parametrize("opt", sorted(BITWISE_OPTIMIZERS))
def test_leaf_by_leaf_update_is_bitwise_the_listwise_chain(opt, clip, rules):
    """Three steps of the leaf-by-leaf update and of the chain over whole
    trees from the same parameters, gradients and state give bitwise the
    same parameters, norms, moments and counts: with and without momentum
    and clipping (0.5 clips, 100 does not), a None gradient, a zero
    parameter, and with a weight-decay mask, lr scales, a weight-decay
    schedule and a method mask that freezes one leaf at the first step."""
    rng = np.random.default_rng(1)
    names = ["embed.weight", "blocks.0.fc.weight", "blocks.0.fc.bias",
             "norm.weight", "head.prototypes.weight", "zero.weight"]
    shapes = [(7, 3), (5, 4), (4,), (4,), (6, 5), (3, 2)]
    start = {n: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
             for n, s in zip(names, shapes)}
    start["zero.weight"].zero_()
    kw, freeze = {}, None
    if rules == "mask_scales_and_freeze":
        kw = dict(
            wd_mask={n: not n.endswith("bias") for n in names},
            lr_scales={n: 0.5 + 0.25 * i for i, n in enumerate(names)},
            weight_decay_schedule=lambda step: cosine_schedule(
                step, TOTAL, 0.04, 0.4))

        def freeze(step):
            live = 1.0 if step >= 1 else 0.0
            return lambda name: live if "prototypes" in name else 1.0
    params = {"new": {n: x.clone() for n, x in start.items()},
              "old": {n: x.clone() for n, x in start.items()}}
    updaters = {k: UnfusedUpdate(BITWISE_OPTIMIZERS[opt],
                                 cosine_warmup(0.1, TOTAL, 1), params[k],
                                 grad_clip_norm=clip, **kw)
                for k in params}
    for step in range(3):
        grads = {n: torch.tensor(rng.standard_normal(x.shape),
                                 dtype=torch.float32)
                 for n, x in start.items()}
        if step == 1:
            grads["norm.weight"] = None
        scale = freeze(step) if freeze else None
        norm_new = updaters["new"].update_and_apply(
            dict(grads), params["new"],
            None if scale is None else lambda name, u: u * scale(name))
        norm_old = listwise_update(
            updaters["old"], grads, params["old"],
            None if scale is None else
            lambda updates: {n: u * scale(n) for n, u in updates.items()})
        assert torch.equal(norm_new, norm_old)
        for n in names:
            assert torch.equal(params["new"][n], params["old"][n]), (step, n)
        for key, tensors in updaters["old"].moments.items():
            for n, value in tensors.items():
                assert torch.equal(updaters["new"].moments[key][n], value)
    assert updaters["new"].count == updaters["old"].count == 3
    assert not torch.equal(params["new"]["embed.weight"],
                           start["embed.weight"])


def test_leaf_by_leaf_update_takes_each_gradient_out():
    """The gradients leave the dict the update is given, so that a caller
    holding no other reference frees each as its leaf is applied."""
    params = {"a": torch.ones(3), "b": torch.ones(2)}
    update = UnfusedUpdate(LARSArgs(momentum=0.0), 0.1, params)
    grads = {"a": torch.full((3,), 0.5), "b": None}
    update.update_and_apply(grads, params)
    assert grads == {}


def test_only_adamw_with_an_ema_method_takes_the_fused_update():
    method = DINOv2(get_wrapped_model("dinov2/vittest14"),
                    DINOv2Args(**SMALL))
    params, _ = method.init(torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    named = dict(params.named_parameters())
    fused = build_fused_updater(method, AdamWArgs(), 1e-3, named, TOTAL)
    assert fused is not None
    for args in (SGDArgs(), LARSArgs()):
        assert build_fused_updater(method, args, 1e-3, named, TOTAL) is None


# --- DINOv2 on the unfused chain: LARS, with the EMA teacher as its
# post_update and the prototype freeze as its mask_updates --------------

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14,
             freeze_last_layer_steps=1)
B, LR = 4, 2.0
# The key bias has an exactly zero gradient: LARS's trust ratio scales its
# rounding noise up to a full step in each package.
DEGENERATE = "attn.k.bias"


def checkpoint_scale(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "g"):
            return 1.0 + 0.2 * rng.standard_normal(x.shape)
        if name == "gamma":
            return 0.5 + 0.2 * rng.standard_normal(x.shape)
        if name == "v":
            return 0.3 * rng.standard_normal(x.shape)
        return 0.5 * rng.standard_normal(x.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), tree)


def _assert_tree_close(state_dict, jax_tree, what):
    ref = params_from_jax(jax.device_get(jax_tree))
    assert set(ref) == set(state_dict), what
    for name, r in ref.items():
        if name.endswith(DEGENERATE):
            continue
        np.testing.assert_allclose(state_dict[name].detach().numpy(),
                                   r.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")


def test_two_dinov2_lars_steps_match_jax():
    j_method = JaxDINOv2(jax_get_wrapped_model("dinov2/vittest14"),
                         JaxDINOv2Args(**SMALL))
    j_params, j_model_state, j_ms = j_method.init(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3), jnp.uint8))
    j_params = checkpoint_scale(j_params, 0)
    j_ms = {**j_ms, "teacher": jax.tree_util.tree_map(jnp.copy, j_params)}
    j_opt = build_optimizer(
        JaxLARSArgs(), jax_cw(LR, TOTAL, 0), j_params,
        grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params))
    j_opt_state = j_opt.init(j_params)

    method = DINOv2(get_wrapped_model("dinov2/vittest14"),
                    DINOv2Args(**SMALL))
    params, ms = method.init(torch.Generator().manual_seed(0),
                             torch.device("cpu"))
    params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    carried = method_state_from_jax(jax.device_get(j_ms))
    ms["teacher"].load_state_dict(carried["teacher"])
    ms.update(dino_center=carried["dino_center"],
              ibot_center=carried["ibot_center"])
    named = dict(params.named_parameters())
    state = TrainState(0, params, ms, build_update(
        method, LARSArgs(), cosine_warmup(LR, TOTAL, 0), named, TOTAL))
    step_fn = make_train_step(method, TOTAL)

    @jax.jit
    def j_grad(p, method_state, views, rng, step):
        return jax.value_and_grad(
            lambda p: j_method.loss_fn(p, j_model_state, method_state, views,
                                       rng, step, TOTAL),
            has_aux=True)(p)

    for step in range(2):
        rng_np = np.random.default_rng(100 + step)
        views = ([rng_np.standard_normal((B, 28, 28, 3)).astype(np.float32)
                  for _ in range(2)]
                 + [rng_np.standard_normal((B, 14, 14, 3)).astype(np.float32)
                    for _ in range(2)])
        rng = jax.random.key(1000 + step)
        mask, _ = random_block_masks(jax.random.split(rng, 3)[0], 2 * B,
                                     (2, 2), 0.5, (0.1, 0.5))
        (j_loss, (_, j_ms, _)), grads = j_grad(
            j_params, j_ms, [jnp.asarray(v) for v in views], rng,
            jnp.asarray(step))
        updates, j_opt_state = j_opt.update(grads, j_opt_state, j_params)
        updates = j_method.mask_updates(updates, jnp.asarray(step))
        j_params = optax.apply_updates(j_params, updates)
        j_ms = j_method.post_update(j_params, j_ms, jnp.asarray(step), TOTAL)

        metrics = step_fn(state, None, None,
                          views=[[torch.tensor(v) for v in views]],
                          masks=[torch.tensor(np.asarray(mask))])
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(j_loss), rtol=1e-4)
        _assert_tree_close(dict(state.params.named_parameters()), j_params,
                           f"step {step} params")
        _assert_tree_close(
            dict(state.method_state["teacher"].named_parameters()),
            j_ms["teacher"], f"step {step} teacher")
        for key in ("dino_center", "ibot_center"):
            np.testing.assert_allclose(state.method_state[key].numpy(),
                                       np.asarray(j_ms[key]), rtol=1e-4,
                                       atol=1e-5)
    assert state.step == 2 and state.updater.count == 2
