"""The slice as a whole: DINOv2 steps of the port against the JAX package.

``dinov2/vittest14`` with the small head the JAX benchmark uses on the CPU
(64 prototypes, hidden 32, bottleneck 16, 2 local views, 28^2 / 14^2
views), float32, drop path 0. Both packages start from the same
checkpoint-scale weights (carried by ``params_from_jax``) and take the same
views; the iBOT masks are the ones the JAX loss draws from its own key
(``methods/dinov2.py``: ``k_mask, _, _ = split(rng, 3)``), handed to the
port. Each step runs the loss, its gradient and the fused AdamW+EMA update
(JAX: ``jnp`` mode) in both; the loss, the student, the EMA teacher and the
centers are compared after every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu._optim import build_optimizer, cosine_warmup as jax_cw
from lightly_train_tpu._optim.fused_update import build_fused_updater as jbfu
from lightly_train_tpu.methods.dinov2 import DINOv2 as JaxDINOv2
from lightly_train_tpu.methods.dinov2 import DINOv2Args as JaxDINOv2Args
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops.masking import random_block_masks
from lightly_train_tpu_torch._commands.train_loop import make_train_step
from lightly_train_tpu_torch._optim import cosine_warmup
from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
from lightly_train_tpu_torch.models.from_jax import (
    method_state_from_jax,
    params_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model

SMALL = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
             local_view_count=2, global_image_size=28, local_image_size=14,
             freeze_last_layer_steps=1)
B, TOTAL, LR = 4, 10, 5e-3


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


@pytest.fixture(scope="module")
def jax_setup():
    method = JaxDINOv2(jax_get_wrapped_model("dinov2/vittest14"),
                       JaxDINOv2Args(**SMALL))
    params, model_state, method_state = method.init(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3), jnp.uint8))
    params = checkpoint_scale(params, 0)
    method_state = {**method_state,
                    "teacher": jax.tree_util.tree_map(jnp.copy, params)}
    return method, params, model_state, method_state


def _port_setup(jax_params, jax_method_state):
    method = DINOv2(get_wrapped_model("dinov2/vittest14"), DINOv2Args(**SMALL))
    params, method_state = method.init(torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    params.load_state_dict(params_from_jax(jax.device_get(jax_params)))
    carried = method_state_from_jax(jax.device_get(jax_method_state))
    method_state["teacher"].load_state_dict(carried["teacher"])
    method_state["dino_center"] = carried["dino_center"]
    method_state["ibot_center"] = carried["ibot_center"]
    named = dict(params.named_parameters())
    updater = build_fused_updater(method, method.default_optimizer_args(),
                                  cosine_warmup(LR, TOTAL, 2), named, TOTAL)
    return method, TrainState(0, params, method_state, updater)


def _views(step):
    rng = np.random.default_rng(100 + step)
    g = [rng.standard_normal((B, 28, 28, 3)).astype(np.float32)
         for _ in range(2)]
    loc = [rng.standard_normal((B, 14, 14, 3)).astype(np.float32)
           for _ in range(2)]
    return g + loc


# The key projection's bias has an exactly zero gradient (softmax is
# invariant to a shift shared by all keys), so what each package computes
# for it is rounding noise, which Adam scales to updates of +-lr. It is held
# to its zero gradient instead (``test_key_bias_gradient_is_zero``).
DEGENERATE = "attn.k.bias"


def _assert_tree_close(state_dict, jax_tree, rtol, atol, what):
    ref = params_from_jax(jax.device_get(jax_tree))
    assert set(ref) == set(state_dict), what
    for name, r in ref.items():
        if name.endswith(DEGENERATE):
            continue
        np.testing.assert_allclose(state_dict[name].detach().numpy(),
                                   r.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def test_three_dinov2_steps_match_jax(jax_setup):
    j_method, j_params, j_model_state, j_method_state = jax_setup
    method, state = _port_setup(j_params, j_method_state)
    j_lr = jax_cw(LR, TOTAL, 2)
    j_args = j_method.default_optimizer_args()
    j_opt = build_optimizer(
        j_args, j_lr, j_params, grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params)).init(j_params)
    j_upd = jbfu(j_method, j_args, j_lr, j_params, TOTAL, mode="jnp")
    step_fn = make_train_step(method, TOTAL)

    @jax.jit
    def j_grad(p, method_state, views, rng, step):
        return jax.value_and_grad(
            lambda p: j_method.loss_fn(p, j_model_state, method_state, views,
                                       rng, step, TOTAL),
            has_aux=True)(p)
    gh = 28 // 14

    for step in range(3):
        views = _views(step)
        rng = jax.random.key(1000 + step)
        k_mask = jax.random.split(rng, 3)[0]
        mask, _ = random_block_masks(k_mask, 2 * B, (gh, gh),
                                     SMALL.get("mask_prob", 0.5),
                                     (0.1, 0.5))

        (j_loss, (_, j_method_state, _)), grads = j_grad(
            j_params, j_method_state, [jnp.asarray(v) for v in views], rng,
            jnp.asarray(step))
        j_params, teacher, j_opt, _ = j_upd.update_and_apply(
            grads, j_opt, j_params, j_method_state["teacher"],
            jnp.asarray(step))
        j_method_state = {**j_method_state, "teacher": teacher}

        metrics = step_fn(state, None, None,
                          views=[[torch.tensor(v) for v in views]],
                          masks=[torch.tensor(np.asarray(mask))])
        # fp32 throughout; the parameters pass through 3 Adam steps whose
        # first update is ~lr * sign(g), so small gradient differences
        # stay small.
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(j_loss), rtol=1e-4)
        _assert_tree_close(dict(state.params.named_parameters()), j_params,
                           rtol=1e-4, atol=1e-5, what=f"step {step} params")
        _assert_tree_close(
            dict(state.method_state["teacher"].named_parameters()),
            j_method_state["teacher"], rtol=1e-4, atol=1e-5,
            what=f"step {step} teacher")
        for key in ("dino_center", "ibot_center"):
            np.testing.assert_allclose(
                state.method_state[key].numpy(),
                np.asarray(j_method_state[key]), rtol=1e-4, atol=1e-5)
    assert state.step == 3


def test_optimizer_rules_match_jax(jax_setup):
    """lr scales, weight-decay mask and the prototype freeze, per name."""
    j_method, j_params, _, j_method_state = jax_setup
    method, state = _port_setup(j_params, j_method_state)
    named = dict(state.params.named_parameters())

    shapes = {".".join(str(k.key) for k in path): np.shape(v)
              for path, v in jax.tree_util.tree_flatten_with_path(j_params)[0]}

    def by_name(tree):
        """A JAX per-leaf tree keyed by the port's parameter names."""
        out = {}
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
            jname = ".".join(str(k.key) for k in path)
            *head, leaf = jname.split(".")
            nested = {leaf: np.zeros(shapes[jname])}
            for h in reversed(head):
                nested = {h: nested}
            out[next(iter(params_from_jax(nested)))] = v
        return out

    assert by_name(j_method.lr_scales(j_params)) == pytest.approx(
        method.lr_scales(named))
    assert by_name(j_method.wd_mask(j_params)) == method.wd_mask(named)
    for step in (0, 1):
        j = {k: float(v) for k, v in
             by_name(j_method.update_scales(j_params, step)).items()}
        assert j == method.update_scales(named, step)


def test_key_bias_gradient_is_zero(jax_setup):
    j_method, j_params, _, j_method_state = jax_setup
    method, state = _port_setup(j_params, j_method_state)
    views = [torch.tensor(v) for v in _views(0)]
    mask = torch.zeros(2 * B, 4, dtype=torch.bool)
    mask[:, 0] = True
    loss, _ = method.loss_fn(state.params, state.method_state, views, 0,
                             TOTAL, masks=mask)
    loss.backward()
    for name, p in state.params.named_parameters():
        if name.endswith(DEGENERATE):
            assert p.grad.abs().max() < 1e-5 * loss.abs()
        elif name.endswith("attn.q.weight"):
            assert p.grad.abs().max() > 1e-4


# The step of the one-step tests: past the lr warmup (2 steps), so the
# update moves the parameters.
STEP = 2


def _one_step(center_method, dtype):
    """DINOv2 step STEP (loss, gradient, fused AdamW+EMA update) of each
    package in ``dtype`` from shared parameters, views and iBOT masks:
    (port state, port metrics, JAX loss, JAX gradients, JAX params, JAX
    method state); the port's gradients stay in its parameters' ``.grad``.
    """
    args = {**SMALL, "center_method": center_method}
    j_dtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    j_method = JaxDINOv2(jax_get_wrapped_model("dinov2/vittest14",
                                               dtype=j_dtype),
                         JaxDINOv2Args(**args))
    j_params, j_model_state, j_method_state = j_method.init(
        jax.random.key(0), jnp.zeros((2, 32, 32, 3), jnp.uint8))
    j_params = checkpoint_scale(j_params, 0)
    j_method_state = {**j_method_state,
                      "teacher": jax.tree_util.tree_map(jnp.copy, j_params)}
    method = DINOv2(get_wrapped_model("dinov2/vittest14", dtype=dtype),
                    DINOv2Args(**args))
    params, method_state = method.init(torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    method_state["teacher"].load_state_dict(params_from_jax(
        jax.device_get(j_params)))
    named = dict(params.named_parameters())
    updater = build_fused_updater(method, method.default_optimizer_args(),
                                  cosine_warmup(LR, TOTAL, 2), named, TOTAL)
    state = TrainState(STEP, params, method_state, updater)

    j_lr = jax_cw(LR, TOTAL, 2)
    j_args = j_method.default_optimizer_args()
    j_opt = build_optimizer(
        j_args, j_lr, j_params, grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params)).init(j_params)
    j_upd = jbfu(j_method, j_args, j_lr, j_params, TOTAL, mode="jnp")
    views = _views(0)
    rng = jax.random.key(1000)
    mask, _ = random_block_masks(jax.random.split(rng, 3)[0], 2 * B, (2, 2),
                                 0.5, (0.1, 0.5))
    j_grad = jax.jit(lambda p, ms, views, rng: jax.value_and_grad(
        lambda p: j_method.loss_fn(p, j_model_state, ms, views, rng,
                                   jnp.asarray(STEP), TOTAL),
        has_aux=True)(p))
    (j_loss, (_, j_method_state, _)), grads = j_grad(
        j_params, j_method_state, [jnp.asarray(v) for v in views], rng)
    j_params, teacher, _, _ = jax.jit(j_upd.update_and_apply)(
        grads, j_opt, j_params, j_method_state["teacher"], jnp.asarray(STEP))
    j_method_state = {**j_method_state, "teacher": teacher}
    metrics = make_train_step(method, TOTAL)(
        state, None, None, views=[[torch.tensor(v) for v in views]],
        masks=[torch.tensor(np.asarray(mask))])
    return state, metrics, j_loss, grads, j_params, j_method_state


def _grad_errors(state, j_grads):
    """name -> relative L2 error of the port's gradient against the JAX
    one, the key bias left out (its gradient is zero, DEGENERATE)."""
    ref = params_from_jax(jax.device_get(j_grads))
    named = dict(state.params.named_parameters())
    return {name: ((named[name].grad - r).norm() / r.norm()).item()
            for name, r in ref.items() if not name.endswith(DEGENERATE)}


def test_a_sinkhorn_step_matches_jax():
    """center_method="sinkhorn": the teacher targets by Sinkhorn-Knopp at
    the starting temperature (the masked patches only for iBOT), the
    centers left as they were; fp32, the tolerances of the softmax steps."""
    state, metrics, j_loss, j_grads, j_params, j_method_state = _one_step(
        "sinkhorn", torch.float32)
    np.testing.assert_allclose(float(metrics["train_loss"]), float(j_loss),
                               rtol=1e-4)
    assert max(_grad_errors(state, j_grads).values()) < 1e-4
    _assert_tree_close(dict(state.params.named_parameters()), j_params,
                       rtol=1e-4, atol=1e-5, what="sinkhorn params")
    _assert_tree_close(
        dict(state.method_state["teacher"].named_parameters()),
        j_method_state["teacher"], rtol=1e-4, atol=1e-5,
        what="sinkhorn teacher")
    for key in ("dino_center", "ibot_center"):
        assert not state.method_state[key].any()
        assert not np.asarray(j_method_state[key]).any()


def test_a_bf16_step_matches_jax():
    """bf16, the default precision: both packages compute the ViT and the
    heads in bf16 against fp32 parameters, the losses in fp32, and round
    in different orders. Measured on the CPU: the loss 5.1e-4 relative
    apart, the gradients 9.8e-3 relative L2 per leaf in the median and
    2.8e-2 at most (the q projections, whose gradient passes through the
    bf16 softmax), the centers 1.4e-4 (of 0.06). Tolerances: the loss
    5e-3 (about one bf16 rounding, 2^-8), the gradients 3e-2 in the median
    and 1e-1 per leaf, the centers 1e-3; the first Adam step moves each
    parameter by lr times its gradient's sign in both, which the
    parameters and the EMA teacher are held to as in fp32."""
    state, metrics, j_loss, j_grads, j_params, j_method_state = _one_step(
        "softmax", torch.bfloat16)
    np.testing.assert_allclose(float(metrics["train_loss"]), float(j_loss),
                               rtol=5e-3)
    errors = list(_grad_errors(state, j_grads).values())
    assert np.median(errors) < 3e-2 and max(errors) < 1e-1
    _assert_tree_close(dict(state.params.named_parameters()), j_params,
                       rtol=1e-4, atol=1e-5, what="bf16 params")
    _assert_tree_close(
        dict(state.method_state["teacher"].named_parameters()),
        j_method_state["teacher"], rtol=1e-4, atol=1e-5, what="bf16 teacher")
    for key in ("dino_center", "ibot_center"):
        np.testing.assert_allclose(state.method_state[key].numpy(),
                                   np.asarray(j_method_state[key]), atol=1e-3)
