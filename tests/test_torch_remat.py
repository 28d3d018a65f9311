"""Activation checkpointing (``model_args`` ``remat_every``, ``remat_policy``)
in the port's ViT and in the JAX package's.

Recomputing a block must change no number: the gradients with remat equal
those without it, in each package, and in the port with drop path on (its
drop path draws from an explicit generator, which the recompute must
restore and put back), and the draws after the step stay where they were.
The JAX ViT cannot train under remat with drop path on
(``test_jax_remat_with_drop_path_cannot_train``). The model is the
test-size ViT at depth 4, so that with ``remat_every`` 2 a recomputed block
(block 2) also drops paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.models import vit as JV
from lightly_train_tpu.models import wrapper as JW
from lightly_train_tpu_torch._commands.train_loop import make_train_step
from lightly_train_tpu_torch._optim import cosine_warmup
from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
from lightly_train_tpu_torch.models import vit as TV
from lightly_train_tpu_torch.models.from_jax import params_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.models.wrapper import WrappedModel

POLICIES = [None, "nothing_saveable", "everything_saveable", "dots_saveable",
            "checkpoint_dots", "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims"]
DEPTH = 4
# Fixed weights of the test loss: a random linear function of the CLS and
# the patch tokens (a sum of squares of the final LayerNorm's output is
# constant, and its gradient rounding noise).
_W = np.random.default_rng(9)
W_CLS = _W.standard_normal((4, 32)).astype(np.float32)
W_PATCH = _W.standard_normal((4, 9, 32)).astype(np.float32)


def _loss(out, lib):
    """The test loss of a (4, 42, 42, 3) batch's features."""
    return ((out["cls_token"] * lib.asarray(W_CLS)).sum()
            + (out["patch_tokens"] * lib.asarray(W_PATCH)).sum())


def _port_vit(remat_every=0, remat_policy=None, drop_path_rate=0.0):
    cfg = TV.vit_config("vittest", 14, drop_path_rate=drop_path_rate,
                        remat_every=remat_every, remat_policy=remat_policy)
    module = TV.VisionTransformer(dataclasses.replace(cfg, depth=DEPTH))
    module.reset_parameters(torch.Generator().manual_seed(0))
    for name, p in module.named_parameters():
        if name.endswith("gamma"):  # every block matters
            p.data.fill_(0.5)
    return module


def _port_grads(module, seed=5):
    """Loss, gradients and the generator's next draw of one training
    forward and backward on a fixed batch."""
    images = torch.randn(4, 42, 42, 3,
                         generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(seed)
    loss = _loss(module(images, train=True, generator=gen), torch)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters()
             if p.grad is not None}
    return loss.detach(), grads, torch.rand(4, generator=gen)


def test_the_policies_are_jax_checkpoint_policies():
    """Each name the port takes is a policy of ``jax.checkpoint_policies``
    (not a factory of one)."""
    for name in POLICIES[1:]:
        policy = getattr(jax.checkpoint_policies, name)
        assert isinstance(policy(jax.lax.mul_p), bool), name
    assert set(TV.REMAT_POLICIES) == set(POLICIES)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("drop_path_rate", [0.0, 0.1])
@pytest.mark.parametrize("remat_every", [1, 2])
def test_port_remat_gradients_equal_the_run_without(remat_every,
                                                    drop_path_rate, policy):
    """Bitwise on the CPU: the recompute runs the forward's ops on the
    forward's inputs and drop-path masks."""
    ref = _port_grads(_port_vit(0, None, drop_path_rate))
    got = _port_grads(_port_vit(remat_every, policy, drop_path_rate))
    assert torch.equal(got[0], ref[0])
    assert set(got[1]) == set(ref[1])
    for name, g in ref[1].items():
        assert torch.equal(got[1][name], g), name
    assert torch.equal(got[2], ref[2])  # no later draw moved


def test_a_recompute_that_draws_anew_is_caught(monkeypatch):
    """The check above has teeth: a checkpoint that lets drop path draw
    again from the generator gives other gradients and moves the later
    draws."""
    def redraws(block, x, train, generator, rope, saved_ops):
        return torch.utils.checkpoint.checkpoint(
            lambda h: block(h, train, generator, rope=rope), x,
            use_reentrant=False)

    ref = _port_grads(_port_vit(0, None, 0.1))
    monkeypatch.setattr(TV, "checkpointed_block", redraws)
    got = _port_grads(_port_vit(1, None, 0.1))
    assert not all(torch.equal(got[1][n], g) for n, g in ref[1].items())
    assert not torch.equal(got[2], ref[2])


def test_remat_only_where_gradients_are_taken():
    """Under no_grad (the teacher, embed) no block is checkpointed, and a
    forward in eval mode draws nothing."""
    module = _port_vit(1, None, 0.1)
    images = torch.randn(2, 28, 28, 3)
    with torch.no_grad():
        a = module(images)["cls_token"]
    assert torch.equal(a, _port_vit(0, None, 0.1)(images)["cls_token"]
                       .detach())


@pytest.mark.parametrize("name", ["save_only_these_names",
                                  "save_anything_except_these_names",
                                  "save_any_names_but_these",
                                  "save_from_both_policies",
                                  "offload_dot_with_no_batch_dims",
                                  "dots_savable"])
def test_factory_names_are_refused(name):
    """A factory of ``jax.checkpoint_policies`` is no policy as a string
    (the JAX ViT would fail when it applies it), nor is a misspelt name:
    a ConfigError that lists the six policies."""
    with pytest.raises(ConfigError, match="nothing_saveable") as err:
        get_wrapped_model("dinov2/vittest14", remat_every=2,
                          remat_policy=name)
    for policy in POLICIES[1:]:
        assert policy in str(err.value)


def _dinov2_steps(remat_every, grad_accum_steps):
    """Two DINOv2 train steps (vittest14 at depth 4, drop path 0.1) from one
    generator that is not reseeded between them: the losses of both."""
    cfg = TV.vit_config("vittest", 14, drop_path_rate=0.1,
                        remat_every=remat_every)
    wrapped = WrappedModel("dinov2/vittest14", TV.VisionTransformer(
        dataclasses.replace(cfg, depth=DEPTH)), 32, 14)
    method = DINOv2(wrapped, DINOv2Args(
        output_dim=64, hidden_dim=32, bottleneck_dim=16, local_view_count=2,
        global_image_size=28, local_image_size=14))
    params, method_state = method.init(torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    named = dict(params.named_parameters())
    updater = build_fused_updater(method, method.default_optimizer_args(),
                                  cosine_warmup(1e-3, 10, 1), named, 10)
    state = TrainState(0, params, method_state, updater)
    step = make_train_step(method, 10, grad_accum_steps=grad_accum_steps)
    gen = torch.Generator().manual_seed(3)
    images = torch.randint(0, 256, (4, 36, 36, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    return [step(state, images, gen)["train_loss"] for _ in range(2)]


@pytest.mark.parametrize("grad_accum_steps", [1, 2])
def test_next_steps_losses_equal_the_run_without_remat(grad_accum_steps):
    """With two microbatches the second's draws come after the first's
    backward, and the next step's after this one's: both see the generator
    where the run without remat leaves it."""
    ref = _dinov2_steps(0, grad_accum_steps)
    got = _dinov2_steps(1, grad_accum_steps)
    assert [float(x) for x in got] == [float(x) for x in ref]


# -- the JAX package's remat, and the port against it -----------------------


def _jax_vit(remat_every=0, remat_policy=None, drop_path_rate=0.0):
    cfg = JV.vit_config("vittest", 14, drop_path_rate=drop_path_rate,
                        remat_every=remat_every, remat_policy=remat_policy)
    return JW.WrappedModel("dinov2/vittest14", JV.VisionTransformer(
        dataclasses.replace(cfg, depth=DEPTH)), 32, 14)


def _jax_params(seed=0):
    variables = _jax_vit().init(jax.random.key(seed),
                                jnp.zeros((1, 28, 28, 3)))
    params = jax.device_get(variables["params"])
    for name in list(params):
        if name.startswith("block"):
            for ls in ("ls1", "ls2"):
                params[name][ls]["gamma"] = np.full_like(
                    params[name][ls]["gamma"], 0.5)
    return params


def _jax_grads(wrapped, params, images, drop_key):
    def loss_fn(p):
        return _loss(wrapped.forward_features(
            {"params": p}, images, train=True, rngs={"droppath": drop_key}),
            jnp)

    return jax.jit(jax.value_and_grad(loss_fn))(params)


@pytest.mark.parametrize("remat_every,policy", [
    (1, None), (2, None), (1, "dots_saveable"),
    (2, "dots_with_no_batch_dims_saveable")])
def test_jax_remat_gradients_equal_the_run_without(remat_every, policy):
    """The reference's side of the check, without drop path (with it the
    JAX ViT cannot train under remat: the next test). Its remat program may
    fuse differently, so the gradients are held to fp32 rounding (1e-6
    relative)."""
    params = _jax_params()
    images = jnp.asarray(np.random.default_rng(1).standard_normal(
        (4, 42, 42, 3)).astype(np.float32))
    key = jax.random.key(5)
    loss_ref, ref = _jax_grads(_jax_vit(0, None), params, images, key)
    loss, got = _jax_grads(_jax_vit(remat_every, policy), params, images,
                           key)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-6)
    got = params_from_jax(jax.device_get(got))
    for name, r in params_from_jax(jax.device_get(ref)).items():
        if name.endswith("attn.k.bias"):  # a zero gradient: rounding noise
            continue
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6 * r.abs().max().item(),
                                   err_msg=name)


@pytest.mark.parametrize("remat_every", [1, 2])
def test_jax_remat_with_drop_path_cannot_train(remat_every):
    """A fault of the reference, which the port does not copy: the JAX ViT
    wraps a block as ``nn.remat(Block, static_argnums=(2,))``, and flax
    counts ``self`` as argument 0, so ``rope`` is static and
    ``deterministic`` is traced; a block that drops paths then branches on
    a tracer. Its own example, ``{"drop_path_rate": 0.3, "remat_every":
    2}``, fails at the first training step. The port trains with both
    (the tests above)."""
    params = _jax_params()
    images = jnp.zeros((4, 42, 42, 3))
    with pytest.raises(jax.errors.TracerBoolConversionError):
        _jax_grads(_jax_vit(remat_every, None, 0.1), params, images,
                   jax.random.key(5))


def test_port_remat_gradients_match_jax():
    """Both packages with remat on every block, drop path 0 (the random
    streams differ), on the same weights: fp32 reduction-order noise
    (1e-4 relative, 1e-5 of each leaf's largest gradient)."""
    params = _jax_params()
    images = np.random.default_rng(1).standard_normal(
        (4, 42, 42, 3)).astype(np.float32)
    loss_j, grads_j = _jax_grads(_jax_vit(1, "dots_saveable"), params,
                                 jnp.asarray(images), jax.random.key(5))
    module = _port_vit(1, "dots_saveable")
    module.load_state_dict(params_from_jax(params))
    loss = _loss(module(torch.tensor(images), train=True), torch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    named = dict(module.named_parameters())
    for name, ref in params_from_jax(jax.device_get(grads_j)).items():
        if name.endswith("attn.k.bias"):  # a zero gradient: rounding noise
            continue
        if named[name].grad is None:  # the mask token, unused unmasked
            assert not ref.any(), name
            continue
        np.testing.assert_allclose(named[name].grad.numpy(), ref.numpy(),
                                   rtol=1e-4,
                                   atol=1e-5 * ref.abs().max().item(),
                                   err_msg=name)
