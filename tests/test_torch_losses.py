"""The port's DINOv2 losses against the JAX package's, on the same inputs
(float32 throughout; tolerances are fp32 reduction-order noise)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.ops import losses as JL
from lightly_train_tpu.ops.ema import cosine_schedule as jax_cosine_schedule
from lightly_train_tpu_torch.ops import losses as TL
from lightly_train_tpu_torch.ops.ema import cosine_schedule


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def test_l2_normalize():
    x = _rand(0, 6, 9)
    x[2] = 0.0  # exact zeros stay finite
    _close(TL.l2_normalize(torch.tensor(x)), JL.l2_normalize(jnp.asarray(x)))


def test_softmax_center_teacher():
    logits, center = _rand(1, 7, 32, scale=3.0), _rand(2, 32)
    _close(TL.softmax_center_teacher(torch.tensor(logits),
                                     torch.tensor(center), 0.04),
           JL.softmax_center_teacher(jnp.asarray(logits), jnp.asarray(center),
                                     0.04))


@pytest.mark.parametrize("weighted", [False, True])
def test_update_center(weighted):
    logits, center = _rand(3, 4, 5, 16), _rand(4, 16)
    w = (np.random.default_rng(5).random((4, 5)) < 0.5) if weighted else None
    got = TL.update_center(torch.tensor(center), torch.tensor(logits), 0.9,
                           None if w is None else torch.tensor(w))
    ref = JL.update_center(jnp.asarray(center), jnp.asarray(logits), 0.9,
                           None if w is None else jnp.asarray(w))
    _close(got, ref)


def test_dino_cross_entropy():
    t = np.asarray(JL.softmax_center_teacher(
        jnp.asarray(_rand(6, 8, 64)), jnp.zeros(64), 0.07))
    s = _rand(7, 8, 64, scale=2.0)
    _close(TL.dino_cross_entropy(torch.tensor(t), torch.tensor(s), 0.1),
           JL.dino_cross_entropy(jnp.asarray(t), jnp.asarray(s), 0.1))


def test_ibot_patch_loss():
    t = np.asarray(JL.softmax_center_teacher(
        jnp.asarray(_rand(8, 4, 6, 32)), jnp.zeros(32), 0.05))
    s = _rand(9, 4, 6, 32, scale=2.0)
    mask = np.random.default_rng(10).random((4, 6)) < 0.5
    mask[0] = False  # a crop with nothing masked still counts in the mean
    weight = mask / np.maximum(mask.sum(1, keepdims=True), 1)
    got = TL.ibot_patch_loss(torch.tensor(t), torch.tensor(s),
                             torch.tensor(mask),
                             torch.tensor(weight.astype(np.float32)), 0.1)
    ref = JL.ibot_patch_loss(jnp.asarray(t), jnp.asarray(s), jnp.asarray(mask),
                             jnp.asarray(weight.astype(np.float32)), 0.1)
    _close(got, ref)


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_koleo_loss(groups):
    x = _rand(11, 8, 24)
    _close(TL.koleo_loss(torch.tensor(x), groups=groups),
           JL.koleo_loss(jnp.asarray(x), groups=groups))


@pytest.mark.parametrize("step", [0, 3, 7, 10, 12])
def test_cosine_schedule(step):
    got = cosine_schedule(step, 10, 0.992, 1.0, warmup_steps=2,
                          warmup_start=0.5)
    ref = float(jax_cosine_schedule(step, 10, 0.992, 1.0, warmup_steps=2,
                                    warmup_start=0.5))
    assert got == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n_iterations", [1, 3])
def test_sinkhorn_knopp_teacher(weighted, n_iterations):
    """Logits of prototype-like scale (|t| <= 1, as the weight-normed heads
    give) at the starting temperature 0.04: exp(t / temp) with no maximum
    subtracted, as the JAX package computes it. With ``sample_weights``
    (the iBOT variant) the rows left out are all zero."""
    from lightly_train_tpu_torch.ops.sinkhorn import sinkhorn_knopp_teacher

    logits = np.tanh(_rand(5, 12, 64))
    weights = (np.arange(12) % 3 != 0).astype(np.float32) if weighted else None
    got = sinkhorn_knopp_teacher(
        torch.tensor(logits), 0.04, n_iterations,
        None if weights is None else torch.tensor(weights))
    ref = JL.sinkhorn_knopp_teacher(
        jnp.asarray(logits), 0.04, n_iterations,
        None if weights is None else jnp.asarray(weights))
    _close(got, ref, rtol=1e-5, atol=1e-7)
    rows = got.sum(dim=1).numpy()
    if weighted:
        assert (got.numpy()[weights == 0] == 0).all()
        np.testing.assert_allclose(rows[weights == 1], 1.0, rtol=1e-5)
    else:
        np.testing.assert_allclose(rows, 1.0, rtol=1e-5)
