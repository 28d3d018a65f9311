"""``ops/point_sampling.py`` in the port against the JAX package's.

Each sampler runs on the same random grids, feature maps, id maps and
coordinates in both packages (coordinates reaching past [0, 1] on every
side, so the zero padding is held too), float32 with the JAX matmuls at
"highest": values within 1e-6. ``uncertainty_point_coords`` is fed the JAX
function's own uniforms (its ``split(rng)`` draws, handed in through the
port's ``uniform`` seam): its uniform fill equal, its importance points
equal as sets (the loss does not depend on their order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.ops import point_sampling as JPS
from lightly_train_tpu_torch.ops import point_sampling as PS
from torch_fixtures.threads import one_torch_thread  # noqa: F401

B, P = 3, 257


def _t(x):
    return torch.from_numpy(np.array(x))


def _coords(seed, shape=(B, P, 2)):
    return np.random.default_rng(seed).uniform(-0.2, 1.2, shape).astype(
        np.float32)


@pytest.mark.parametrize("channels,grid", [(1, (7, 9)), (3, (5, 4))])
def test_bilinear_point_sample_matches_jax(channels, grid):
    g = np.random.default_rng(0).standard_normal(
        (B, channels) + grid).astype(np.float32)
    c = _coords(1)
    want = JPS.bilinear_point_sample(jnp.asarray(g), jnp.asarray(c))
    got = PS.bilinear_point_sample(_t(g), _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_bilinear_point_sample_rows_matches_jax():
    f = np.random.default_rng(2).standard_normal((B, 6, 5, 16)).astype(
        np.float32)
    c = _coords(3)
    want = JPS.bilinear_point_sample_rows(jnp.asarray(f), jnp.asarray(c))
    got = PS.bilinear_point_sample_rows(_t(f), _t(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _id_map(seed, shape=(B, 11, 10), high=6):
    return np.random.default_rng(seed).integers(-1, high, shape).astype(
        np.int32)


@pytest.mark.parametrize("compact", [False, True])
def test_sample_id_indicator_matches_jax(compact):
    ids, c = _id_map(4), _coords(5)
    slot_ids = (np.array([[0, 3, 5], [1, 2, 4], [5, 0, 2]], np.int32)
                if compact else None)
    K = 3 if compact else 5
    want = JPS.sample_id_indicator(
        jnp.asarray(ids), jnp.asarray(c), K,
        slot_ids=None if slot_ids is None else jnp.asarray(slot_ids))
    got = PS.sample_id_indicator(
        _t(ids), _t(c), K, slot_ids=None if slot_ids is None
        else _t(slot_ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_sample_id_indicator_checks_the_slot_count():
    with pytest.raises(ValueError, match="num_slots"):
        PS.sample_id_indicator(_t(_id_map(4)), _t(_coords(5)), 5,
                               slot_ids=torch.zeros((B, 3), dtype=torch.int32))


@pytest.mark.parametrize("per_image", [False, True])
def test_sample_slot_indicator_matches_jax(per_image):
    ids = _id_map(6)
    c = _coords(7, (B, 4, 33, 2))
    slots = (np.array([[0, 1, 2, 3], [4, 5, 0, 1], [2, 2, 3, 5]], np.int32)
             if per_image else np.array([0, 2, 3, 5], np.int32))
    want = JPS.sample_slot_indicator(jnp.asarray(ids), jnp.asarray(c),
                                     jnp.asarray(slots))
    got = PS.sample_slot_indicator(_t(ids), _t(c), _t(slots))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _sorted_rows(x):
    """Each mask's points sorted by (y, x): the set, in a fixed order."""
    x = np.asarray(x)
    order = np.lexsort((x[..., 1], x[..., 0]), axis=-1)
    return np.take_along_axis(x, order[..., None], axis=1)


@pytest.mark.parametrize("importance", [0.75, 0.0, 1.0])
def test_uncertainty_point_coords_match_jax_on_its_draws(importance):
    logits = np.random.default_rng(8).standard_normal((5, 6, 7)).astype(
        np.float32)
    rng = jax.random.key(9)
    n_points, ratio = 40, 3.0
    want = np.asarray(JPS.uncertainty_point_coords(
        rng, jnp.asarray(logits), n_points, ratio, importance))
    k_over, k_rand = jax.random.split(rng)
    n_unc = int(importance * n_points)
    draws = [_t(jax.random.uniform(k_over, (5, int(n_points * ratio), 2)))]
    if n_unc < n_points:
        draws.append(_t(jax.random.uniform(k_rand, (5, n_points - n_unc, 2))))
    with PS.injected(draws):
        got = PS.uncertainty_point_coords(None, _t(logits), n_points, ratio,
                                          importance).numpy()
    assert got.shape == want.shape == (5, n_points, 2)
    np.testing.assert_array_equal(_sorted_rows(got[:, :n_unc]),
                                  _sorted_rows(want[:, :n_unc]))
    np.testing.assert_array_equal(got[:, n_unc:], want[:, n_unc:])


def test_uniform_draws_from_its_generator_or_the_injected_queue():
    g = torch.Generator().manual_seed(0)
    a = PS.uniform(g, (2, 3), torch.device("cpu"))
    b = PS.uniform(torch.Generator().manual_seed(0), (2, 3),
                   torch.device("cpu"))
    assert torch.equal(a, b) and a.dtype == torch.float32
    given = torch.rand(2, 3)
    with PS.injected([given]):
        assert torch.equal(PS.uniform(g, (2, 3), torch.device("cpu")), given)
    with pytest.raises(ValueError, match="shape"):
        with PS.injected([given]):
            PS.uniform(g, (3, 2), torch.device("cpu"))
    with pytest.raises(AssertionError, match="unused"):
        with PS.injected([given]):
            pass
