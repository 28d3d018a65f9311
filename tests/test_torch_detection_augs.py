"""Detection's batch augmentations in the port against the JAX package
(``ops/detection_augs.py``): Mosaic, MixUp, zoom-out, rotate-90 and the
window gate, and ``ObjectDetectionTrainModel.augment_batch`` composing
them.

Each port function is fed the JAX function's own draws, recomputed from
its key with the JAX function's splits; the port's samplers are checked by
bounds. Normalized float32 images agree within 1e-5 (the resampling ones,
Mosaic's antialiased halving and zoom-out's matmul resize, within 1e-5
relative L2); boxes within 1e-6; labels and flags exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops import detection_augs as JA
from lightly_train_tpu.tasks.detection import ltdetr as JL
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops import detection_augs as A
from lightly_train_tpu_torch.tasks.detection import ltdetr as L
from torch_fixtures.threads import one_torch_thread  # noqa: F401

B, S, K = 4, 16, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(seed):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    c = rng.uniform(0.2, 0.8, (B, K, 2))
    wh = rng.uniform(0.05, 0.3, (B, K, 2))
    boxes = np.concatenate([c, wh], -1).astype(np.float32)
    labels = rng.integers(0, 5, (B, K)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) < 0.7
    return images, boxes, labels, valid


def _u(key, shape):
    return _t(jax.random.uniform(key, shape))


def _same(got, want, images_tol=1e-5):
    g_img, *g_rest = got
    w_img, *w_rest = want
    assert _rel(g_img.numpy(), w_img) <= images_tol
    for g, w in zip(g_rest, w_rest):
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("prob", [1.0, 0.5, 0.0])
def test_mosaic_matches_jax(prob):
    images, boxes, labels, valid = _batch(0)
    key = jax.random.key(1)
    want = JA.mosaic(key, jnp.asarray(images), boxes, labels, valid,
                     prob=prob)
    got = A.mosaic(_t(images), _t(boxes), _t(labels), _t(valid),
                   _u(key, (B, 1, 1, 1))[:, 0, 0, 0], prob=prob)
    _same(got, want)
    assert got[1].shape == (B, 4 * K, 4)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_mixup_matches_jax(prob):
    images, boxes, labels, valid = _batch(2)
    key = jax.random.key(3)
    want = JA.detection_mixup(key, jnp.asarray(images), boxes, labels, valid,
                              prob=prob)
    k_apply, k_lam = jax.random.split(key)
    beta = _t(jax.random.beta(k_lam, 0.5, 0.5, (B, 1, 1, 1)))[:, 0, 0, 0]
    got = A.detection_mixup(_t(images), _t(boxes), _t(labels), _t(valid),
                            _u(k_apply, (B, 1, 1, 1))[:, 0, 0, 0], beta,
                            prob=prob)
    _same(got, want)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_zoom_out_matches_jax(prob):
    images, boxes, _, _ = _batch(4)
    key = jax.random.key(5)
    want = JA.random_zoom_out(key, jnp.asarray(images), boxes, prob=prob)
    k_apply, k_s, k_pos = jax.random.split(key, 3)
    got = A.random_zoom_out(_t(images), _t(boxes),
                            _u(k_apply, (B, 1, 1, 1))[:, 0, 0, 0],
                            _u(k_s, (B,)), _u(k_pos, (B, 2)), prob=prob)
    _same(got, want)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_rotate90_matches_jax(prob):
    images, boxes, _, _ = _batch(6)
    key = jax.random.key(7)
    want = JA.random_rotate90(key, jnp.asarray(images), boxes, prob=prob)
    k_apply, k_k = jax.random.split(key)
    got = A.random_rotate90(_t(images), _t(boxes), _u(k_apply, (B,)),
                            _t(jax.random.randint(k_k, (B,), 0, 4)),
                            prob=prob)
    _same(got, want, images_tol=0.0)
    with pytest.raises(ValueError):
        A.random_rotate90(_t(images[:, :8]), _t(boxes), _u(k_apply, (B,)),
                          _t(np.ones(B, np.int32)))


def test_window_gate_matches_jax():
    for step in (0, 4, 5, 9, 10, 11):
        assert A.window_gate(step, 5, 10) == float(JA.window_gate(step, 5,
                                                                  10))


def test_samplers_bounds():
    g = torch.Generator().manual_seed(0)
    beta = A.sample_beta_half(g, 20000, torch.device("cpu"))
    assert float(beta.min()) >= 0.0 and float(beta.max()) <= 1.0
    # Beta(0.5, 0.5): mean 1/2, variance 1/8.
    assert abs(float(beta.mean()) - 0.5) < 0.01
    assert abs(float(beta.var()) - 0.125) < 0.005
    turns = A.sample_quarter_turns(g, 4000, torch.device("cpu"))
    assert set(turns.tolist()) == {0, 1, 2, 3}


WINDOWS = dict(mosaic_window=(0, 10), mixup_window=(0, 10),
               zoom_out_window=(0, 10), rotate90_prob=0.5, mosaic_prob=0.7,
               mixup_prob=0.6, zoom_out_prob=0.8)


def _jax_aug_draws(key):
    """``augment_batch``'s draws of ``key``, by name as the port's
    ``aug_draws`` gives them."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    k_rot_apply, k_rot = jax.random.split(k4)
    k_zoom_apply, k_zoom_s, k_zoom_pos = jax.random.split(k1, 3)
    k_mix_apply, k_mix_lam = jax.random.split(k3)
    col = lambda x: x[:, 0, 0, 0]  # noqa: E731
    return {
        "rot90": (_u(k_rot_apply, (B,)),
                  _t(jax.random.randint(k_rot, (B,), 0, 4))),
        "zoom": (col(_u(k_zoom_apply, (B, 1, 1, 1))), _u(k_zoom_s, (B,)),
                 _u(k_zoom_pos, (B, 2))),
        "mosaic": (col(_u(k2, (B, 1, 1, 1))),),
        "mixup": (col(_u(k_mix_apply, (B, 1, 1, 1))),
                  col(_t(jax.random.beta(k_mix_lam, 0.5, 0.5,
                                         (B, 1, 1, 1))))),
    }


@pytest.mark.parametrize("step", [3, 12])
def test_augment_batch_matches_jax(step, monkeypatch):
    images, boxes, labels, valid = _batch(8)
    args = dict(num_classes=5, **WINDOWS)
    j_model = JL.ObjectDetectionTrainModel(
        jax_get_wrapped_model("dinov2/vittest14", dtype=jnp.float32),
        JL.ObjectDetectionArgs(**args))
    p_model = L.ObjectDetectionTrainModel(get_wrapped_model(
        "dinov2/vittest14"), L.ObjectDetectionArgs(**args))
    batch = {"images": images, "boxes": boxes, "labels": labels,
             "box_valid": valid}
    key = jax.random.key(9)
    want = j_model.augment_batch({k: jnp.asarray(v) for k, v in
                                  batch.items()}, key, jnp.asarray(step))
    monkeypatch.setattr(p_model, "aug_draws",
                        lambda g, n, dev: _jax_aug_draws(key))
    got = p_model.augment_batch({k: _t(v) for k, v in batch.items()}, None,
                                step)
    assert got["boxes"].shape == (B, 8 * K, 4)
    _same([got[k] for k in ("images", "boxes", "labels", "box_valid")],
          [want[k] for k in ("images", "boxes", "labels", "box_valid")])
    # With no window and no rotation the batch passes unchanged.
    plain = L.ObjectDetectionTrainModel(get_wrapped_model(
        "dinov2/vittest14"), L.ObjectDetectionArgs(num_classes=5))
    same = {k: _t(v) for k, v in batch.items()}
    assert plain.augment_batch(same, None, step) is same


def test_aug_draws_shapes_and_bounds():
    model = L.ObjectDetectionTrainModel(get_wrapped_model(
        "dinov2/vittest14"), L.ObjectDetectionArgs(num_classes=5, **WINDOWS))
    d = model.aug_draws(torch.Generator().manual_seed(1), B,
                        torch.device("cpu"))
    want = _jax_aug_draws(jax.random.key(0))
    assert set(d) == set(want)
    for name in d:
        for g, w in zip(d[name], want[name]):
            assert g.shape == w.shape and g.dtype.is_floating_point == \
                w.dtype.is_floating_point, name
            assert float(g.min()) >= 0.0 and float(g.max()) <= 3.0
