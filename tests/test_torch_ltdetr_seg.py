"""LT-DETR instance segmentation in the port against the JAX package
(``tasks/detection/ltdetr_seg.py``): the EdgeCrafter mask head, both
heads' mask logits, the loss with its metrics and every leaf's gradient,
``val_step`` with ``val_finalize``, ``predict``, and the refusals.

Both packages run from the same checkpoint-scale weights
(``models/from_jax.py``; the JAX trees' shapes from ``jax.eval_shape``),
fp32 with the JAX matmuls at "highest" and TF32 off, on the same inputs
made with numpy. The point draws of the JAX loss (``k_pts``'s two
uniform draws) are recomputed from its key and handed to the port
(``ops/point_sampling.py::injected``). The JAX matching runs the exact
Hungarian on the host (``LIGHTLY_TRAIN_MATCHER=hungarian``).

Tolerances: the mask head's logits and input gradients 1e-5 relative L2
(its parameter gradients 1e-5), the whole model's mask logits 1e-4 (as
the detection outputs in ``test_torch_ltdetr.py``); the loss 1e-5
relative and its metrics 1e-5 (1e-4 on ECViT-test, which runs with the
two-pass BatchNorm variance in both packages: ``test_torch_ltdetr.py``
says why); every leaf's gradient 1e-4 relative L2, where its exact value
is not 0 (below 1e-6 of the largest gradient: a bias right before a
train-mode BatchNorm, an attention key bias); boolean masks, labels and
the validation metrics equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.tasks.detection import ltdetr_seg as JS
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.from_jax import (
    params_from_jax,
    task_state_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops import point_sampling as PS
from lightly_train_tpu_torch.tasks.detection import ltdetr_seg as S
from test_torch_ltdetr import _rel, _scale, _stats, _t, _two_pass_variance
from torch_fixtures.threads import one_torch_thread  # noqa: F401

B, NC, K = 2, 4, 5
SMALL = dict(num_classes=NC, num_queries=8, d_model=32, num_heads=2,
             dim_feedforward=48, num_decoder_layers=2, csp_blocks=1,
             num_points=(2, 2, 2), dfine_bins=17, max_instances=K)
BACKBONES = {"dinov2/vittest14": 56, "ecvit/ecvittest": 96}


@pytest.fixture(autouse=True)
def exact(monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("LIGHTLY_TRAIN_MATCHER", "hungarian")


def seg_batch(size, seed, k=K, batch=B, classes=NC):
    """Images and slot-map targets: random rectangles painted in slot
    order (a later one over an earlier), a slot left with no pixel not
    valid, its box the painted pixels' extent (normalized cxcywh); the
    last slot of image 0 never painted."""
    rng = np.random.default_rng(seed)
    seg_map = np.full((batch, size, size), 255, np.int32)
    for b in range(batch):
        for slot in range(k - (b == 0)):
            y0, x0 = rng.integers(0, size - 6, 2)
            h, w = rng.integers(6, size // 2, 2)
            seg_map[b, y0:y0 + h, x0:x0 + w] = slot
    boxes = np.zeros((batch, k, 4), np.float32)
    valid = np.zeros((batch, k), bool)
    for b in range(batch):
        for slot in range(k):
            ys, xs = np.nonzero(seg_map[b] == slot)
            if len(ys) == 0:
                continue
            valid[b, slot] = True
            x0, x1 = xs.min() / size, (xs.max() + 1) / size
            y0, y1 = ys.min() / size, (ys.max() + 1) / size
            boxes[b, slot] = [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0]
    return {"images": rng.standard_normal((batch, size, size, 3)).astype(
                np.float32),
            "seg_map": seg_map,
            "seg_labels": rng.integers(0, classes, (batch, k)).astype(
                np.int32),
            "seg_valid": valid, "boxes": boxes}


def models(name, **extra):
    args = {**SMALL, **extra}
    j_model = JS.LTDETRInstanceSegmentationTrainModel(
        jax_get_wrapped_model(name, dtype=jnp.float32),
        JS.InstanceSegmentationLTDETRArgs(**args))
    p_model = S.LTDETRInstanceSegmentationTrainModel(
        get_wrapped_model(name), S.InstanceSegmentationLTDETRArgs(**args))
    size = BACKBONES[name]
    params, model_state = jax.eval_shape(lambda: j_model.init(
        jax.random.key(0), {"images": jnp.zeros((B, size, size, 3))}))
    params = _scale(params, 1)
    model_state = {k: _stats(v, 2) for k, v in model_state.items()}
    module = p_model.init(torch.Generator().manual_seed(0),
                          torch.device("cpu"))
    module.load_state_dict(task_state_from_jax(params, model_state))
    return j_model, p_model, params, model_state, module, size


def point_draws(key, n_masks, size, ratio=16):
    """The uniforms of the JAX loss's point sampling of ``key`` (its
    ``k_pts``): every mask's candidates, then its uniform points."""
    gh = size // 4
    P = max(gh, gh * gh // ratio)
    n_over, n_rand = int(P * 3.0), P - int(0.75 * P)
    k_over, k_rand = jax.random.split(key)
    return [_t(jax.random.uniform(k_over, (n_masks, n_over, 2))),
            _t(jax.random.uniform(k_rand, (n_masks, n_rand, 2)))]


# ---------------------------------------------------------------------------
# the mask heads
# ---------------------------------------------------------------------------


def test_ec_mask_head_and_its_gradients_match_jax():
    """Every layer's logits of the EdgeCrafter head, its inputs' and its
    parameters' gradients; an odd /8 grid (7 x 5 to 28 x 20)."""
    rng = np.random.default_rng(0)
    D, Q, layers = 16, 6, 3
    spatial = rng.standard_normal((B, 7, 5, D)).astype(np.float32)
    queries = [rng.standard_normal((B, Q, D)).astype(np.float32)
               for _ in range(layers)]
    jm = JS.ECSegMaskHead(dim=D, num_blocks=layers)
    params = _scale(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), spatial, queries, (56, 40)))["params"], 3)
    pm = S.ECSegMaskHead(D, layers)
    pm.load_state_dict(params_from_jax(params))
    cots = [rng.standard_normal((B, Q, 14, 10)).astype(np.float32)
            for _ in range(layers)]

    def j_fn(p, s, qs):
        out = jm.apply({"params": p}, s, qs, (56, 40))
        return sum(jnp.sum(o * c) for o, c in zip(out, cots)), out

    (_, want), grads = jax.value_and_grad(j_fn, argnums=(0, 1, 2),
                                          has_aux=True)(
        params, jnp.asarray(spatial), [jnp.asarray(q) for q in queries])
    s = _t(spatial).requires_grad_()
    qs = [_t(q).requires_grad_() for q in queries]
    got = pm(s, qs, (56, 40))
    assert len(got) == layers
    for g, w in zip(got, want):
        assert g.shape == (B, Q, 14, 10)
        assert _rel(g, w) < 1e-5
    sum((g * _t(c)).sum() for g, c in zip(got, cots)).backward()
    assert _rel(s.grad, grads[1]) < 1e-5
    for q, w in zip(qs, grads[2]):
        assert _rel(q.grad, w) < 1e-5
    ref = params_from_jax(grads[0])
    for name, p in pm.named_parameters():
        assert _rel(p.grad, ref[name]) < 1e-5, name
    # The last level alone is the last of all levels.
    last = pm(s, qs, (56, 40), all_levels=False)
    assert len(last) == 1 and torch.equal(last[0], got[-1])


@pytest.mark.parametrize("arch", ["edgecrafter", "linear"])
def test_mask_logits_match_jax(arch):
    """The whole model's final mask logits (eval mode): the EdgeCrafter
    head's at image/4 from the encoder's P3 and the last layer's queries,
    the linear head's at the patch grid from the trunk's features."""
    j_model, p_model, params, state, module, size = models(
        "dinov2/vittest14", mask_head_arch=arch)
    images = seg_batch(size, 0)["images"]

    def j_fn(p, x):
        outputs, queries, feats, _ = j_model._apply_with_masks(p, state, x,
                                                               False)
        return j_model._mask_logits(p, feats, queries, x.shape[1:3])[0]

    want = jax.jit(j_fn)(params, jnp.asarray(images))
    x = _t(images)
    with torch.no_grad():
        _, queries, feats = p_model._apply(module, x, False)
        got, grid = p_model._mask_logits(module, feats, queries, (size, size))
    gh = size // 4 if arch == "edgecrafter" else size // 14
    assert grid == (gh, gh) and got.shape == want.shape == (B, 8, gh * gh)
    assert _rel(got, want) < 1e-4


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def _jax_loss(j_model, params, state, batch, rng):
    def f(p):
        return j_model.loss_fn(p, state, batch, rng, 0)
    return jax.jit(jax.value_and_grad(f, has_aux=True))(params)


@pytest.mark.parametrize("case", ["vit-edgecrafter", "vit-linear",
                                  "ecvit-edgecrafter"])
def test_loss_and_gradients_match_jax(case, monkeypatch):
    """The loss (detection criterion and mask loss), its metrics and
    every leaf's gradient of one step, the mask head's included, with the
    JAX point draws handed over; the BatchNorm statistics the step
    moved."""
    name = "dinov2/vittest14" if case.startswith("vit") else "ecvit/ecvittest"
    arch = case.split("-")[1]
    if name == "ecvit/ecvittest":
        _two_pass_variance(monkeypatch)
    j_model, p_model, params, state, module, size = models(
        name, mask_head_arch=arch)
    batch = seg_batch(size, 7)
    rng = jax.random.key(11)
    (want, (new_state, metrics)), grads = _jax_loss(
        j_model, params, state, {k: jnp.asarray(v) for k, v in batch.items()},
        rng)
    k_pts, _ = jax.random.split(rng)
    draws = point_draws(k_pts, B * K, size) if arch == "edgecrafter" else []
    with PS.injected(draws):
        got, p_metrics = p_model.loss_fn(module, {k: _t(v) for k, v in
                                                  batch.items()}, None, 0)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert set(p_metrics) == set(metrics) and "mask_loss" in metrics
    tol = 1e-5 if name == "dinov2/vittest14" else 1e-4
    for key, value in metrics.items():
        assert abs(float(p_metrics[key]) - float(value)) <= tol * max(
            abs(float(value)), 1e-3), key
    got.backward()
    ref = task_state_from_jax(grads)
    named = dict(module.named_parameters())
    assert set(ref) == set(named)
    assert any(k.startswith("mask_head.") for k in ref)
    scale = max(float(g.abs().max()) for g in ref.values())
    for key, g in ref.items():
        p_grad = named[key].grad
        if float(g.abs().max()) < 1e-6 * scale:
            assert p_grad is None or float(p_grad.abs().max()) < 1e-6 * scale
            continue
        assert _rel(p_grad, g) < 1e-4, key
    moved = task_state_from_jax({}, new_state)
    for key, value in moved.items():
        assert _rel(module.state_dict()[key], value) < 1e-5, key


def test_legacy_targets_hold_no_exact_half():
    """The linear head's targets resize each slot's 0/1 map by JAX's
    antialiased "linear" rule and keep the cells above one half; the
    port sums in float64 and counts a sum within 1e-9 of a half as off.
    The loss test's maps hold no cell that close to a half, so both
    packages see the same targets there."""
    from lightly_train_tpu_torch.tasks.eomt_semantic_segmentation import (
        _linear_weights,
    )

    batch = seg_batch(56, 7)
    onehot = (batch["seg_map"][..., None] == np.arange(K)).astype(np.float64)
    w = _linear_weights(56, 4, torch.device("cpu")).numpy()
    t = np.einsum("bhwk,hi,wj->bijk", onehot, w, w)
    assert np.abs(t - 0.5).min() > 1e-3


# ---------------------------------------------------------------------------
# validation and inference
# ---------------------------------------------------------------------------


def _planted(collected, seed):
    """The statistics with some queries' masks set to target slots' (at
    the mask grid) and given high scores, so mAP is above 0."""
    rng = np.random.default_rng(seed)
    out = []
    for c in collected:
        c = {k: np.array(v) for k, v in c.items()}
        for b in range(c["pred_masks"].shape[0]):
            tmap = c["tgt_map"][b].reshape(-1)
            for q, slot in enumerate(np.nonzero(c["tgt_valid"][b])[0][:3]):
                c["pred_masks"][b, q] = tmap == slot
                c["pred_labels"][b, q] = c["tgt_labels"][b, slot]
                c["pred_scores"][b, q] = 0.6 + 0.3 * rng.uniform()
        out.append(c)
    return out


@pytest.mark.parametrize("arch", ["edgecrafter", "linear"])
def test_validation_and_predict_match_jax(arch):
    """``val_step``'s statistics, ``val_finalize``'s mask mAP on them and
    on planted ones (above 0), and ``predict``'s boxes, scores, labels and
    masks."""
    j_model, p_model, params, state, module, size = models(
        "ecvit/ecvittest", mask_head_arch=arch)
    batch = seg_batch(size, 3)
    batch["valid"] = np.array([True, False])
    want = jax.jit(lambda p, b: j_model.val_step(p, state, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = p_model.val_step(module, {k: _t(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for key in ("pred_masks", "pred_labels", "tgt_map", "tgt_labels",
                "tgt_valid", "sample_valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert _rel(got["pred_scores"], want["pred_scores"]) < 1e-5
    collected = [jax.device_get(want)] * 2
    assert p_model.val_finalize(collected) == j_model.val_finalize(collected)
    planted = _planted(collected, 1)
    result = p_model.val_finalize(planted)
    assert result == j_model.val_finalize(planted)
    assert result["val_mask_map"] > 0
    assert p_model.watch_metric == j_model.watch_metric == (
        "val_mask_map", "max")

    variables = {"params": params, **state}
    w_boxes, w_scores, w_labels, w_masks = jax.jit(j_model.predict)(
        variables, jnp.asarray(batch["images"]))
    with torch.no_grad():
        g_boxes, g_scores, g_labels, g_masks = p_model.predict(
            module, _t(batch["images"]))
    np.testing.assert_array_equal(g_labels.numpy(), np.asarray(w_labels))
    np.testing.assert_array_equal(g_masks.numpy(), np.asarray(w_masks))
    assert _rel(g_scores, w_scores) < 1e-5
    assert _rel(g_boxes, w_boxes) < 1e-4


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def test_edgecrafter_head_refuses_unequal_widths():
    """The EdgeCrafter head needs the encoder's width to be the
    decoder's: a ValueError in both packages, before anything is
    built."""
    args = {**SMALL, "enc_d_model": 24}
    with pytest.raises(ValueError, match="encoder and decoder widths"):
        JS.LTDETRInstanceSegmentationTrainModel(
            jax_get_wrapped_model("dinov2/vittest14", dtype=jnp.float32),
            JS.InstanceSegmentationLTDETRArgs(**args))
    with pytest.raises(ValueError, match="encoder and decoder widths"):
        S.LTDETRInstanceSegmentationTrainModel(
            get_wrapped_model("dinov2/vittest14"),
            S.InstanceSegmentationLTDETRArgs(**args))
    # The linear head has no such constraint.
    S.LTDETRInstanceSegmentationTrainModel(
        get_wrapped_model("dinov2/vittest14"),
        S.InstanceSegmentationLTDETRArgs(**args, mask_head_arch="linear"))


@pytest.mark.parametrize("window", [
    {"mosaic_window": (0, 10)}, {"mixup_window": (0, 10)},
    {"zoom_out_window": (0, 10)}, {"rotate90_prob": 0.5}])
def test_augmentation_windows_are_refused(window):
    """The detection batch augmentations read ``labels`` and
    ``box_valid``, which the instance datasets' batches do not carry: the
    JAX package's ``augment_batch`` fails on such a batch with a
    KeyError, the port refuses the configuration when the model is
    made."""
    j_model = JS.LTDETRInstanceSegmentationTrainModel(
        jax_get_wrapped_model("dinov2/vittest14", dtype=jnp.float32),
        JS.InstanceSegmentationLTDETRArgs(**SMALL, **window))
    batch = {k: jnp.asarray(v) for k, v in seg_batch(56, 0).items()}
    with pytest.raises(KeyError, match="labels"):
        j_model.augment_batch(batch, jax.random.key(0), 0)
    with pytest.raises(ConfigError, match="not supported for LT-DETR "
                       "instance segmentation"):
        S.LTDETRInstanceSegmentationTrainModel(
            get_wrapped_model("dinov2/vittest14"),
            S.InstanceSegmentationLTDETRArgs(**SMALL, **window))
