"""PicoDet in the port against the JAX package
(``tasks/detection/picodet.py``): the modules' forward in eval and train
mode with the BatchNorm statistics, ``integral_decode``, SimOTA, the loss
with its metrics and every leaf's gradient, ``_decode_flat``,
``val_step`` and ``predict``, and the configuration rules.

Both packages run from the same checkpoint-scale weights and BatchNorm
statistics (``models/from_jax.py``; the JAX trees' shapes from
``jax.eval_shape``), fp32 with the JAX matmuls at "highest" and TF32 off,
on the same inputs made with numpy.

PicoDet's train-mode forward is ill-conditioned: some 40 train-mode
BatchNorms with ReLUs between them amplify rounding, so that the JAX
package's own outputs move by 5e-5 to 1.4e-3 relative L2 when only the
order of the batch changes (test preset and ``s``, 64^2 to 128^2, both
variance forms). Hence:

- eval mode (the running statistics): outputs within 1e-5 relative L2;
  the loss and its metrics within 1e-5 relative, every leaf's gradient
  within 1e-4 relative L2 (``test_loss_and_gradients_match_jax``, the
  BatchNorms on their running statistics in both packages);
- train mode: outputs, the loss, its metrics and every leaf's gradient
  within twice the JAX package's own largest distance from itself over
  three batch orders (at least 1e-5); the running statistics after the
  step within 1e-5 relative L2, and their change (momentum 0.99, Flax's
  default) within 1e-3;
- SimOTA's assignment, the decoded top-k indices and labels: equal
  (``_decode_flat`` ranks equal scores by index, as ``jax.lax.top_k``;
  on the card too, by a stable sort, where ``torch.topk``'s order among
  equal values is unspecified).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.tasks.detection import picodet as JP
from lightly_train_tpu_torch.models.from_jax import task_state_from_jax
from lightly_train_tpu_torch.tasks.detection import picodet as P
from test_torch_ltdetr import _rel, _scale, _stats, _t
from torch_fixtures.threads import one_torch_thread  # noqa: F401

NC, K = 4, 6
PERMS = [np.array(p) for p in ([1, 3, 0, 2], [3, 2, 1, 0], [2, 0, 3, 1])]


@pytest.fixture(autouse=True)
def exact():
    torch.backends.cuda.matmul.allow_tf32 = False


def models(size="test", hw=72, seed=1, **extra):
    args = dict(num_classes=NC, model_size=size, **extra)
    j_model = JP.PicoDetTrainModel(None, JP.PicoDetArgs(**args))
    p_model = P.PicoDetTrainModel(None, P.PicoDetArgs(**args))
    params, state = jax.eval_shape(lambda: j_model.init(
        jax.random.key(0), {"images": jnp.zeros((2, hw, hw, 3))}))
    params = _scale(params, seed)
    state = {k: _stats(v, seed + 1) for k, v in state.items()}
    module = p_model.init(torch.Generator().manual_seed(0),
                          torch.device("cpu"))
    module.load_state_dict(task_state_from_jax(params, state))
    return j_model, p_model, params, state, module


def det_batch(hw, seed, batch=4, k=K):
    """Images and padded targets: 2 to k boxes an image."""
    rng = np.random.default_rng(seed)
    wh = rng.uniform(0.08, 0.6, (batch, k, 2))
    c = rng.uniform(wh / 2, 1 - wh / 2)
    valid = np.zeros((batch, k), bool)
    for b in range(batch):
        valid[b, :rng.integers(2, k + 1)] = True
    return {"images": rng.standard_normal((batch, hw, hw, 3)).astype(
                np.float32),
            "boxes": np.concatenate([c, wh], -1).astype(np.float32),
            "labels": rng.integers(0, NC, (batch, k)).astype(np.int32),
            "box_valid": valid}


def _flat(outs):
    return [np.asarray(x, np.float64) for x in list(outs[0]) + list(outs[1])]


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,hw", [("test", 72), ("test", 64), ("s", 64)])
def test_forward_and_statistics_match_jax(size, hw):
    """Every level's class and box logits, eval and train mode; at 72^2
    the levels are 9, 5, 3 and 2, so CSP-PAN's nearest upsampling is not
    a doubling; the running statistics after the train-mode forward."""
    j_model, p_model, params, state, module = models(size, hw)
    x = det_batch(hw, 0)["images"]
    variables = {"params": params["backbone"], **state}
    want = jax.jit(lambda x: j_model.module.apply(variables, x))(x)
    with torch.no_grad():
        got = p_model._forward(module, _t(x), False)
    assert [tuple(c.shape) for c in got[0]] == [
        tuple(c.shape) for c in want[0]]
    for g, w in zip(_flat([[t.numpy() for t in got[0]],
                           [t.numpy() for t in got[1]]]), _flat(want)):
        assert _rel(g, w) < 1e-5
    if size == "test" and hw == 72:
        assert [c.shape[1] for c in got[0]] == [9, 5, 3, 2]

    train = jax.jit(lambda x: j_model.module.apply(
        variables, x, train=True, mutable=["batch_stats"]))
    want, new_state = train(x)
    again = [_flat(train(x[p])[0]) for p in PERMS]
    with torch.no_grad():
        got = p_model._forward(module, _t(x), True)
    got = _flat([[t.numpy() for t in got[0]], [t.numpy() for t in got[1]]])
    for i, (g, w) in enumerate(zip(got, _flat(want))):
        spread = max(_rel(a[i][np.argsort(p)], w)
                     for a, p in zip(again, PERMS))
        assert _rel(g, w) <= max(1e-5, 2 * spread), i
    old = task_state_from_jax({}, state)
    for key, value in task_state_from_jax({}, new_state).items():
        now = module.state_dict()[key]
        assert _rel(now, value) < 1e-5, key
        assert _rel(now - old[key], value - old[key]) < 1e-3, key


def test_integral_decode_matches_jax():
    rng = np.random.default_rng(2)
    reg = (3 * rng.standard_normal((2, 7, 32))).astype(np.float32)
    got = P.integral_decode(_t(reg), 7)
    want = JP.integral_decode(jnp.asarray(reg), 7)
    assert got.shape == (2, 7, 4)
    assert _rel(got, want) < 1e-6
    assert P.esnet_stage_channels("s") == JP.esnet_stage_channels("s") == (
        24, 96, 192, 384)
    assert P.esnet_stage_channels("l") == JP.esnet_stage_channels("l")
    for v in (7.9, 8.0, 12.0, 100.0, 0.5):
        assert P._make_divisible(v, 8) == JP._make_divisible(v, 8)


# ---------------------------------------------------------------------------
# SimOTA
# ---------------------------------------------------------------------------


def _priors(hw):
    pts, sts = [], []
    for s in JP._STRIDES:
        n = -(-hw // s)
        ys = (np.arange(n) + 0.5) * s
        gy, gx = np.meshgrid(ys, ys, indexing="ij")
        pts.append(np.stack([gx, gy], -1).reshape(-1, 2))
        sts.append(np.full(n * n, s))
    return (np.concatenate(pts).astype(np.float32),
            np.concatenate(sts).astype(np.float32))


def simota_case(seed, hw=64, batch=3, k=7):
    """Priors of a 64^2 image; per image random scores and boxes near the
    priors, with the boxes and scores of prior 1 copied onto prior 2
    (equal costs), ground truths with invalid slots, one far off the
    image (no prior a candidate), one tiny, and slot 4 a copy of slot 3
    (equal cost columns: argmin ties)."""
    rng = np.random.default_rng(seed)
    pts, sts = _priors(hw)
    N = len(pts)
    scores = rng.uniform(0.01, 0.99, (batch, N, NC)).astype(np.float32)
    half = rng.uniform(2, 24, (batch, N, 2))
    jitter = rng.uniform(-4, 4, (batch, N, 2))
    decoded = np.concatenate([pts + jitter - half, pts + jitter + half],
                             -1).astype(np.float32)
    scores[:, 2], decoded[:, 2] = scores[:, 1], decoded[:, 1]
    c = rng.uniform(8, hw - 8, (batch, k, 2))
    wh = rng.uniform(8, 40, (batch, k, 2))
    gt = np.concatenate([c - wh / 2, c + wh / 2], -1)
    gt[:, 5] = [500, 500, 520, 520]
    gt[:, 6, 2:] = gt[:, 6, :2] + 1.0
    gt[:, 4] = gt[:, 3]
    labels = rng.integers(0, NC, (batch, k))
    labels[:, 4] = labels[:, 3]
    valid = np.ones((batch, k), bool)
    valid[0, 1] = False
    valid[2, :2] = False
    return (scores, pts, sts, decoded, gt.astype(np.float32),
            labels.astype(np.int32), valid)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_simota_matches_jax(seed):
    scores, pts, sts, decoded, gt, labels, valid = simota_case(seed)
    want = jax.vmap(lambda s, d, g, lab, v: JP.simota_assign(
        s, pts, sts, d, g, lab, v, 2.5, 10, 6.0, 1.0))(
        scores, decoded, gt, labels, valid)
    got = P.simota_assign(_t(scores), _t(pts), _t(sts), _t(decoded), _t(gt),
                          _t(labels), _t(valid), 2.5, 10, 6.0, 1.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6, atol=1e-7)
    is_pos, assigned = got[0].numpy(), got[1].numpy()
    assert is_pos.any()
    # Equal costs: the copied prior is matched where the original is.
    np.testing.assert_array_equal(is_pos[:, 2], is_pos[:, 1])
    # No prior takes the far ground truth or an invalid one, and none the
    # copy of slot 3 (its equal column loses the argmin tie).
    assert not (is_pos & (assigned == 5)).any()
    assert not (is_pos & (assigned == 4)).any()
    assert not (is_pos[0] & (assigned[0] == 1)).any()
    assert not (is_pos[2] & (assigned[2] < 2)).any()


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def _eval_bn(monkeypatch, j_model, p_model):
    """Both packages' loss with the BatchNorms on their running
    statistics."""
    j_fwd, p_fwd = j_model._forward, p_model._forward
    monkeypatch.setattr(j_model, "_forward", lambda p, s, x, train, rng=None:
                        j_fwd(p, s, x, False, rng))
    monkeypatch.setattr(p_model, "_forward", lambda m, x, train:
                        p_fwd(m, x, False))


def _eager_simota(monkeypatch):
    """Within the jitted JAX loss, SimOTA runs eagerly on the host (a
    ``pure_callback``; its inputs carry no gradient). Under ``jax.jit``
    XLA computes SimOTA's cost twice, in two fusions that round
    differently, so a prior whose cost is its ground truth's threshold
    can land an ulp above the threshold's copy and drop out of the
    assignment (image 2, prior 29 of the eval-mode loss test's batch);
    eagerly, as in the port, the cost is compared with its own value."""
    original = JP.simota_assign

    def simota(scores, points, strides, decoded, gt_boxes, gt_labels,
               gt_valid, *consts):
        def host(*arrays):
            with jax.disable_jit():
                out = original(*map(jnp.asarray, arrays), *consts)
            return tuple(np.asarray(o) for o in out)

        n = scores.shape[0]
        shapes = (jax.ShapeDtypeStruct((n,), jnp.bool_),
                  jax.ShapeDtypeStruct((n,), jnp.int32),
                  jax.ShapeDtypeStruct((n,), jnp.float32))
        return jax.pure_callback(host, shapes, scores, points, strides,
                                 decoded, gt_boxes, gt_labels, gt_valid,
                                 vmap_method="sequential")

    monkeypatch.setattr(JP, "simota_assign", simota)


def _grads(j_model, params, state, batch):
    def f(p, b):
        return j_model.loss_fn(p, state, b, jax.random.key(0), 0)
    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _close_leaves(module, ref, tol):
    named = dict(module.named_parameters())
    assert set(ref) == set(named)
    for key, g in ref.items():
        assert _rel(named[key].grad, g) <= tol(key), key


def test_loss_and_gradients_match_jax(monkeypatch):
    """The loss (VFL, GIoU, DFL on SimOTA), its metrics and every leaf's
    gradient, the BatchNorms on their running statistics in both
    packages (well-conditioned)."""
    j_model, p_model, params, state, module = models("test", 72)
    _eval_bn(monkeypatch, j_model, p_model)
    _eager_simota(monkeypatch)
    batch = det_batch(72, 3)
    (want, (_, metrics)), grads = _grads(j_model, params, state, batch)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, p_metrics = p_model.loss_fn(module, {k: _t(v) for k, v in
                                              batch.items()}, None, 0)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert set(p_metrics) == set(metrics) == {"loss_vfl", "loss_giou",
                                              "loss_dfl", "num_pos"}
    assert float(metrics["num_pos"]) > 0
    for key, value in metrics.items():
        assert abs(float(p_metrics[key]) - float(value)) <= 1e-5 * abs(
            float(value)), key
    got.backward()
    _close_leaves(module, task_state_from_jax(grads), lambda key: 1e-4)


def test_train_mode_loss_gradients_and_statistics_match_jax(monkeypatch):
    """One train-mode step: the loss, its metrics and every leaf's
    gradient within twice the JAX package's own distance from itself
    over three batch orders; the running statistics and their change."""
    j_model, p_model, params, state, module = models("test", 72)
    _eager_simota(monkeypatch)
    batch = det_batch(72, 4)
    fn = _grads(j_model, params, state, batch)
    (want, (new_state, metrics)), grads = fn(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = task_state_from_jax(grads)
    spread = {"loss": 0.0, **{k: 0.0 for k in metrics}, **{
        k: 0.0 for k in ref}}
    for p in PERMS:
        (loss_p, (_, metrics_p)), grads_p = fn(params, {
            k: jnp.asarray(v[p]) for k, v in batch.items()})
        spread["loss"] = max(spread["loss"], _rel(loss_p, want))
        for key, value in metrics_p.items():
            spread[key] = max(spread[key], _rel(value, metrics[key]))
        for key, g in task_state_from_jax(grads_p).items():
            spread[key] = max(spread[key], _rel(g, ref[key]))
    got, p_metrics = p_model.loss_fn(module, {k: _t(v) for k, v in
                                              batch.items()}, None, 0)
    assert _rel(got, want) <= max(1e-5, 2 * spread["loss"])
    for key, value in metrics.items():
        assert _rel(p_metrics[key], value) <= max(1e-5, 2 * spread[key]), key
    got.backward()
    _close_leaves(module, ref, lambda key: max(1e-5, 2 * spread[key]))
    old = task_state_from_jax({}, state)
    for key, value in task_state_from_jax({}, new_state).items():
        now = module.state_dict()[key]
        assert _rel(now, value) < 1e-5, key
        assert _rel(now - old[key], value - old[key]) < 1e-3, key


# ---------------------------------------------------------------------------
# decoding, validation and inference
# ---------------------------------------------------------------------------


def test_decode_flat_ranks_ties_as_jax():
    """Scores with many exact ties (logits on a coarse grid): the same
    indices, labels, scores and boxes as ``jax.lax.top_k``'s."""
    j_model, p_model, *_ = models("test", 64, max_detections=20)
    rng = np.random.default_rng(5)
    cls = rng.integers(-2, 3, (2, 30, NC)).astype(np.float32)
    boxes = rng.uniform(0, 64, (2, 30, 4)).astype(np.float32)
    want = j_model._decode_flat(jnp.asarray(cls), jnp.asarray(boxes),
                                (64, 48))
    got = p_model._decode_flat(_t(cls), _t(boxes), (64, 48))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_validation_and_predict_match_jax():
    j_model, p_model, params, state, module = models("test", 64)
    batch = det_batch(64, 6)
    batch["valid"] = np.array([True, True, False, True])
    want = jax.jit(lambda p, b: j_model.val_step(p, state, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = p_model.val_step(module, {k: _t(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for key in ("pred_labels", "tgt_labels", "tgt_valid", "sample_valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("pred_boxes", "pred_scores", "tgt_boxes"):
        assert _rel(got[key], want[key]) < 1e-5, key
    collected = [jax.device_get(want)] * 2
    assert p_model.val_finalize(collected) == j_model.val_finalize(collected)
    w = jax.jit(j_model.predict)({"params": params, **state},
                                 jnp.asarray(batch["images"]))
    with torch.no_grad():
        g = p_model.predict(module, _t(batch["images"]))
    np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
    assert _rel(g[0], w[0]) < 1e-5 and _rel(g[1], w[1]) < 1e-5


def test_defaults_match_jax():
    """The optimizer, the EMA, the schedule's warmup, the clipping and the
    watched metric, as in the JAX package; no batch augmentation."""
    j_model, p_model, *_ = models("test", 64)
    opt, j_opt = p_model.default_optimizer_args(), \
        j_model.default_optimizer_args()
    assert (opt.type, opt.lr, opt.momentum, opt.weight_decay) == (
        "sgd", 0.1, 0.9, 4e-5) == (j_opt.type, j_opt.lr, j_opt.momentum,
                                   j_opt.weight_decay)
    assert p_model.use_ema() and j_model.use_ema()
    assert p_model.grad_clip_norm() == j_model.grad_clip_norm() == 0.1
    assert p_model.watch_metric == j_model.watch_metric == ("val_map", "max")
    sched, j_sched = p_model.lr_schedule(0.1, 100), j_model.lr_schedule(
        0.1, 100)
    assert [sched(s) for s in (0, 1, 2, 50, 99)] == [
        float(j_sched(s)) for s in (0, 1, 2, 50, 99)]
    batch = {k: _t(v) for k, v in det_batch(64, 0).items()}
    assert p_model.augment_batch(batch, None, 0) is batch
