"""LT-DETR's modules in the port against the JAX package
(``tasks/detection/``): the box and D-FINE utilities, the encoder's and
the decoder's modules, the ViT adapter, the criterion, the train model's
denoising queries, loss and decode, the detection schedule and the EMA
momentum.

Both packages run from the same weights (``models/from_jax.py``; the JAX
trees' shapes from ``jax.eval_shape``), at checkpoint scale (kernels at
1/sqrt(fan-in); the fused in-projections too), fp32 with the JAX matmuls
at "highest" and TF32 off, on the same inputs made with numpy. Every
random draw of the JAX code (the denoising queries' uniforms and labels)
is recomputed from its key and handed to the port. The JAX criterion runs with the exact Hungarian on the host
(``LIGHTLY_TRAIN_MATCHER=hungarian``).

Tolerances: forward values 1e-5 relative L2 (the whole model's boxes and
logits after its top-k selection 1e-4), gradients 1e-4 relative L2 (the
whole model's on the ViT and on ECViT, both decoders, with and without
denoising), integer results (assignments, GO
pairs, top-k indices, masks) equal; the bf16 attention within 2e-2
relative L2 of the JAX bf16 attention.
"""

import flax.linen.normalization as FN
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu._optim import schedules as JS
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops import ema as JEMA
from lightly_train_tpu.tasks.detection import backbone_adapter as JBA
from lightly_train_tpu.tasks.detection import box_utils as JB
from lightly_train_tpu.tasks.detection import components as JC
from lightly_train_tpu.tasks.detection import criterion as JCR
from lightly_train_tpu.tasks.detection import dfine_utils as JD
from lightly_train_tpu.tasks.detection import ltdetr as JL
from lightly_train_tpu_torch._optim.schedules import flat_cosine
from lightly_train_tpu_torch.models import conv as PC
from lightly_train_tpu_torch.models.from_jax import (
    task_state_from_jax,
    variables_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops.ema import ema_warmup_momentum
from lightly_train_tpu_torch.tasks.detection import backbone_adapter as BA
from lightly_train_tpu_torch.tasks.detection import box_utils as PB
from lightly_train_tpu_torch.tasks.detection import components as C
from lightly_train_tpu_torch.tasks.detection import criterion as CR
from lightly_train_tpu_torch.tasks.detection import dfine_utils as D
from lightly_train_tpu_torch.tasks.detection import ltdetr as L
from torch_fixtures.threads import one_torch_thread  # noqa: F401

B, NC, K = 2, 4, 5
SMALL = dict(num_classes=NC, num_queries=8, d_model=32, num_heads=2,
             dim_feedforward=48, num_decoder_layers=2, csp_blocks=1,
             num_points=(2, 2, 2), dfine_bins=17)
BACKBONES = {"dinov2/vittest14": 56, "ecvit/ecvittest": 96}


@pytest.fixture(autouse=True)
def exact(monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("LIGHTLY_TRAIN_MATCHER", "hungarian")


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _scale(tree, seed):
    """Checkpoint-scale values: kernels (and the fused in-projections) at
    1/sqrt(fan-in), norm scales near 1, the rest at 0.5 std."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name in ("kernel", "in_proj_kernel"):
            return rng.standard_normal(x.shape) / np.sqrt(
                np.prod(x.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.2 * np.abs(rng.standard_normal(x.shape))
        return 0.5 * rng.standard_normal(x.shape)

    return jax.device_get(jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), tree))


def _stats(tree, seed):
    """BatchNorm running statistics away from their init."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if str(path[-1].key) == "var":
            return 1.0 + 0.3 * np.abs(rng.standard_normal(x.shape))
        return 0.2 * rng.standard_normal(x.shape)

    return jax.device_get(jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), tree))


def _boxes(rng, shape):
    c = rng.uniform(0.2, 0.8, shape + (2,))
    wh = rng.uniform(0.05, 0.4, shape + (2,))
    return np.concatenate([c, wh], -1).astype(np.float32)


def _targets(seed, k=K, classes=NC):
    rng = np.random.default_rng(seed)
    valid = np.ones((B, k), bool)
    valid[0, -2:] = False
    valid[1, -1] = False
    return (rng.integers(0, classes, (B, k)).astype(np.int32),
            _boxes(rng, (B, k)), valid)


# ---------------------------------------------------------------------------
# box and D-FINE utilities
# ---------------------------------------------------------------------------


def test_box_utils_match_jax():
    rng = np.random.default_rng(0)
    a = _boxes(rng, (3, 6))
    b = _boxes(rng, (3, 7))
    xa, xb = JB.cxcywh_to_xyxy(a), JB.cxcywh_to_xyxy(b)
    pa, pb = PB.cxcywh_to_xyxy(_t(a)), PB.cxcywh_to_xyxy(_t(b))
    assert _rel(pa, xa) < 1e-6
    assert _rel(PB.xyxy_to_cxcywh(pa), JB.xyxy_to_cxcywh(xa)) < 1e-6
    assert _rel(PB.box_area(pa), JB.box_area(xa)) < 1e-6
    for name in ("box_iou", "generalized_box_iou"):
        assert _rel(getattr(PB, name)(pa, pb), getattr(JB, name)(xa, xb)) \
            < 1e-6, name
    for name in ("paired_box_iou", "paired_generalized_box_iou"):
        assert _rel(getattr(PB, name)(pa, pb[:, :6]),
                    getattr(JB, name)(xa, xb[:, :6])) < 1e-6, name


@pytest.mark.parametrize("reg_max", [16, 32])
def test_dfine_utils_match_jax(reg_max):
    np.testing.assert_array_equal(D.weighting_function(reg_max),
                                  JD.weighting_function(reg_max))
    rng = np.random.default_rng(reg_max)
    project = JD.weighting_function(reg_max)
    corners = rng.standard_normal((2, 5, 4, reg_max + 1)).astype(np.float32)
    got = D.integral(_t(corners), project)
    assert _rel(got, JD.integral(jnp.asarray(corners), project)) < 1e-6
    anchors = _boxes(rng, (2, 5))
    dist = rng.uniform(-3, 3, (2, 5, 4)).astype(np.float32)
    assert _rel(D.distance2bbox(_t(anchors), _t(dist)),
                JD.distance2bbox(jnp.asarray(anchors), jnp.asarray(dist))) \
        < 1e-6
    # Targets inside, left of and right of the bins.
    tgt = JB.cxcywh_to_xyxy(np.concatenate(
        [_boxes(rng, (2, 4)), anchors[:, :1] * [1, 1, 0.01, 0.01]], 1))
    want = JD.bbox2distance(jnp.asarray(anchors), tgt, reg_max)
    got = D.bbox2distance(_t(anchors), _t(tgt), reg_max)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_sincos_embeddings_match_jax():
    assert _rel(C.rtdetr_sincos_pe(5, 3, 32),
                JC.rtdetr_sincos_pe(5, 3, 32)) < 1e-6
    assert _rel(C.sincos_2d(3, 5, 32), JC.sincos_2d(3, 5, 32)) < 1e-6


def test_ema_momentum_and_flat_cosine_match_jax():
    # float32's exp differs from XLA's by an ulp near 1, which 1 - exp
    # magnifies at the first steps: within 1e-7 absolute.
    for step in (0, 1, 7, 1999, 2000, 50_000):
        assert abs(ema_warmup_momentum(step, 0.9998) - float(
            JEMA.ema_warmup_momentum(step, 0.9998))) <= 1e-7
    for total, warm in ((100, 2), (60_000, 1200), (3, 0)):
        want = JS.flat_cosine(2e-4, total, warmup_steps=warm)
        got = flat_cosine(2e-4, total, warmup_steps=warm)
        for step in sorted({0, 1, warm, warm + 1, total // 2, total // 2 + 1,
                            total - 1, total, total + 5}):
            assert got(step) == float(want(step)), (total, step)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _init(module, *args, seed=0, **kwargs):
    variables = jax.eval_shape(lambda: module.init(jax.random.key(0), *args,
                                                   **kwargs))
    params = _scale(variables["params"], seed)
    stats = {k: _stats(v, seed + 1) for k, v in variables.items()
             if k != "params"}
    return params, stats


def _load(module, params, stats):
    module.load_state_dict(variables_from_jax({"params": params, **stats}))
    return module


def _cfg(**kw):
    base = dict(d_model=32, num_heads=2, dim_feedforward=48,
                enc_dim_feedforward=40, num_queries=8, num_decoder_layers=2,
                num_classes=NC, csp_blocks=2, num_points=(2, 3, 2),
                dfine_bins=17)
    base.update(kw)
    return base


def test_grid_sample_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    level = rng.standard_normal((2, 4, 5, 2, 3)).astype(np.float32)
    # Locations inside, on the border and outside the map.
    locs = rng.uniform(-0.3, 1.3, (2, 6, 2, 3, 2)).astype(np.float32)
    cot = rng.standard_normal((2, 6, 2, 3, 3)).astype(np.float32)
    want, vjp = jax.vjp(JC._grid_sample_zeros, jnp.asarray(level),
                        jnp.asarray(locs))
    g_level, g_locs = vjp(jnp.asarray(cot))
    lv, lc = _t(level).requires_grad_(), _t(locs).requires_grad_()
    got = C.grid_sample_zeros(lv, lc)
    got.backward(_t(cot))
    assert _rel(got, want) < 1e-6
    assert _rel(lv.grad, g_level) < 1e-6
    assert _rel(lc.grad, g_locs) < 1e-5


@pytest.mark.parametrize("value_proj", [False, True])
def test_deformable_attention_matches_jax(value_proj):
    cfg = _cfg(use_dfine=not value_proj)
    rng = np.random.default_rng(2)
    query = rng.standard_normal((2, 7, 32)).astype(np.float32)
    ref = _boxes(rng, (2, 7))
    levels = [rng.standard_normal((2, h, w, 32)).astype(np.float32)
              for h, w in ((6, 5), (3, 3), (2, 1))]
    jm = JC.MSDeformableAttention(JC.DetrConfig(**cfg),
                                  with_value_proj=value_proj)
    params, _ = _init(jm, jnp.asarray(query), jnp.asarray(ref),
                      [jnp.asarray(v) for v in levels])
    # Offsets large enough to reach outside the maps.
    want = jm.apply({"params": params}, query, ref, levels)
    pm = _load(C.MSDeformableAttention(C.DetrConfig(**cfg), value_proj),
               params, {})
    q = _t(query).requires_grad_()
    got = pm(q, _t(ref), [_t(v) for v in levels])
    assert _rel(got, want) < 1e-5
    g = jax.grad(lambda x: jnp.sum(jm.apply({"params": params}, x, ref,
                                            levels) ** 2))(jnp.asarray(query))
    (got ** 2).sum().backward()
    assert _rel(q.grad, g) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_and_dn_mask_match_jax(dtype):
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(3)
    n_dn, k, group = 6, 5, 3
    x = rng.standard_normal((2, n_dn + k, 32)).astype(np.float32)
    pos = rng.standard_normal((2, n_dn + k, 32)).astype(np.float32)
    mask = C.dn_mask_keep(n_dn, k, group)
    # The JAX decoder's mask, built as DETRDecoder builds it.
    idx = np.arange(n_dn + k)
    grp = np.where(idx < n_dn, idx // group, -1)
    want_mask = np.where((idx < n_dn)[None], grp[:, None] == grp[None],
                         True)[None, None]
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    fill = C.masked_logits_fill(pdt)
    want_fill = jnp.asarray(jnp.finfo(jnp.float32).min, jdt)
    assert float(fill) == float(want_fill)
    if dtype == "bfloat16":
        assert float(fill) == float("-inf")
    jm = JC.TorchMHA(32, 2, dtype=jdt)
    params, _ = _init(jm, x, x, x)
    qk = jnp.asarray(x + pos).astype(jdt)
    want = jm.apply({"params": params}, qk, qk, jnp.asarray(x).astype(jdt),
                    jnp.asarray(want_mask))
    pm = _load(C.TorchMHA(32, 2, pdt), params, {})
    got = pm(_t(x + pos).to(pdt), _t(x + pos).to(pdt), _t(x).to(pdt), mask)
    assert got.dtype == pdt
    assert _rel(got.float(), np.asarray(want, np.float32)) < (
        1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("train", [False, True])
def test_hybrid_encoder_matches_jax(train):
    cfg = _cfg(enc_d_model=24)
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((2, h, h, c)).astype(np.float32)
             for h, c in ((8, 12), (4, 20), (2, 16))]
    jm = JC.HybridEncoder(JC.DetrConfig(**cfg))
    params, stats = _init(jm, [jnp.asarray(f) for f in feats])
    pm = _load(C.HybridEncoder(C.DetrConfig(**cfg), [12, 20, 16]),
               params, stats)
    want = jm.apply({"params": params, **stats}, feats, train,
                    mutable=["batch_stats"] if train else False)
    got = pm([_t(f) for f in feats], train)
    if train:
        want, new_stats = want
        state = variables_from_jax(new_stats)
        for name, value in state.items():
            assert _rel(pm.state_dict()[name], value) < 1e-5, name
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5


@pytest.mark.parametrize("use_sta", [True, False])
def test_dinostas_matches_jax(use_sta):
    rng = np.random.default_rng(5)
    image = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    taps = [rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
            for _ in range(3)]
    jm = JBA.DINOSTAs(hidden_dim=24, use_sta=use_sta, conv_inplane=8)
    params, stats = _init(jm, jnp.asarray(image),
                          [jnp.asarray(t) for t in taps])
    pm = _load(BA.DINOSTAs(16, 24, use_sta, 8), params, stats)
    for train in (False, True):
        want = jm.apply({"params": params, **stats}, image, taps, train,
                        mutable=["batch_stats"] if train else False)
        want = want[0] if train else want
        got = pm(_t(image), [_t(t) for t in taps], train)
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-5
    assert BA.resolve_vit_adapter(768, 12) == JBA.resolve_vit_adapter(768, 12)
    assert BA.resolve_vit_adapter(768, 12) == ((5, 8, 11), 4)
    for dim, depth in ((32, 2), (192, 12), (384, 12), (1024, 24),
                       (1536, 40)):
        assert BA.resolve_vit_adapter(dim, depth) == \
            JBA.resolve_vit_adapter(dim, depth)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def _models(name, **extra):
    args = {**SMALL, **extra}
    j_model = JL.ObjectDetectionTrainModel(
        jax_get_wrapped_model(name, dtype=jnp.float32),
        JL.ObjectDetectionArgs(**args))
    p_model = L.ObjectDetectionTrainModel(get_wrapped_model(name),
                                          L.ObjectDetectionArgs(**args))
    size = BACKBONES[name]
    params, model_state = jax.eval_shape(lambda: j_model.init(
        jax.random.key(0), {"images": jnp.zeros((B, size, size, 3))}))
    params = _scale(params, 1)
    model_state = {k: _stats(v, 2) for k, v in model_state.items()}
    module = p_model.init(torch.Generator().manual_seed(0),
                          torch.device("cpu"))
    module.load_state_dict(task_state_from_jax(params, model_state))
    return j_model, p_model, params, model_state, module, size


def _images(size, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, size, size, 3)).astype(np.float32)


def _dn_draws(key, j_model, shape):
    """The JAX ``_make_dn_queries`` draws of ``key``, in the port's
    order."""
    k_box, k_size, k_label, k_flip = jax.random.split(key, 4)
    a = j_model.args
    return (_t(jax.random.uniform(k_box, shape + (2,))),
            _t(jax.random.uniform(k_size, shape + (2,))),
            _t(jax.random.randint(k_label, shape, 0, a.num_classes)),
            _t(jax.random.uniform(k_flip, shape)))


@pytest.mark.parametrize("name", sorted(BACKBONES))
@pytest.mark.parametrize("decoder", ["dfine", "rtdetrv2"])
def test_model_outputs_match_jax(name, decoder):
    j_model, p_model, params, state, module, size = _models(
        name, decoder=decoder)
    images = _images(size)
    want, _ = jax.jit(lambda p, x: j_model._apply(p, state, x, False))(
        params, jnp.asarray(images))
    got = p_model._outputs(module, _t(images))
    n_levels = 2 + SMALL["num_decoder_layers"] - (decoder != "dfine")
    assert len(got) == len(want) == n_levels
    for (gl, gb), (wl, wb) in zip(got, want):
        assert _rel(gl, wl) < 1e-4 and _rel(gb, wb) < 1e-4
    # The decoded top-k.
    w_boxes, w_scores, w_labels, w_q = j_model._decode(want, return_q=True)
    g_boxes, g_scores, g_labels = p_model._decode(got)
    np.testing.assert_array_equal(g_labels.numpy(), np.asarray(w_labels))
    assert _rel(g_scores, w_scores) < 1e-5
    assert _rel(g_boxes, w_boxes) < 1e-4


def test_dn_queries_match_jax():
    j_model, p_model, *_ = _models("ecvit/ecvittest")
    labels, boxes, valid = _targets(6)
    key = jax.random.key(9)
    want = j_model._make_dn_queries(key, jnp.asarray(labels),
                                    jnp.asarray(boxes), jnp.asarray(valid))
    draws = _dn_draws(key, j_model, (B, 2 * K))
    got = p_model.make_dn_queries(_t(labels), _t(boxes), _t(valid), draws)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def _jax_loss(j_model, params, state, batch, rng):
    def f(p):
        loss, (new_state, metrics) = j_model.loss_fn(p, state, batch, rng, 0)
        return loss, (new_state, metrics)
    return jax.jit(jax.value_and_grad(f, has_aux=True))(params)


def _two_pass_variance(monkeypatch):
    """Both packages' train-mode BatchNorms take the batch variance as
    ``E[(x - E[x])^2]``, in place of Flax's default ``E[x^2] - E[x]^2``."""
    stats = FN._compute_stats
    monkeypatch.setattr(FN, "_compute_stats", lambda *a, **k: stats(
        *a, **{**k, "use_fast_variance": False}))
    monkeypatch.setattr(PC.BatchNorm, "use_fast_variance", False)


@pytest.mark.parametrize("case", ["vit-dfine", "vit-rtdetrv2-nodn",
                                  "ecvit-dfine", "ecvit-rtdetrv2"])
def test_loss_and_gradients_match_jax(case, monkeypatch):
    """The loss, its metrics and every leaf's gradient of one step. The
    ECViT cases (``ecvit-dfine`` is ``ltdetrv2``'s default: D-FINE with 2
    denoising groups) run with the two-pass variance in both packages: at
    96x96 a train-mode BatchNorm of ECViT-test normalizes 18 values a
    channel, some with a squared mean 1e3 times their variance, and there
    Flax's ``E[x^2] - E[x]^2`` (which the port copies) cancels, so the two
    packages' differently ordered sums move a gradient by up to a few
    percent (and can flip the sign of a decoder ReLU's input near 0).
    Their metrics are held at 1e-4 relative, as the whole model's outputs
    are: D-FINE's FGL term interpolates between the narrow bins its
    weighting function puts near 0, and there a 1e-7 relative change of
    ECViT-test's input images moves the port's own ``loss_fgl`` by 4.5e-6
    relative."""
    name = "dinov2/vittest14" if case.startswith("vit") else "ecvit/ecvittest"
    decoder = "rtdetrv2" if "rtdetrv2" in case else "dfine"
    dn = 0 if case.endswith("nodn") else 2
    if name == "ecvit/ecvittest":
        _two_pass_variance(monkeypatch)
    j_model, p_model, params, state, module, size = _models(
        name, decoder=decoder, dn_groups=dn)
    labels, boxes, valid = _targets(7)
    images = _images(size, 1)
    batch = {"images": images, "labels": labels, "boxes": boxes,
             "box_valid": valid}
    rng = jax.random.key(11)
    (want, (new_state, metrics)), grads = _jax_loss(
        j_model, params, state, {k: jnp.asarray(v) for k, v in batch.items()},
        rng)
    k_dn, _ = jax.random.split(rng)
    monkeypatch.setattr(p_model, "dn_draws",
                        lambda g, shape, dev: _dn_draws(k_dn, j_model, shape))
    got, p_metrics = p_model.loss_fn(module, {k: _t(v) for k, v in
                                              batch.items()}, None, 0)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert set(p_metrics) == set(metrics)
    tol = 1e-5 if name == "dinov2/vittest14" else 1e-4
    for key, value in metrics.items():
        assert abs(float(p_metrics[key]) - float(value)) <= tol * max(
            abs(float(value)), 1e-3), key
    got.backward()
    ref = task_state_from_jax(grads)
    named = dict(module.named_parameters())
    assert set(ref) == set(named)
    # A bias right before a train-mode BatchNorm (the adapter's and the
    # encoder's outputs) has an exact gradient of 0: both packages' values
    # are rounding noise, held below 1e-6 of the largest gradient.
    scale = max(float(g.abs().max()) for g in ref.values())
    for key, g in ref.items():
        p_grad = named[key].grad
        if float(g.abs().max()) < 1e-6 * scale:
            assert p_grad is None or float(p_grad.abs().max()) < 1e-6 * scale
            continue
        assert _rel(p_grad, g) < 1e-4, key
    # The BatchNorm statistics the step moved.
    moved = variables_from_jax(new_state, prefix="backbone.")
    for key, value in moved.items():
        assert _rel(module.state_dict()[key], value) < 1e-5, key


# ---------------------------------------------------------------------------
# the criterion
# ---------------------------------------------------------------------------


def _assignments(seed, levels=3, q=7):
    rng = np.random.default_rng(seed)
    out = np.full((levels, B, K), -1, np.int32)
    for li in range(levels):
        for b in range(B):
            perm = rng.permutation(q)[:K]
            out[li, b] = np.where(rng.uniform(size=K) < 0.8, perm, -1)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_go_union_matches_jax(seed):
    assign = _assignments(seed)
    _, _, valid = _targets(seed)
    for n_pairs in (7, 4):
        want = JCR._go_union_host(assign, valid, n_pairs)
        got = CR.go_union(_t(assign), _t(valid), n_pairs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        want = JCR.go_union_device(jnp.asarray(assign), jnp.asarray(valid),
                                   n_pairs)
        got = CR.go_union_device(_t(assign), _t(valid), n_pairs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _level(rng, q=7, nb=17):
    logits = rng.standard_normal((B, q, NC + 1)).astype(np.float32)
    boxes = _boxes(rng, (B, q))
    dist = rng.standard_normal((B, q, 4, nb)).astype(np.float32)
    return logits, boxes, dist


@pytest.mark.parametrize("is_final", [False, True])
def test_fgl_ddf_losses_and_gradients_match_jax(is_final):
    rng = np.random.default_rng(8)
    logits, boxes, dist = _level(rng)
    _, t_boxes, valid = _targets(8)
    anchor = _boxes(rng, (B, 7))
    teacher = rng.standard_normal(dist.shape).astype(np.float32)
    go = CR.go_union_host(_assignments(8), valid, 7)
    num = np.float32(max(go[2].sum(), 1))

    def jax_fn(d):
        fgl, ddf = JCR.dfine_fgl_ddf_loss(
            d, anchor, boxes, teacher, logits, t_boxes,
            *(jnp.asarray(x.astype(np.int32) if x.dtype != bool else x)
              for x in go), num, is_final=is_final)
        return fgl + 2.0 * ddf, (fgl, ddf)

    (_, (w_fgl, w_ddf)), w_grad = jax.value_and_grad(jax_fn, has_aux=True)(
        jnp.asarray(dist))
    d = _t(dist).requires_grad_()
    fgl, ddf = CR.dfine_fgl_ddf_loss(
        d, _t(anchor), _t(boxes), _t(teacher), _t(logits), _t(t_boxes),
        *(_t(x) for x in go), torch.tensor(num), is_final=is_final)
    assert abs(float(fgl) - float(w_fgl)) <= 1e-5 * abs(float(w_fgl))
    assert abs(float(ddf) - float(w_ddf)) <= 1e-5 * max(abs(float(w_ddf)),
                                                        1e-6)
    (fgl + 2.0 * ddf).backward()
    assert _rel(d.grad, w_grad) < 1e-4


@pytest.mark.parametrize("matcher", ["hungarian", "greedy"])
def test_criterion_matches_jax(matcher, monkeypatch):
    monkeypatch.setenv("LIGHTLY_TRAIN_MATCHER", matcher)
    rng = np.random.default_rng(9)
    levels = [_level(rng) for _ in range(4)]
    labels, t_boxes, valid = _targets(9)
    outputs = [(lg, bx) for lg, bx, _ in levels]
    dists = [None, None] + [(d, _boxes(rng, (B, 7))) for _, _, d in
                            levels[2:]]
    want, w_metrics = JCR.detection_criterion(
        [(jnp.asarray(a), jnp.asarray(b)) for a, b in outputs], labels,
        t_boxes, valid, dists=[None if x is None else tuple(
            jnp.asarray(y) for y in x) for x in dists])
    before = dict(CR.HOST_SYNCS)
    got, g_metrics = CR.detection_criterion(
        [(_t(a), _t(b)) for a, b in outputs], _t(labels), _t(t_boxes),
        _t(valid), dists=[None if x is None else tuple(_t(y) for y in x)
                          for x in dists])
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert set(g_metrics) == set(w_metrics)
    for key, value in w_metrics.items():
        assert abs(float(g_metrics[key]) - float(value)) <= 1e-5 * max(
            abs(float(value)), 1e-3), key
    # Four matchings and one GO union on the host, none with greedy.
    host = matcher == "hungarian"
    assert CR.HOST_SYNCS["hungarian"] - before["hungarian"] == 4 * host
    assert CR.HOST_SYNCS["go_union"] - before["go_union"] == host
    # The matching cost alone.
    cost = CR.detection_matching_cost(_t(outputs[0][0]), _t(outputs[0][1]),
                                      _t(labels), _t(t_boxes))
    assert _rel(cost, JCR.detection_matching_cost(
        jnp.asarray(outputs[0][0]), jnp.asarray(outputs[0][1]),
        jnp.asarray(labels), jnp.asarray(t_boxes))) < 1e-6


def test_validation_statistics_and_map_match_jax():
    j_model, p_model, params, state, module, size = _models(
        "ecvit/ecvittest", num_queries=6)
    images = _images(size, 3)
    labels, boxes, valid = _targets(3)
    batch = {"images": images, "labels": labels, "boxes": boxes,
             "box_valid": valid}
    want = jax.jit(lambda p, b: j_model.val_step(p, state, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = p_model.val_step(module, {k: _t(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for key in ("pred_labels", "tgt_labels", "tgt_valid", "sample_valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    for key in ("pred_boxes", "pred_scores", "tgt_boxes"):
        assert _rel(got[key], want[key]) < 1e-4, key
    # val_finalize on the JAX statistics, twice over.
    collected = [jax.device_get(want)] * 2
    assert p_model.val_finalize(collected) == j_model.val_finalize(collected)


def test_conv_bn_act_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 7, 7, 5)).astype(np.float32)
    jm = JC.ConvBNAct(6, kernel=3, strides=2)
    params, stats = _init(jm, jnp.asarray(x))
    pm = _load(C.ConvBNAct(5, 6, 3, 2), params, stats)
    for train in (False, True):
        want = jm.apply({"params": params, **stats}, x, train,
                        mutable=["batch_stats"] if train else False)
        want = want[0] if train else want
        got = pm(_t(x).permute(0, 3, 1, 2), train).permute(0, 2, 3, 1)
        assert _rel(got, want) < 1e-5


# ---------------------------------------------------------------------------
# the datasets
# ---------------------------------------------------------------------------


def _same_items(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_detection_datasets_match_jax(tmp_path):
    """YOLO labels (flat beside the images and mirrored under a nested
    split folder) and a COCO JSON (with a crowd box and a missing image),
    read by both packages at 40^2: every item equal; the JAX errors."""
    import json
    import shutil

    from lightly_train_tpu.errors import DatasetError as JDatasetError
    from lightly_train_tpu.tasks.detection import data as JDATA
    from lightly_train_tpu_torch.errors import DatasetError
    from lightly_train_tpu_torch.tasks.detection import data as DATA
    from torch_fixtures.detection_data import write_detection

    yolo = write_detection(tmp_path / "yolo", n=3, num_classes=3)
    nested = tmp_path / "nested"
    shutil.copytree(yolo["train"]["images"], nested / "images" / "train")
    shutil.copytree(yolo["train"]["labels"], nested / "labels" / "train")
    for images, labels in ((yolo["train"]["images"],
                            yolo["train"]["labels"]),
                           (nested / "images", nested / "labels")):
        _same_items(DATA.YOLOObjectDetectionDataset(images, labels, (40, 40),
                                                    max_boxes=4),
                    JDATA.YOLOObjectDetectionDataset(images, labels,
                                                     (40, 40), max_boxes=4))
    coco = write_detection(tmp_path / "coco", n=3, num_classes=3,
                           fmt="coco")
    ann = json.loads(open(coco["train"]["annotations"]).read())
    ann["images"].append({"id": 99, "file_name": "gone.png", "width": 40,
                          "height": 40})
    path = tmp_path / "coco" / "missing.json"
    path.write_text(json.dumps(ann))
    images = coco["train"]["images"]
    _same_items(DATA.COCOObjectDetectionDataset(images, path, (40, 40)),
                JDATA.COCOObjectDetectionDataset(images, path, (40, 40)))
    with pytest.raises(DatasetError, match="is missing under") as got:
        DATA.COCOObjectDetectionDataset(images, path, (40, 40),
                                        skip_if_annotations_missing=False)
    with pytest.raises(JDatasetError, match="is missing under") as want:
        JDATA.COCOObjectDetectionDataset(images, path, (40, 40),
                                         skip_if_annotations_missing=False)
    assert str(got.value) == str(want.value)
    with pytest.raises(DatasetError, match=r"outside \[0, 0\)"):
        DATA.YOLOObjectDetectionDataset(yolo["train"]["images"],
                                        yolo["train"]["labels"], (40, 40),
                                        class_names=[])[0]


def test_vitb14_resolves_the_jax_adapter():
    """ViT-B/14 taps blocks (5, 8, 11) with a 56-channel STA stem."""
    model = L.ObjectDetectionTrainModel(get_wrapped_model("dinov2/vitb14"),
                                        L.ObjectDetectionArgs())
    assert model.interaction_indexes == (5, 8, 11)
    assert model.conv_inplane == 56
