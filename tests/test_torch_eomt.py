"""EoMT's model, matchers, losses and schedules in the port against the
JAX package (``tasks/eomt_semantic_segmentation.py``).

Both packages start from the same checkpoint-scale weights
(``models/from_jax.py::task_state_from_jax``) and see the same normalized
batch, fp32 with the JAX matmuls at "highest" and TF32 off. Every random
draw the JAX functions make (the joint blocks' per-query releases,
``fold_in(rng_trunk, j)``; each level's matching points and each slot
chunk's candidate and uniform points, ``fold_in(rng_loss, li)``,
``split(k_loss, nk)``) is recomputed from its key here and handed to the
port through ``ops/point_sampling.py::injected``, the port drawing every
slot at once where JAX maps over chunks. The JAX losses run with the
Hungarian matcher on one device (``LIGHTLY_TRAIN_MATCHER=hungarian``).

Held: the trunk's per-level logits and factors (1e-5 relative) in training
and inference, on ``dinov2/vittest14`` and ``dinov3/vittest16`` (RoPE and
registers), with one joint block and with the auto count; the joint
blocks' attention masks, equal; ``_ScaleBlock`` carried by ``from_jax``;
both matchers' assignments, equal (greedy on costs full of ties); both
losses and a whole model step, with and without active-slot compaction (on
masks of at most ``max_active_slots`` classes) and without point sampling
(semantic, and the instance model's slot-id targets): values 1e-5
relative, gradients 1e-4 relative L2; the validation statistics;
``_mask_probs`` at the windows' edges; the LLRD scales, the parameter
groups and both schedules over a run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.tasks import eomt_instance_panoptic as JIP
from lightly_train_tpu.tasks import eomt_semantic_segmentation as JE
from lightly_train_tpu_torch.models.from_jax import (
    params_from_jax,
    task_state_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops import point_sampling as PS
from lightly_train_tpu_torch.ops.kernels import attention as A
from lightly_train_tpu_torch.tasks import eomt_instance_panoptic as IP
from lightly_train_tpu_torch.tasks import eomt_semantic_segmentation as E
from torch_fixtures.finetune import checkpoint_scale
from torch_fixtures.threads import one_torch_thread  # noqa: F401

B, NC, Q, POINTS = 2, 4, 6, 48
BACKBONES = {"dinov2/vittest14": 28, "dinov3/vittest16": 32}


@pytest.fixture(autouse=True)
def exact(monkeypatch):
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("LIGHTLY_TRAIN_MATCHER", "hungarian")


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _models(name, instance=False, **extra):
    args = dict(num_classes=NC, num_queries=Q, num_points=POINTS, **extra)
    j_mod, p_mod = (JIP, IP) if instance else (JE, E)
    kind = "Instance" if instance else "Semantic"
    j_model = getattr(j_mod, f"EoMT{kind}SegmentationTrainModel")(
        jax_get_wrapped_model(name, dtype=jnp.float32),
        getattr(j_mod, f"EoMT{kind}SegmentationArgs")(**args))
    p_model = getattr(p_mod, f"EoMT{kind}SegmentationTrainModel")(
        get_wrapped_model(name),
        getattr(p_mod, f"EoMT{kind}SegmentationArgs")(**args))
    size = BACKBONES[name]
    shapes = jax.eval_shape(j_model.init, jax.random.key(0),
                            {"images": jnp.zeros((2, size, size, 3))})
    params = jax.device_get(checkpoint_scale(shapes[0], 1))
    module = p_model.init(torch.Generator().manual_seed(0),
                          torch.device("cpu"))
    module.load_state_dict(task_state_from_jax(params))
    return j_model, p_model, params, module, size


def _batch(size, seed=0, classes=NC):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, size, size, 3)).astype(np.float32)
    blocks = rng.integers(0, classes, (B, 4, 4))
    cell = -(-size // 4)
    masks = np.kron(blocks, np.ones((cell, cell), int))[:size, :size].astype(
        np.int32)
    masks[:, :2, :5] = 255
    return {"images": images, "masks": masks}


def _instance_batch(size, seed, slots):
    """``_batch``'s blocks as slot ids (255: no slot), each slot's class
    and flag (one present slot flagged invalid)."""
    batch = _batch(size, seed, slots)
    rng = np.random.default_rng(seed + 1)
    valid = np.ones((B, slots), bool)
    valid[0, 1] = False
    return {"images": batch["images"], "seg_map": batch["masks"],
            "seg_labels": rng.integers(0, NC, (B, slots)).astype(np.int32),
            "seg_valid": valid}


def _trunk_draws(rng_trunk, joint: int):
    return [_t(jax.random.uniform(jax.random.fold_in(rng_trunk, j), (B, Q)))
            for j in range(joint)]


def _loss_draws(rng_level, K, n_points=POINTS, ratio=3.0, importance=0.75,
                batch=B):
    """The uniforms of one ``point_sampled_mask_loss`` call, as the port
    draws them: the matching points, then every slot's candidates, then
    every slot's uniform points (each JAX chunk's rows put in place)."""
    B = batch
    k_match, k_loss = jax.random.split(rng_level)
    kc = JE._slot_chunk_size(K)
    nk = K // kc
    n_over = int(n_points * ratio)
    n_rand = n_points - int(importance * n_points)
    over, rand = [], []
    for key in jax.random.split(k_loss, nk):
        k_over, k_rand = jax.random.split(key)
        over.append(np.asarray(jax.random.uniform(k_over,
                                                  (B * kc, n_over, 2))))
        rand.append(np.asarray(jax.random.uniform(k_rand,
                                                  (B * kc, n_rand, 2))))

    def slots(chunks, n):
        return _t(np.stack(chunks).reshape(nk, B, kc, n, 2).transpose(
            1, 0, 2, 3, 4).reshape(B * K, n, 2))

    return [_t(jax.random.uniform(k_match, (B, n_points, 2))),
            slots(over, n_over), slots(rand, n_rand)]


# ---------------------------------------------------------------------------
# trunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(BACKBONES))
@pytest.mark.parametrize("joint", [1, None])
def test_trunk_levels_and_masks_match_jax(name, joint, monkeypatch):
    j_model, p_model, params, module, size = _models(
        name, num_joint_blocks=joint)
    J = p_model.args.num_joint_blocks
    assert J == j_model.args.num_joint_blocks == (1 if joint else 2)
    images = _batch(2 * size)["images"]
    probs = np.linspace(0.9, 0.99, J).astype(np.float32)
    rng = jax.random.key(3)

    def run(p, train):
        return j_model.trunk.apply(
            {"params": p["backbone"]}, jnp.asarray(images), jnp.asarray(probs),
            rng if train else None, train, return_factors=True)

    masks = []
    plain = A.dot_product_attention

    def spy(q, k, v, num_heads, mask=None, scale=None):
        masks.append(mask)
        return plain(q, k, v, num_heads, mask, scale)

    monkeypatch.setattr(A, "dot_product_attention", spy)
    for train in (True, False):
        (want, grid), masks[:] = jax.jit(run, static_argnums=1)(
            params, train), []
        with PS.injected(_trunk_draws(rng, J) if train else []):
            got, p_grid = module.backbone(_t(images), probs, None,
                                          train=train, return_factors=True)
        assert tuple(p_grid) == tuple(grid) and len(got) == len(want) == J + 1
        for level_got, level_want in zip(got, want):
            for g, w in zip(level_got, level_want):
                assert _rel(g.detach().numpy(), w) < 1e-5
        # The joint blocks' masks from the JAX levels' logits and draws.
        assert sum(m is not None for m in masks) == (J if train else 0)
        if not train:
            continue
        mh, mw = grid
        gh, gw = mh // 4, mw // 4
        u = _trunk_draws(rng, J)
        closed = []
        for j, mask in enumerate(m for m in masks if m is not None):
            interp = jax.image.resize(
                want[j][1].reshape(B, Q, mh, mw), (B, Q, gh, gw), "bilinear",
                antialias=False)
            allowed = (np.asarray(interp) > 0).reshape(B, Q, gh * gw) | (
                u[j].numpy() > probs[j])[..., None]
            n_prefix = mask.shape[-1] - gh * gw
            assert tuple(mask.shape) == (B, 1, mask.shape[-1], mask.shape[-1])
            np.testing.assert_array_equal(mask[:, 0, :Q, n_prefix:].numpy(),
                                          allowed)
            assert mask[:, 0, :Q, :n_prefix].all() and mask[:, 0, Q:].all()
            closed.append(~allowed)
        assert np.mean(closed) > 0.0  # some query rows are masked


def test_scale_block_carried_from_jax():
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 8)).astype(
        np.float32)
    block = JE._ScaleBlock(8, jnp.float32)
    shapes = jax.eval_shape(block.init, jax.random.key(0), jnp.asarray(x))
    params = jax.device_get(checkpoint_scale(shapes["params"], 5))
    want = block.apply({"params": params}, jnp.asarray(x))
    port = E.ScaleBlock(8, torch.float32)
    state = params_from_jax({"upscale0": params})
    port.load_state_dict({k[len("upscale0."):]: v for k, v in state.items()})
    got = port(_t(x))
    assert got.shape == (2, 6, 10, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# matchers
# ---------------------------------------------------------------------------


def _costs(seed, ties):
    rng = np.random.default_rng(seed)
    cost = (rng.integers(0, 4, (5, 7, 6)).astype(np.float32) if ties
            else rng.standard_normal((5, 7, 6)).astype(np.float32))
    valid = rng.uniform(size=(5, 6)) < 0.7
    valid[0] = False
    return cost, valid


@pytest.mark.parametrize("ties", [False, True])
def test_greedy_assignments_equal_jax(ties):
    cost, valid = _costs(6, ties)
    want = np.asarray(jax.jit(JE.greedy_match)(jnp.asarray(cost),
                                               jnp.asarray(valid)))
    got = E.greedy_match(_t(cost), _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == -1).all()


def test_hungarian_assignments_equal_jax():
    cost, valid = _costs(7, False)
    cost[1, 2, 3], cost[2, 0, 1], cost[3, 4, 0] = np.nan, np.inf, -np.inf
    want = JE._hungarian_host(cost, valid)
    np.testing.assert_array_equal(E.hungarian_host(cost, valid), want)


@pytest.mark.parametrize("choice", ["auto", "hungarian", "greedy"])
def test_matcher_choice(choice, monkeypatch):
    monkeypatch.setenv("LIGHTLY_TRAIN_MATCHER", choice)
    cost, valid = _costs(8, True)
    want = (E.greedy_match if choice == "greedy" else
            lambda c, v: torch.from_numpy(E.hungarian_host(c.numpy(),
                                                           v.numpy())))
    assert torch.equal(E.hungarian_match(_t(cost), _t(valid)),
                       want(_t(cost), _t(valid)))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

WEIGHTS = dict(num_classes=NC, class_weight=2.0, mask_weight=5.0,
               dice_weight=5.0, no_object_weight=0.1)


def _loss_inputs(seed, K, grid=(6, 5), D=8):
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((B, Q, NC + 1)).astype(np.float32)
    q_emb = rng.standard_normal((B, Q, D)).astype(np.float32)
    pixels = rng.standard_normal((B, *grid, D)).astype(np.float32) * 0.5
    masks = np.einsum("bqd,bhwd->bqhw", q_emb, pixels).reshape(B, Q, -1)
    id_map = rng.integers(-1, K + 1, (B, 13, 11)).astype(np.int32)
    valid = rng.uniform(size=(B, K)) < 0.8
    tgt = rng.integers(0, NC, (B, K)).astype(np.int32)
    return cls, masks, (q_emb, pixels), id_map, valid, tgt


@pytest.mark.parametrize("factors,compact", [(True, False), (False, False),
                                             (True, True)])
def test_point_sampled_loss_and_gradients_match_jax(factors, compact):
    K = 20  # two chunks of 10 slots in the JAX loss
    cls, masks, fac, id_map, valid, tgt = _loss_inputs(9, K)
    slot_ids = (np.random.default_rng(10).permutation(K + 2)[:K][None]
                .repeat(B, 0).astype(np.int32) if compact else None)
    rng = jax.random.key(11)

    def j_loss(c, m):
        return JE.point_sampled_mask_loss(
            c, m, (6, 5), jnp.asarray(id_map), jnp.asarray(valid),
            jnp.asarray(tgt), rng, **WEIGHTS, num_points=POINTS,
            factors=tuple(map(jnp.asarray, fac)) if factors else None,
            slot_ids=None if slot_ids is None else jnp.asarray(slot_ids))

    want, (g_cls, g_masks) = jax.jit(jax.value_and_grad(j_loss, (0, 1)))(
        jnp.asarray(cls), jnp.asarray(masks))
    c, m = _t(cls).requires_grad_(), _t(masks).requires_grad_()
    with PS.injected(_loss_draws(rng, K)):
        got = E.point_sampled_mask_loss(
            c, m, (6, 5), _t(id_map), _t(valid), _t(tgt), None, **WEIGHTS,
            num_points=POINTS, factors=tuple(map(_t, fac)) if factors
            else None, slot_ids=None if slot_ids is None else _t(slot_ids))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert _rel(c.grad.numpy(), g_cls) < 1e-4
    assert _rel(m.grad.numpy(), g_masks) < 1e-4


def test_mask_classification_loss_and_gradients_match_jax():
    K = 5
    cls, masks, _, _, valid, tgt = _loss_inputs(12, K)
    targets = (np.random.default_rng(13).uniform(size=(B, K, masks.shape[2]))
               < 0.4).astype(np.float32)

    def j_loss(c, m):
        return JE.mask_classification_loss(
            c, m, jnp.asarray(targets), jnp.asarray(valid), jnp.asarray(tgt),
            **WEIGHTS)

    want, (g_cls, g_masks) = jax.jit(jax.value_and_grad(j_loss, (0, 1)))(
        jnp.asarray(cls), jnp.asarray(masks))
    c, m = _t(cls).requires_grad_(), _t(masks).requires_grad_()
    got = E.mask_classification_loss(c, m, _t(targets), _t(valid), _t(tgt),
                                     **WEIGHTS)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert _rel(c.grad.numpy(), g_cls) < 1e-4
    assert _rel(m.grad.numpy(), g_masks) < 1e-4


MODEL_CASES = {
    # (backbone, task args, classes (slots) drawn in the masks)
    "compact": ("dinov2/vittest14", {"max_active_slots": 3}, 3),
    "all_slots": ("dinov3/vittest16", {"max_active_slots": None}, NC),
    "full_masks": ("dinov2/vittest14", {"use_point_sampling": False}, NC),
    # The instance model's full-mask path (``_targets_from_ids``).
    "instance_full_masks": ("dinov2/vittest14",
                            {"use_point_sampling": False, "max_instances": 5},
                            5),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_step_matches_jax(case):
    """A whole ``loss_fn`` (trunk, targets, compaction, every level's
    loss) and its gradients, at state step 5 of a 12-step run (the first
    joint block mid-anneal)."""
    name, extra, classes = MODEL_CASES[case]
    instance = case.startswith("instance")
    j_model, p_model, params, module, size = _models(name, instance, **extra)
    j_model.total_steps = p_model.total_steps = 12
    batch = (_instance_batch if instance else _batch)(size, 14, classes)
    rng = jax.random.key(15)

    def loss(p):
        return j_model.loss_fn(p, {}, {k: jnp.asarray(v) for k, v in
                                       batch.items()}, rng, jnp.int32(5))

    (want, (_, j_metrics)), j_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    rng_trunk, rng_loss, _ = jax.random.split(rng, 3)
    J = p_model.args.num_joint_blocks
    K = 3 if case == "compact" else NC
    draws = _trunk_draws(rng_trunk, J)
    if p_model.args.use_point_sampling:
        for li in range(J + 1):
            draws += _loss_draws(jax.random.fold_in(rng_loss, li), K)
    with PS.injected(draws):
        got, metrics = p_model.loss_fn(
            module, {k: _t(v) for k, v in batch.items()}, None, 5)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(metrics) == set(j_metrics)
    if not instance:
        np.testing.assert_allclose(metrics["loss_final"].item(),
                                   float(j_metrics["loss_final"]), rtol=1e-5)
    ref = task_state_from_jax(j_grads)
    for name_, p in module.named_parameters():
        if name_.endswith(("mask_token", "attn.k.bias")):
            continue  # no gradient (the mask token), or rounding noise
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert _rel(g.numpy(), ref[name_].numpy()) < 1e-4, name_


def test_validation_statistics_match_jax():
    j_model, p_model, params, module, size = _models("dinov2/vittest14")
    p_model.val_tile_size = j_model.val_tile_size = size
    batch = _batch(2 * size, 16)
    batch["valid"] = np.array([True, False])
    want = jax.jit(j_model.val_step)(
        params, {}, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = p_model.val_step(module, {k: _t(v) for k, v in batch.items()})
        logits = p_model._semantic_logits(module, _t(batch["images"]))
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  np.asarray(want["confusion"]))
    j_logits = j_model._semantic_logits(params, jnp.asarray(batch["images"]))
    assert _rel(logits.numpy(), j_logits) < 1e-5
    assert p_model.val_finalize(got) == pytest.approx(
        j_model.val_finalize(want), abs=1e-12)


# ---------------------------------------------------------------------------
# annealing, LLRD, groups, schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("windows", [None, ([2, 5, 5], [4, 9, 6])])
@pytest.mark.parametrize("annealing", [True, False])
def test_mask_probs_match_jax_at_the_window_edges(windows, annealing):
    extra = {"num_joint_blocks": 3, "attn_mask_annealing": annealing}
    if windows:
        extra.update(attn_mask_annealing_steps_start=windows[0],
                     attn_mask_annealing_steps_end=windows[1])
    j = JE.EoMTSemanticSegmentationTrainModel(
        jax_get_wrapped_model("dinov2/vits14"),
        JE.EoMTSemanticSegmentationArgs(**extra))
    p = E.EoMTSemanticSegmentationTrainModel(
        get_wrapped_model("dinov2/vits14"),
        E.EoMTSemanticSegmentationArgs(**extra))
    total = 23
    starts, ends = p._anneal_windows(total)
    edges = sorted({0, total} | {int(s) + d for s in (*starts, *ends)
                                 for d in (-1, 0, 1, 2)})
    for step in edges:
        got = p._mask_probs(step, total)
        want = np.asarray(j._mask_probs(jnp.asarray(step), total))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=str(step))


def test_llrd_groups_and_schedules_match_jax():
    j_model, p_model, params, module, _ = _models("dinov3/vittest16")
    named = dict(module.named_parameters())
    base_lr, total = 3e-4, 40
    j_scales = j_model.lr_scales(params)
    j_scheds, j_groups = j_model.lr_schedule_groups(base_lr, total, params)

    def by_name(tree):
        full = jax.tree_util.tree_map(
            lambda s, p: np.full(np.shape(p), s, np.float32), tree, params)
        return {n: float(v.reshape(-1)[0]) for n, v in
                task_state_from_jax(full).items()}

    scales, groups = by_name(j_scales), by_name(j_groups)
    assert set(scales) == set(named)
    p_scales = p_model.lr_scales(named)
    p_scheds, p_groups = p_model.lr_schedule_groups(base_lr, total, named)
    for n in named:
        assert p_scales[n] == pytest.approx(scales[n], rel=1e-6), n
        assert p_groups[n] == int(groups[n]), n
    assert {p_groups[n] for n in named} == {0, 1}
    p_model.args = p_model.args.__class__(
        **{**p_model.args.__dict__, "lr_warmup_steps": (5, 10)})
    j_model.args = j_model.args.model_copy(update={"lr_warmup_steps": (5, 10)})
    j_scheds, _ = j_model.lr_schedule_groups(base_lr, total, params)
    p_scheds, _ = p_model.lr_schedule_groups(base_lr, total, named)
    for step in range(total + 1):
        for p_s, j_s in zip(p_scheds, j_scheds):
            assert p_s(step) == pytest.approx(float(j_s(step)), rel=1e-6,
                                              abs=1e-12), step
        assert p_model.lr_schedule(base_lr, total)(step) == pytest.approx(
            float(j_model.lr_schedule(base_lr, total)(step)), rel=1e-6,
            abs=1e-12)
    assert p_model.scaled_lr(1e-4, 64) == pytest.approx(
        j_model.scaled_lr(1e-4, 64))
    assert p_model.grad_clip_norm() == j_model.grad_clip_norm() == 0.01
