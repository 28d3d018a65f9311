"""EoMT's instance and panoptic validation and its target resizes in the
port against the JAX package (``tasks/eomt_instance_panoptic.py``).

The two resizes of the slot-id map are held to ``jax.image.resize`` at
integer and non-integer ratios, shrinking and growing: the nearest one of
validation's ``tgt_map`` (half-pixel centres) and the antialiased linear
one of the full-mask targets (``_targets_from_ids``, and the semantic
``_targets_from_mask``), thresholded at 0.5: equal wherever JAX's sum is
not a half. A target edge halfway across a cell makes an exact half, which
JAX's float32 sums round to either side by their summation order; the
port's float64 sums count it as a half, off.

``val_step`` and ``val_finalize`` are held with planted class and mask
logits in place of the trunk's (``_query_outputs`` patched on both sides)
on slot-id maps of 30x26 at a mask grid of 8x8: each target slot has a
query whose mask is the slot's at the grid with some cells moved, some of
them of the wrong class, below the score threshold or duplicated at a
lower score; one query covers the void with a high score (PQ's void rule);
one valid slot is a pixel that the grid's nearest resize erases; one
sample is flagged invalid. The collected arrays are equal (the scores to
1e-6 relative), and mask mAP, mAP50 and PQ are equal and well above 0.
"""

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
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.tasks import eomt_instance_panoptic as IP
from lightly_train_tpu_torch.tasks import eomt_semantic_segmentation as E
from torch_fixtures.threads import one_torch_thread  # noqa: F401

NO_SEGMENT = IP.NO_SEGMENT
NC, Q, K = 4, 16, 7
HW, GRID = (30, 26), (8, 8)
# (map size, grid size): non-integer and integer ratios, both ways.
RESIZES = [((30, 26), (8, 8)), ((37, 41), (12, 9)), ((5, 7), (8, 8)),
           ((20, 6), (8, 8)), ((28, 28), (8, 8)), ((64, 48), (16, 16)),
           ((32, 32), (8, 8)), ((256, 224), (64, 64))]


def _slot_map(rng, hw, slots, blocks=6):
    """(2, H, W) slot ids in blocks, NO_SEGMENT where the id is >= slots."""
    ids = rng.integers(0, slots + 2, (2, blocks, blocks))
    cell = (-(-hw[0] // blocks), -(-hw[1] // blocks))
    m = np.kron(ids, np.ones(cell, int))[:, :hw[0], :hw[1]]
    return np.where(m >= slots, NO_SEGMENT, m).astype(np.int32)


@pytest.mark.parametrize("hw,grid", RESIZES)
def test_resize_ids_matches_jax_nearest(hw, grid):
    maps = np.random.default_rng(sum(hw)).integers(
        0, 256, (2, *hw)).astype(np.int32)
    want = jax.image.resize(jnp.asarray(maps, jnp.float32)[..., None],
                            (2, *grid, 1), "nearest")[..., 0]
    got = IP.resize_ids(torch.from_numpy(maps), grid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.int32))


def _held_off_halves(got, want, want_sums):
    """The targets equal where JAX's sum is not a half; where it is (a
    target edge halfway across a cell, which JAX's float32 sums round to
    either side by their order), the port's target is off."""
    half = np.abs(np.asarray(want_sums) - 0.5) < 1e-6
    np.testing.assert_array_equal(got[~half], np.asarray(want)[~half])
    assert not got[half].any()
    return half


@pytest.mark.parametrize("hw,grid", RESIZES)
def test_full_mask_targets_match_jax(hw, grid):
    """``_targets_from_ids`` (instance) and ``_targets_from_mask``
    (semantic): the binary targets and the flags."""
    rng = np.random.default_rng(sum(hw) + 1)
    ids = _slot_map(rng, hw, K)
    labels = rng.integers(0, NC, (2, K)).astype(np.int32)
    valid = rng.uniform(size=(2, K)) < 0.8
    B, n = 2, grid[0] * grid[1]
    onehot = jax.nn.one_hot(jnp.where(ids == NO_SEGMENT, K, ids), K + 1)
    sums = jax.image.resize(onehot[..., :K], (B, *grid, K), "linear")
    sums = np.asarray(sums).transpose(0, 3, 1, 2).reshape(B, K, n)
    j_model, p_model = _models("instance")
    want, want_valid = j_model._targets_from_ids(
        jnp.asarray(ids), jnp.asarray(labels), jnp.asarray(valid), grid)
    got, got_valid = p_model._targets_from_ids(
        torch.from_numpy(ids), torch.from_numpy(labels),
        torch.from_numpy(valid), grid)
    half = _held_off_halves(got.numpy(), want, sums)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert 0 < float(np.asarray(want).mean()) < 1
    assert half.mean() < 0.05

    masks = np.where(ids == NO_SEGMENT, 255, ids % NC).astype(np.int32)
    j_model, p_model = _models("semantic")
    onehot = jax.nn.one_hot(jnp.where(masks == 255, NC, masks), NC + 1)
    sums = jax.image.resize(onehot[..., :NC], (B, *grid, NC), "linear")
    sums = np.asarray(sums).transpose(0, 3, 1, 2).reshape(B, NC, n)
    want, want_valid = j_model._targets_from_mask(jnp.asarray(masks), grid)
    got, got_valid = p_model._targets_from_mask(torch.from_numpy(masks), grid)
    _held_off_halves(got.numpy(), want, sums)
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


def test_full_mask_targets_at_an_even_ratio_have_halves():
    """At 32^2 -> 8^2 (a ratio of 4) the blocks' edges fall halfway across
    cells: the exact halves are off, as JAX's are where its sums round to
    0.5."""
    ids = np.full((1, 32, 32), NO_SEGMENT, np.int32)
    ids[0, :, :6] = 0  # columns 0-5: cell 1 (columns 2-9) half covered
    got, _ = _models("instance")[1]._targets_from_ids(
        torch.from_numpy(ids), torch.zeros(1, 1, dtype=torch.int32),
        torch.ones(1, 1, dtype=torch.bool), (8, 8))
    sums = jax.image.resize(jnp.asarray(ids == 0, jnp.float32)[..., None],
                            (1, 8, 8, 1), "linear")[0, :, :, 0]
    assert np.asarray(sums)[:, 1] == pytest.approx(0.5, abs=1e-6)
    got = got.reshape(8, 8).numpy()
    assert got[:, 0].all() and not got[:, 1:].any()


MODELS = {
    "semantic": ((JE.EoMTSemanticSegmentationTrainModel,
                  JE.EoMTSemanticSegmentationArgs),
                 (E.EoMTSemanticSegmentationTrainModel,
                  E.EoMTSemanticSegmentationArgs), {}),
    "instance": ((JIP.EoMTInstanceSegmentationTrainModel,
                  JIP.EoMTInstanceSegmentationArgs),
                 (IP.EoMTInstanceSegmentationTrainModel,
                  IP.EoMTInstanceSegmentationArgs), {"max_instances": K}),
    "panoptic": ((JIP.EoMTPanopticSegmentationTrainModel,
                  JIP.EoMTPanopticSegmentationArgs),
                 (IP.EoMTPanopticSegmentationTrainModel,
                  IP.EoMTPanopticSegmentationArgs), {"max_instances": K}),
}


def _models(kind: str):
    (j_model, j_args), (p_model, p_args), extra = MODELS[kind]
    args = dict(num_classes=NC, num_queries=Q, **extra)
    return (j_model(jax_get_wrapped_model("dinov2/vittest14",
                                          dtype=jnp.float32), j_args(**args)),
            p_model(get_wrapped_model("dinov2/vittest14"), p_args(**args)))


def _planted(seed):
    """A batch of 3 slot-id maps and the planted (cls, mask) logits."""
    rng = np.random.default_rng(seed)
    B = 3
    seg = np.full((B, *HW), NO_SEGMENT, np.int32)
    for b in range(B):
        for k, (y, x, h, w) in enumerate([(2, 1, 12, 10), (2, 13, 12, 12),
                                          (16, 1, 12, 8), (16, 11, 8, 14),
                                          (25, 10, 5, 10)]):
            dy, dx = rng.integers(-1, 2, 2)
            seg[b, max(y + dy, 1):y + dy + h, max(x + dx, 1):x + dx + w] = k
        seg[b, 0, 0] = 5  # a valid slot no grid cell samples: erased
        seg[b, 29, 25] = 6  # present, but flagged invalid
    labels = rng.integers(0, NC, (B, K)).astype(np.int32)
    valid = np.ones((B, K), bool)
    valid[:, 6] = False
    grid = np.asarray(jax.image.resize(
        jnp.asarray(seg, jnp.float32)[..., None], (B, *GRID, 1),
        "nearest")[..., 0]).astype(np.int32).reshape(B, -1)
    assert not (grid == 5).any()

    n = GRID[0] * GRID[1]
    owner = np.full((B, n), -1)
    cls = rng.uniform(-1, 1, (B, Q, NC + 1)).astype(np.float32)
    for b in range(B):
        for k in range(5):
            cells = np.flatnonzero(grid[b] == k)
            if not len(cells):
                continue
            # Query k: slot k's cells, some moved to a neighbouring slot or
            # the void; classes right (score ~0.98) except query 3 (the
            # wrong class) and query 4 (score below 0.5).
            keep = rng.uniform(size=len(cells)) > rng.uniform(0, 0.3)
            owner[b, cells[keep]] = k
            cls[b, k, labels[b, k]] = 6.0 if k != 4 else 1.2
            if k == 3:
                cls[b, k, labels[b, k]] = -2.0
                cls[b, k, (labels[b, k] + 1) % NC] = 6.0
        # Query 5: the void cells, with a high score.
        void = np.flatnonzero((grid[b] == NO_SEGMENT) & (owner[b] < 0))
        owner[b, void] = 5
        cls[b, 5, 0] = 6.0
    masks = rng.uniform(-1, 1, (B, Q, n)).astype(np.float32) - 6.0
    for b in range(B):
        for q in range(Q):
            masks[b, q, owner[b] == q] += 12.0
    # Query 6: query 0's mask again at a lower score (a duplicate).
    masks[:, 6] = masks[:, 0] - 0.5
    cls[:, 6] = cls[:, 0] - np.array([0, 0, 0, 0, 2.5], np.float32)
    cls[:, 6, labels[:, 0]] -= 1.0
    batch = {"images": np.zeros((B, *HW, 3), np.float32), "seg_map": seg,
             "seg_labels": labels, "seg_valid": valid,
             "valid": np.array([True, True, False])}
    return batch, cls, masks


def _collect(kind: str):
    j_model, p_model = _models(kind)
    j_out, p_out = [], []
    for seed in (0, 1):
        batch, cls, masks = _planted(seed)
        j_model._query_outputs = lambda params, images: (
            jnp.asarray(cls), jnp.asarray(masks), GRID)
        p_model._query_outputs = lambda model, images: (
            torch.from_numpy(cls), torch.from_numpy(masks), GRID)
        j_out.append(j_model.val_step(
            None, {}, {k: jnp.asarray(v) for k, v in batch.items()}))
        with torch.no_grad():
            p_out.append(p_model.val_step(
                None, {k: torch.from_numpy(v) for k, v in batch.items()}))
    for j, p in zip(j_out, p_out):
        assert set(j) == set(p)
        for key, want in j.items():
            got = p[key].numpy()
            if key == "pred_scores":
                np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, np.asarray(want), key)
        # The erased slot is valid and in the map, and gone from the grid.
        assert not (np.asarray(j["tgt_map"]) == 5).any()
    return j_model, p_model, j_out, p_out


def test_instance_validation_matches_jax():
    j_model, p_model, j_out, p_out = _collect("instance")
    want = j_model.val_finalize(j_out)
    got = p_model.val_finalize(p_out)
    assert set(got) == set(want) == {"val_mask_map", "val_mask_map50"}
    for key, value in want.items():
        assert got[key] == pytest.approx(value, abs=1e-12), key
    assert 0.1 < want["val_mask_map"] < 1.0
    assert 0.1 < want["val_mask_map50"] <= 1.0


def test_panoptic_validation_matches_jax():
    j_model, p_model, j_out, p_out = _collect("panoptic")
    # The void query wins cells with a score above the threshold: the void
    # rule decides whether it counts.
    for out in j_out:
        qmap = np.asarray(out["pred_query_map"])
        tmap = np.asarray(out["tgt_map"]).reshape(qmap.shape)
        wins = qmap == 5
        assert wins.any() and (tmap[wins] == NO_SEGMENT).mean() > 0.5
        assert (np.asarray(out["pred_scores"])[:, 5] > 0.5).all()
    want = j_model.val_finalize(j_out)
    got = p_model.val_finalize(p_out)
    assert set(got) == set(want) == {"val_pq"}
    assert got["val_pq"] == pytest.approx(want["val_pq"], abs=1e-12)
    assert 0.1 < want["val_pq"] < 1.0

