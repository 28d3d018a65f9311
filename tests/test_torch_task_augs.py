"""The fine-tuning tasks' data path in the port against the JAX package:
``ops/task_augs.py``, the transform schemas and pipeline
(``_transforms/task_transforms.py``), tiling and the logits resize, the
mask dataset and the task loaders.

Random draws cannot match (jax.random against torch generators), so each
port applier is fed the JAX package's own draws, taken with the JAX
function's key splits; the port's samplers are checked by bounds. Images in
[0, 1] float32 agree within 1e-5 (the colour jitter's composed matrix
within 2e-5); id maps and masks exactly.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu._commands import train_task as JTT
from lightly_train_tpu._data import task_loader as JLOAD
from lightly_train_tpu._transforms import task_transforms as JTF
from lightly_train_tpu.ops import task_augs as JT
from lightly_train_tpu.tasks import semantic_segmentation_linear as JSEG
from lightly_train_tpu.tasks import tiling as JTILE
from lightly_train_tpu_torch._commands import train_task as TT
from lightly_train_tpu_torch._data import loader as PLOAD
from lightly_train_tpu_torch._data import task_loader as LOAD
from lightly_train_tpu_torch._transforms import task_transforms as TF
from lightly_train_tpu_torch.errors import (
    ConfigError,
    ConfigUnknownKeyError,
    ConfigValidationError,
)
from lightly_train_tpu_torch.ops import task_augs as T
from lightly_train_tpu_torch.tasks import semantic_segmentation_linear as SEG
from lightly_train_tpu_torch.tasks import tiling as TILE
from torch_fixtures.threads import one_torch_thread  # noqa: F401

B, H, W = 6, 20, 20


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed, shape=(B, H, W, 3)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _maps(seed, shape=(B, H, W), high=5):
    return np.random.default_rng(seed).integers(0, high, shape).astype(
        np.int32)


def _u(key, shape=(B,), lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


# ---------------------------------------------------------------------------
# ops/task_augs.py
# ---------------------------------------------------------------------------

# Boxes reaching past every edge (zoom-out), inside, and one-pixel thin.
BOXES = (np.array([-6.0, 0.0, 3.3, -2.5, 10.0, 0.2], np.float32),
         np.array([-4.0, 1.5, 0.0, 7.25, -10.0, 19.0], np.float32),
         np.array([32.0, 12.0, 9.7, 30.0, 5.0, 1.0], np.float32),
         np.array([28.0, 17.5, 20.0, 11.0, 40.0, 1.0], np.float32))
FLIPS = np.array([True, False, True, False, True, False])


@pytest.mark.parametrize("fill", [0.0, 0.5])
@pytest.mark.parametrize("flips", ["none", "h", "hv"])
def test_padded_crop_resize_matches_jax(fill, flips):
    images = _images(0).astype(np.float32) / 255.0
    hf = FLIPS if "h" in flips else None
    vf = ~FLIPS if "v" in flips else None
    want = JT.padded_crop_resize(
        jnp.asarray(images), *map(jnp.asarray, BOXES), (16, 12), fill=fill,
        hflip=None if hf is None else jnp.asarray(hf),
        vflip=None if vf is None else jnp.asarray(vf))
    got = T.padded_crop_resize(
        _t(images), *map(_t, BOXES), (16, 12), fill=fill,
        hflip=None if hf is None else _t(hf),
        vflip=None if vf is None else _t(vf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("flips", ["none", "hv"])
def test_padded_crop_resize_nearest_matches_jax(flips):
    maps = _maps(1)
    hf = FLIPS if flips == "hv" else None
    kw = {} if hf is None else {"hflip": hf, "vflip": ~hf}
    want = JT.padded_crop_resize_nearest(
        jnp.asarray(maps), *map(jnp.asarray, BOXES), (16, 12), fill=255,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = T.padded_crop_resize_nearest(
        _t(maps), *map(_t, BOXES), (16, 12), fill=255,
        **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 255).any() and got.dtype == torch.int32


def _jax_rot90_k(key, prob):
    k_apply, k_k = jax.random.split(key)
    apply = _u(k_apply) < prob
    return jnp.where(apply, jax.random.randint(k_k, (B,), 1, 4), 0)


def test_rot90_matches_jax_on_its_draw():
    images = _images(2).astype(np.float32)
    maps = [_maps(3), _maps(4)]
    key = jax.random.key(5)
    want_img, want_maps = JT.random_rot90(
        key, 0.9, jnp.asarray(images), [jnp.asarray(m) for m in maps])
    k = _jax_rot90_k(key, 0.9)
    assert len(set(np.asarray(k).tolist())) > 1
    got_img, got_maps = T.rot90_with(_t(images), _t(k),
                                     [_t(m) for m in maps])
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    for g, w in zip(got_maps, want_maps):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="square"):
        T.rot90_with(torch.zeros(2, 4, 6, 3), torch.zeros(2, dtype=int))


@pytest.mark.parametrize("pad_if_needed", [True, False])
def test_scale_jitter_boxes_match_jax_on_its_draws(pad_if_needed):
    key = jax.random.key(7)
    args = ((H, W), (12, 12), 0.5, 2.0, 7, 0.7)
    want = JT.sample_scale_jitter_crop(key, B, *args, crop_prob=0.6,
                                       pad_if_needed=pad_if_needed)
    k_s, k_apply, k_y, k_x, k_crop = jax.random.split(key, 5)
    scales = jnp.linspace(0.5, 2.0, 7)
    s = scales[jax.random.randint(k_s, (B,), 0, 7)]
    got = T.scale_jitter_crop_boxes(
        _t(s), _t(_u(k_apply) < 0.7), _t(_u(k_y)), _t(_u(k_x)),
        _t(_u(k_crop) >= 0.6), (H, W), (12, 12), pad_if_needed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)


def test_random_resized_crop_boxes_match_jax_on_its_draws():
    key = jax.random.key(8)
    want = JT.sample_random_resized_crop(key, B, (H, W), 0.2, 1.0)
    k_a, k_r, k_y, k_x = jax.random.split(key, 4)
    got = T.random_resized_crop_boxes(
        _t(_u(k_a, lo=0.2, hi=1.0)),
        _t(_u(k_r, lo=math.log(3 / 4), hi=math.log(4 / 3))),
        _t(_u(k_y)), _t(_u(k_x)), (H, W))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_samplers_stay_in_their_bounds():
    g = torch.Generator().manual_seed(0)
    y0, x0, h, w = T.sample_random_resized_crop(g, 4096, (H, W), 0.2, 1.0)
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + h <= H + 1e-4).all() and (x0 + w <= W + 1e-4).all()
    assert (h >= 1).all() and (w >= 1).all()
    y0, x0, h, w = T.sample_scale_jitter_crop(g, 4096, (H, W), (H, W), 0.5,
                                              2.0, 20)
    # Windows of H / s for the 20 scales; zoom-out windows centred.
    scales = H / h
    grid = torch.tensor(np.linspace(0.5, 2.0, 20), dtype=torch.float32)
    assert torch.isclose(scales[:, None], grid, rtol=1e-5).any(1).all()
    assert len(torch.unique(torch.round(scales * 1e4))) == 20
    out = scales < 1
    torch.testing.assert_close(y0[out], -(h[out] - H) / 2)
    k = T.sample_rot90(g, 4096, 0.5)
    frac = (k > 0).float().mean().item()
    assert abs(frac - 0.5) < 0.05 and set(k.tolist()) == {0, 1, 2, 3}


def test_rotate_maps_match_jax_on_its_draw():
    from lightly_train_tpu.ops import augment as JA
    from lightly_train_tpu_torch.ops import augment as A

    images = _images(9).astype(np.float32) / 255.0
    maps = [_maps(10)]
    key = jax.random.key(11)
    want_img, want_maps = JA.random_rotate(key, jnp.asarray(images), 0.8,
                                           30.0, maps=[jnp.asarray(maps[0])])
    k_apply, k_angle = jax.random.split(key)
    apply = _u(k_apply) < 0.8
    angle = jnp.where(apply, _u(k_angle, lo=-30.0, hi=30.0) * (jnp.pi / 180),
                      0.0)
    got_img = A.random_rotate_with(_t(images), _t(apply), _t(angle))
    got_maps = T.rotate_maps_with([_t(maps[0])], _t(apply), _t(angle))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=1e-5)
    np.testing.assert_array_equal(got_maps[0].numpy(),
                                  np.asarray(want_maps[0]))


# ---------------------------------------------------------------------------
# _transforms/task_transforms.py
# ---------------------------------------------------------------------------

SCHEMAS = {
    "seg_defaults": ("semantic_segmentation", {}, None),
    "seg_overrides": ("semantic_segmentation", {
        "image_size": [16, 16], "ignore_index": 7,
        "scale_jitter": {"min_scale": 0.8, "num_scales": 3},
        "random_crop": {"fill": 12, "pad_if_needed": False, "prob": 0.5},
        "random_flip": {"vertical_prob": 0.3},
        "random_rotate_90": {"prob": 0.7},
        "random_rotate": {"degrees": 20},
        "normalize": {"mean": [0.5], "std": [0.25]}}, None),
    "seg_smallest": ("semantic_segmentation", {
        "smallest_max_size": {"prob": 0.6}, "color_jitter": None}, 0.0),
    "cls_defaults": ("image_classification", {}, None),
    "cls_overrides": ("image_classification", {
        "random_crop": {"min_scale": 0.5}, "color_jitter": {"prob": 1.0},
        "random_rotate_90": {"prob": 1.0}}, 0.25),
    "cls_resize_scale": ("image_classification", {
        "random_crop": None, "resize_scale": 1.25,
        "random_flip": {"horizontal_prob": 0.5, "vertical_prob": 0.5}},
        None),
    "cls_no_crop": ("image_classification", {
        "random_crop": None,
        "random_flip": {"horizontal_prob": 0.5, "vertical_prob": 0.5}},
        None),
}


@pytest.mark.parametrize("case", sorted(SCHEMAS))
def test_resolved_schema_dumps_equal(case):
    kind, user, hflip = SCHEMAS[case]
    want = JTF.resolve_task_transform_args(kind, user, (H, W), hflip)
    got = TF.resolve_task_transform_args(kind, user, (H, W), hflip)
    assert got.model_dump() == want.model_dump()


@pytest.mark.parametrize("case", ["unknown_key", "unknown_nested_key",
                                  "crop_not_image_size", "bad_type"])
def test_schema_errors_match_jax(case):
    kind, user = {
        "unknown_key": ("semantic_segmentation", {"scale_jiter": None}),
        "unknown_nested_key": ("image_classification",
                               {"random_flip": {"horizontal": 0.5}}),
        "crop_not_image_size": ("semantic_segmentation",
                                {"random_crop": {"height": 8}}),
        "bad_type": ("image_classification",
                     {"color_jitter": {"prob": "often"}}),
    }[case]
    errors = []
    for module in (JTF, TF):
        with pytest.raises(Exception) as err:
            module.resolve_task_transform_args(kind, user, (H, W))
        errors.append(err.value)
    assert type(errors[0]).__name__ == type(errors[1]).__name__
    assert isinstance(errors[1], (ConfigUnknownKeyError,
                                  ConfigValidationError))


def test_channel_drop_is_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP item 19"):
        TF.resolve_task_transform_args(
            "image_classification", {"channel_drop": {}}, (H, W))


def _jax_params(args, key, batch_u8):
    """The parameters the JAX transform ``fn(batch, key)`` draws, with its
    key splits, in the port's form."""
    keys = jax.random.split(key, 8)
    Bn, Hn, Wn = batch_u8.shape[:3]
    p = {"hflip": None, "vflip": None, "boxes": None, "rot90": None,
         "rotate": None, "jitter": None}
    flip = args.random_flip
    if flip is not None and flip.horizontal_prob > 0:
        p["hflip"] = _t(_u(keys[1], (Bn,)) < flip.horizontal_prob)
    if flip is not None and flip.vertical_prob > 0:
        p["vflip"] = _t(_u(keys[2], (Bn,)) < flip.vertical_prob)
    crop = getattr(args, "random_crop", None)
    sj = getattr(args, "scale_jitter", None)
    smallest = getattr(args, "smallest_max_size", None)
    if isinstance(args, JTF.ImageClassificationTransformArgs):
        if crop is not None:
            p["boxes"] = tuple(_t(b) for b in JT.sample_random_resized_crop(
                keys[3], Bn, (Hn, Wn), crop.min_scale, crop.max_scale))
    elif smallest is not None:
        k_a, k_y, k_x, k_c = jax.random.split(keys[3], 4)
        p["smallest"] = (_t(_u(k_a, (Bn,)) < smallest.prob),
                         _t(_u(k_y, (Bn,))), _t(_u(k_x, (Bn,))),
                         _t(_u(k_c, (Bn,)) >= crop.prob)
                         if crop is not None and crop.prob < 1.0 else None)
    elif sj is not None or crop is not None:
        sj = sj or JTF.ScaleJitterArgs(min_scale=1.0, max_scale=1.0,
                                       num_scales=1, prob=0.0)
        p["boxes"] = tuple(_t(b) for b in JT.sample_scale_jitter_crop(
            keys[3], Bn, (Hn, Wn), tuple(args.image_size), sj.min_scale,
            sj.max_scale, sj.num_scales, sj.prob,
            crop_prob=crop.prob if crop else 1.0,
            pad_if_needed=crop.pad_if_needed if crop else True))
    if args.random_rotate_90 is not None and args.random_rotate_90.prob > 0:
        k_apply, k_k = jax.random.split(keys[4])
        apply = _u(k_apply, (Bn,)) < args.random_rotate_90.prob
        p["rot90"] = _t(jnp.where(apply, jax.random.randint(
            k_k, (Bn,), 1, 4), 0))
    rot = args.random_rotate
    if rot is not None and rot.prob > 0:
        k_apply, k_angle = jax.random.split(keys[5])
        apply = _u(k_apply, (Bn,)) < rot.prob
        angle = jnp.where(apply, _u(k_angle, (Bn,), -rot.degrees,
                                    rot.degrees) * (jnp.pi / 180), 0.0)
        p["rotate"] = {"rotate": _t(apply), "rotate_angle": _t(angle)}
    cj = args.color_jitter
    if cj is not None:
        k_apply, kb, kc, ks, kh = jax.random.split(keys[6], 5)
        s = cj.strength

        def factor(k, v):
            return _t(_u(k, (Bn,), max(0.0, 1.0 - s * v), 1.0 + s * v))

        p["jitter"] = {
            "apply": _t(_u(k_apply, (Bn, 1, 1, 1)) < cj.prob).reshape(Bn),
            "fb": factor(kb, cj.brightness), "fc": factor(kc, cj.contrast),
            "fs": factor(ks, cj.saturation),
            "theta": _t(_u(kh, (Bn,), -s * cj.hue, s * cj.hue) * 2 * jnp.pi)}
    return p


@pytest.mark.parametrize("case", sorted(SCHEMAS))
@pytest.mark.parametrize("seed", [0, 1])
def test_train_transform_matches_jax_on_its_draws(case, seed):
    kind, user, hflip = SCHEMAS[case]
    j_args = JTF.resolve_task_transform_args(kind, user, (12, 12), hflip)
    p_args = TF.resolve_task_transform_args(kind, user, (12, 12), hflip)
    images = _images(20 + seed)
    batch = {"images": images}
    if kind == "semantic_segmentation":
        batch["masks"] = _maps(30 + seed)
    key = jax.random.key(40 + seed)
    want = JTF.build_train_transform(j_args, jnp.float32)(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    fn = TF.build_train_transform(p_args, torch.float32)
    params = _jax_params(j_args, key, images)
    if "smallest" in params:
        params["boxes"] = fn._smallest_boxes(*params.pop("smallest"), H, W)
    got = fn.apply({k: _t(v) for k, v in batch.items()}, params)
    assert got["images"].shape == tuple(want["images"].shape)
    np.testing.assert_allclose(got["images"].numpy(),
                               np.asarray(want["images"]), atol=2e-5)
    if "masks" in batch:
        np.testing.assert_array_equal(got["masks"].numpy(),
                                      np.asarray(want["masks"]))


def test_train_transform_samples_and_applies():
    args = TF.resolve_task_transform_args(
        "semantic_segmentation", {"random_rotate_90": {"prob": 0.5},
                                  "random_rotate": {"prob": 0.5}}, (12, 12))
    fn = TF.build_train_transform(args, torch.bfloat16)
    batch = {"images": _t(_images(50)), "masks": _t(_maps(51))}
    out = fn(batch, torch.Generator().manual_seed(0))
    again = fn(batch, torch.Generator().manual_seed(0))
    assert out["images"].dtype == torch.bfloat16
    assert out["images"].shape == (B, 12, 12, 3)
    assert out["masks"].shape == (B, 12, 12)
    assert torch.equal(out["images"], again["images"])
    assert set(torch.unique(out["masks"]).tolist()) <= set(range(5)) | {255}


# ---------------------------------------------------------------------------
# tiling and the logits resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extent,tile,stride", [(56, 28, 18), (448, 224, 149),
                                                (30, 28, 18), (20, 28, 18)])
def test_tile_grid_matches_jax(extent, tile, stride):
    assert TILE.tile_grid(extent, tile, stride) == JTILE.tile_grid(
        extent, tile, stride)
    assert TILE.n_tiles((extent, extent + 3), tile) == JTILE.n_tiles(
        (extent, extent + 3), tile)
    assert TILE.n_tiles((448, 448), 224) == 9


def test_tiled_logits_match_jax():
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, 50, 44, 3)).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)

    def j_fn(t):
        return jnp.tanh(t) @ jnp.asarray(w) + t.shape[1] * 0.01

    def p_fn(t):
        return torch.tanh(t) @ _t(w) + t.shape[1] * 0.01

    want = JTILE.tiled_logits(j_fn, jnp.asarray(images), 4, 24)
    got = TILE.tiled_logits(p_fn, _t(images), 4, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("src,dst", [((2, 2), (28, 28)), ((4, 3), (56, 45)),
                                     ((16, 16), (224, 224)),
                                     ((7, 5), (9, 13)), ((16, 12), (5, 7)),
                                     ((9, 9), (4, 4))])
def test_logits_resize_matches_jax_image_resize(src, dst):
    """Both directions: up (the reachable one, features are coarser than
    the image; the border rows included) and down (antialiased)."""
    logits = np.random.default_rng(4).standard_normal(
        (2, *src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(logits), (2, *dst, 3), "bilinear")
    got = SEG.resize_bilinear(_t(logits), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# the mask dataset and the loaders
# ---------------------------------------------------------------------------


def _write_masks(folder, rng):
    """Masks in the modes a user hands in: palette, 8-bit gray, RGB (read
    through convert("L")) and 16-bit gray, at sizes that resize."""
    from PIL import Image

    (folder / "images").mkdir(parents=True)
    (folder / "masks").mkdir()
    ids = rng.integers(0, 6, (30, 26))
    ids[0, :] = 200  # beyond the LUT's listed classes
    modes = {
        "p": Image.fromarray(ids.astype(np.uint8), "P"),
        "l": Image.fromarray(ids.astype(np.uint8), "L"),
        "rgb": Image.fromarray(np.stack([ids * 40 % 256] * 3, -1).astype(
            np.uint8), "RGB"),
        "i16": Image.fromarray((ids * 1000).astype(np.uint16)),
    }
    modes["p"].putpalette(list(rng.integers(0, 256, 768)))
    for stem, im in modes.items():
        im.save(folder / "masks" / f"{stem}.png")
        Image.fromarray(rng.integers(0, 256, (30, 26, 3), np.uint8)).save(
            folder / "images" / f"{stem}.png")
    (folder / "images" / "orphan.png").write_bytes(
        (folder / "images" / "p.png").read_bytes())


@pytest.mark.parametrize("lut", [False, True])
def test_mask_dataset_matches_jax(tmp_path, monkeypatch, lut):
    """Each mode, with and without a class LUT, against the JAX dataset;
    the port with PIL blocked."""
    import builtins
    import sys

    _write_masks(tmp_path, np.random.default_rng(0))
    data = ({"classes": {0: "a", 2: "b", 3: "c", 5: "d"},
             "ignore_classes": [3]} if lut else {"num_classes": 6})
    j_n, j_lut = JTT._resolve_mask_classes(data)
    n, p_lut = TT._resolve_mask_classes(data)
    assert n == j_n
    assert (p_lut is None) == (j_lut is None)
    if lut:
        np.testing.assert_array_equal(p_lut, j_lut)
    j_ds = JSEG.MaskSemanticSegmentationDataset(
        tmp_path / "images", tmp_path / "masks", (17, 21), class_lut=j_lut)
    want = [j_ds[i] for i in range(len(j_ds))]
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL blocked")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    got = SEG.MaskSemanticSegmentationDataset(
        tmp_path / "images", tmp_path / "masks", (17, 21), class_lut=p_lut)
    assert len(got) == len(want) == 4
    for i, w in enumerate(want):
        g = got[i]
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["masks"], w["masks"])
        assert g["masks"].dtype == np.int32


def test_mask_classes_without_any_left_are_refused():
    with pytest.raises(Exception, match="left no classes"):
        TT._resolve_mask_classes({"classes": {1: "a"}, "ignore_classes": [1]})


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"images": np.full((2, 2, 3), i, np.uint8),
                "labels": np.int32(i)}


@pytest.mark.parametrize("n,batch,start", [(20, 8, 0), (20, 8, 5),
                                           (5, 8, 3), (16, 8, 2)])
def test_train_index_stream_matches_jax(n, batch, start):
    """The same images in the same order, resumed runs included (the JAX
    loader is read through its index generator alone)."""
    j_loader = JLOAD.TaskTrainLoader.__new__(JLOAD.TaskTrainLoader)
    j_loader.dataset, j_loader.global_batch_size = _Items(n), batch
    j_loader.local_batch_size, j_loader.seed = batch, 3
    j_loader.start_step = start
    want = [next(it) for it in [j_loader._indices()] for _ in range(7)]
    p_loader = PLOAD.PretrainLoader(_Items(n), batch, "cpu", seed=3,
                                    num_workers=2)
    p_loader.start_step = start
    got = [next(it) for it in [p_loader._index_stream()] for _ in range(7)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    first = next(iter(p_loader))
    np.testing.assert_array_equal(first["labels"].numpy(), want[0])


def test_val_loader_pads_with_valid_flags():
    batches = list(LOAD.TaskValLoader(_Items(11), 4, "cpu", num_workers=2))
    assert [b["labels"].tolist() for b in batches] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 0]]
    assert batches[-1]["valid"].tolist() == [True, True, True, False]
    assert all(b["valid"].dtype == torch.bool for b in batches)


def test_shared_transforms_match_jax_on_its_draw():
    """The flip-and-normalize transform of a task without a schema (joint
    with masks and cxcywh boxes) and the validation normalization."""
    rng = np.random.default_rng(60)
    batch = {"images": _images(61), "masks": _maps(62),
             "boxes": rng.uniform(0, 1, (B, 3, 4)).astype(np.float32)}
    key = jax.random.key(63)
    want = JTT._device_train_transform(
        {k: jnp.asarray(v) for k, v in batch.items()}, key, 0.5, jnp.float32)
    flip = _t(_u(key, (B, 1, 1, 1)) < 0.5).reshape(B)
    assert 0 < int(flip.sum()) < B
    got = TT._device_train_transform({k: _t(v) for k, v in batch.items()},
                                     flip, torch.float32)
    for key_ in batch:
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]),
                                   atol=1e-6, err_msg=key_)
    _assert_val_transform_matches(batch)


@pytest.mark.parametrize("hflip", [0.0, 1.0])
def test_build_transform_of_a_task_without_a_schema(hflip):
    """``_build_transform`` of a task whose ``transform_kind`` is None
    (detection's) flips every sample or none, joint with its masks, seg
    maps and boxes, as the JAX package's fallback does at those
    probabilities, and refuses ``transform_args``."""
    rng = np.random.default_rng(64)
    batch = {"images": _images(65), "masks": _maps(66),
             "seg_map": _maps(67),
             "boxes": rng.uniform(0, 1, (B, 3, 4)).astype(np.float32)}
    want = JTT._device_train_transform(
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(68),
        hflip, jnp.float32)
    model = types.SimpleNamespace(transform_kind=None, task="detection")
    config = TT.TrainTaskConfig(out="o", model="m", hflip_prob=hflip)
    got = TT._build_transform(config, model, torch.float32)(
        {k: _t(v) for k, v in batch.items()}, torch.Generator())
    for key_ in batch:
        np.testing.assert_allclose(got[key_].numpy(), np.asarray(want[key_]),
                                   atol=1e-6, err_msg=key_)
    config = TT.TrainTaskConfig(out="o", model="m",
                                transform_args={"image_size": [8, 8]})
    with pytest.raises(ConfigError, match="transform_args is not supported"):
        TT._build_transform(config, model, torch.float32)


def _assert_val_transform_matches(batch):
    want = JTT._device_val_transform({"images": jnp.asarray(batch["images"])},
                                     jnp.float32)
    got = TT._device_val_transform({"images": _t(batch["images"])},
                                   torch.float32)
    np.testing.assert_allclose(got["images"].numpy(),
                               np.asarray(want["images"]), atol=1e-6)
