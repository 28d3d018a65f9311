"""The port's augmentation ops against the JAX package's, on identical
sampled parameters.

``jax.random`` and ``torch.Generator`` draw different numbers, so each test
reproduces the JAX op's own key splits to get the parameters it samples and
feeds those to the port's deterministic ``*_with`` function. The port's
samplers are checked by bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.ops import augment as JA
from lightly_train_tpu.ops import masking as JM
from lightly_train_tpu_torch.ops import augment as TA
from lightly_train_tpu_torch.ops import masking as TM

B = 4


def _images(seed, shape=(B, 20, 24, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _u(key, shape, lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _t(x):
    return torch.tensor(np.asarray(x))


def test_crop_boxes_in_bounds():
    gen = torch.Generator().manual_seed(0)
    y0, x0, h, w = TA._sample_crop_boxes(gen, 256, (60, 80), (0.05, 0.32),
                                         (3 / 4, 4 / 3))
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + h <= 60 + 1e-4).all() and (x0 + w <= 80 + 1e-4).all()
    assert (h >= 1).all() and (w >= 1).all()
    area = h * w / (60 * 80)
    assert area.min() >= 0.05 * 0.7 and area.max() <= 0.32 * 1.01


@pytest.mark.parametrize("method", ["area", "bilinear"])
def test_crop_resize_matches_jax(method):
    imgs = (_images(1, (B, 40, 36, 3)) * 255).astype(np.uint8)
    key = jax.random.key(3)
    y0, x0, h, w = JA._sample_crop_boxes(key, B, (40, 36), (0.05, 1.0),
                                         (3 / 4, 4 / 3))
    hflip = np.array([True, False, True, False])
    for out_hw in [(16, 12), (64, 56)]:  # down- and upscaling
        ref = JA.crop_resize_matmul(jnp.asarray(imgs), y0, x0, h, w, out_hw,
                                    hflip=jnp.asarray(hflip), method=method)
        got = TA.crop_resize_matmul(torch.tensor(imgs), _t(y0), _t(x0), _t(h),
                                    _t(w), out_hw, hflip=torch.tensor(hflip),
                                    method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-3)


def test_flip_matches_jax():
    imgs = _images(2)
    key = jax.random.key(4)
    ref = JA.random_flip(key, jnp.asarray(imgs), 0.5, 0.5)
    kh, kv = jax.random.split(key)
    do_h = _u(kh, (B, 1, 1, 1)) < 0.5
    do_v = _u(kv, (B, 1, 1, 1)) < 0.5
    got = TA.flip_with(torch.tensor(imgs), _t(do_h).reshape(B),
                       _t(do_v).reshape(B))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_color_jitter_matches_jax():
    imgs = _images(5)
    key = jax.random.key(5)
    kw = dict(prob=0.8, strength=0.5, brightness=0.8, contrast=0.8,
              saturation=0.4, hue=0.2)
    ref = JA.color_jitter(key, jnp.asarray(imgs), **kw)
    k_apply, kb, kc, ks, kh = jax.random.split(key, 5)
    s = 0.5

    def factor(k, v):
        return _t(_u(k, (B,), max(0.0, 1 - s * v), 1 + s * v))

    params = {
        "apply": _t(_u(k_apply, (B, 1, 1, 1)) < 0.8).reshape(B),
        "fb": factor(kb, 0.8), "fc": factor(kc, 0.8), "fs": factor(ks, 0.4),
        "theta": _t(_u(kh, (B,), -s * 0.2, s * 0.2) * 2.0 * jnp.pi),
    }
    got = TA.color_jitter_with(torch.tensor(imgs), params)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_color_jitter_sampler_ranges():
    p = TA.sample_color_jitter(torch.Generator().manual_seed(1), 512)
    assert p["fb"].min() >= 0.6 and p["fb"].max() <= 1.4
    assert p["fs"].min() >= 0.8 and p["fs"].max() <= 1.2
    assert p["theta"].abs().max() <= 0.1 * 2 * math.pi
    assert 0.7 < p["apply"].float().mean() < 0.9


def test_grayscale_and_solarize_match_jax():
    imgs = _images(6)
    key = jax.random.key(6)
    apply = _t(_u(key, (B, 1, 1, 1)) < 0.5).reshape(B)
    ref = JA.random_grayscale(key, jnp.asarray(imgs), 0.5)
    got = TA.grayscale_with(torch.tensor(imgs), apply)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    ref = JA.random_solarize(key, jnp.asarray(imgs), 0.5, 0.5)
    got = TA.solarize_with(torch.tensor(imgs), apply, 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_gaussian_blur_matches_jax():
    imgs = _images(7)
    key = jax.random.key(7)
    ref = JA.gaussian_blur(key, jnp.asarray(imgs), 0.5, (0.1, 2.0), 9)
    k_apply, k_sigma = jax.random.split(key)
    sigma = _t(_u(k_sigma, (B,), 0.1, 2.0))
    apply = _t(_u(k_apply, (B, 1, 1, 1)) < 0.5).reshape(B)
    got = TA.gaussian_blur_with(torch.tensor(imgs), apply, sigma, 9)
    # Both blur in bf16 (2^-8 relative); sums in another order may round
    # one bf16 ulp apart.
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-2)


def test_normalize_matches_jax():
    imgs = _images(8)
    np.testing.assert_allclose(
        TA.normalize(torch.tensor(imgs)).numpy(),
        np.asarray(JA.normalize(jnp.asarray(imgs))), rtol=1e-6, atol=1e-6)


def _jax_view_params(key, cfg, in_hw):
    """The parameters ``augment_view_with_geometry`` samples from ``key``."""
    keys = jax.random.split(key, 9)
    y0, x0, h, w = JA._sample_crop_boxes(keys[0], B, in_hw, cfg.crop_scale,
                                         cfg.crop_ratio)
    p = {"y0": _t(y0), "x0": _t(x0), "h": _t(h), "w": _t(w),
         "hflip": _t(_u(keys[6], (B,)) < cfg.hflip_prob)}
    k_apply, kb, kc, ks, kh = jax.random.split(keys[2], 5)
    s = cfg.cj_strength

    def factor(k, v):
        return _t(_u(k, (B,), max(0.0, 1 - s * v), 1 + s * v))

    p.update({
        "cj_apply": _t(_u(k_apply, (B, 1, 1, 1)) < cfg.cj_prob).reshape(B),
        "cj_fb": factor(kb, cfg.cj_bright), "cj_fc": factor(kc, cfg.cj_contrast),
        "cj_fs": factor(ks, cfg.cj_sat),
        "cj_theta": _t(_u(kh, (B,), -s * cfg.cj_hue, s * cfg.cj_hue)
                       * 2.0 * jnp.pi),
        "gray": _t(_u(keys[3], (B, 1, 1, 1)) < cfg.gray_prob).reshape(B),
    })
    k_apply, k_sigma = jax.random.split(keys[4])
    p["blur_sigma"] = _t(_u(k_sigma, (B,), *cfg.blur_sigma))
    p["blur"] = _t(_u(k_apply, (B, 1, 1, 1)) < cfg.blur_prob).reshape(B)
    if cfg.solarize_prob > 0:
        p["solarize"] = _t(_u(keys[5], (B, 1, 1, 1))
                           < cfg.solarize_prob).reshape(B)
    return p


@pytest.mark.parametrize("view", [0, 1, 2])
def test_dinov2_views_match_jax(view):
    """The three DINOv2 view families (global 1, global 2, local), whole."""
    g, l = 28, 14
    cfgs = [
        JA.ViewAugmentConfig(out_size=(g, g), crop_scale=(0.32, 1.0),
                             blur_prob=1.0),
        JA.ViewAugmentConfig(out_size=(g, g), crop_scale=(0.32, 1.0),
                             blur_prob=0.1, solarize_prob=0.2),
        JA.ViewAugmentConfig(out_size=(l, l), crop_scale=(0.05, 0.32),
                             blur_prob=0.5),
    ]
    cfg_j = cfgs[view]
    cfg_t = TA.ViewAugmentConfig(**{
        f: getattr(cfg_j, f) for f in TA.ViewAugmentConfig.__dataclass_fields__})
    imgs = (_images(9, (B, 48, 40, 3)) * 255).astype(np.uint8)
    key = jax.random.key(10 + view)
    ref, ref_geom = JA.augment_view_with_geometry(key, jnp.asarray(imgs),
                                                  cfg_j)
    params = _jax_view_params(key, cfg_j, (48, 40))
    got, geom = TA.augment_view_with_params(torch.tensor(imgs), cfg_t, params)
    # Blur runs in bf16 (one ulp of a [0, 1] pixel is 2^-8, 0.017 after
    # dividing by the normalization std).
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=4e-2)
    np.testing.assert_allclose(geom.numpy(), np.asarray(ref_geom), rtol=1e-6)


def test_sampled_view_has_expected_shape_and_range():
    cfg = TA.ViewAugmentConfig(out_size=(28, 28), solarize_prob=0.5)
    imgs = torch.randint(0, 256, (B, 48, 40, 3), dtype=torch.uint8)
    view, geom = TA.augment_view_with_geometry(
        torch.Generator().manual_seed(0), imgs, cfg, torch.bfloat16)
    assert view.shape == (B, 28, 28, 3) and view.dtype == torch.bfloat16
    assert torch.isfinite(view.float()).all() and geom.shape == (B, 5)
    lo = (0 - max(cfg.mean)) / min(cfg.std)
    hi = (1 - min(cfg.mean)) / min(cfg.std)
    assert view.float().min() >= lo - 0.05 and view.float().max() <= hi + 0.05


def test_block_masks_match_jax():
    key = jax.random.key(11)
    grid = (6, 5)
    ref, ref_w = JM.random_block_masks(key, 8, grid, 0.5, (0.1, 0.5))
    k_sel, k_ratio, k_aspect, k_pos = jax.random.split(key, 4)
    got, got_w = TM.block_masks_from_params(
        _t(_u(k_sel, (8,)) < 0.5), _t(_u(k_ratio, (8,), 0.1, 0.5)),
        _t(_u(k_aspect, (8, 4), math.log(0.3), math.log(1 / 0.3))),
        _t(_u(k_pos, (8, 4, 2))), grid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), rtol=1e-6)


def test_random_block_masks_sampler():
    mask, weight = TM.random_block_masks(torch.Generator().manual_seed(0),
                                         256, (16, 16), 0.5, (0.1, 0.5))
    frac = mask.float().mean(dim=1)
    selected = frac > 0
    assert 0.35 < selected.float().mean() < 0.65
    assert frac[selected].max() <= 0.5 + 1e-6
    torch.testing.assert_close(weight.sum(dim=1)[selected],
                               torch.ones(int(selected.sum())))


def test_random_ops_are_their_samplers_plus_the_with_functions():
    """Each generator-taking op draws its parameters and applies the
    matching ``*_with`` function: same seed, same output."""
    imgs = torch.tensor(_images(12))

    def gen():
        return torch.Generator().manual_seed(5)

    def u(g, lo=0.0, hi=1.0):
        return torch.rand((B,), generator=g) * (hi - lo) + lo

    g = gen()
    ref = TA.grayscale_with(imgs, u(g) < 0.5)
    torch.testing.assert_close(TA.random_grayscale(gen(), imgs, 0.5), ref)
    g = gen()
    ref = TA.solarize_with(imgs, u(g) < 0.5, 0.3)
    torch.testing.assert_close(TA.random_solarize(gen(), imgs, 0.5, 0.3), ref)
    g = gen()
    sigma = u(g, 0.1, 2.0)
    ref = TA.gaussian_blur_with(imgs, u(g) < 0.5, sigma, 9)
    torch.testing.assert_close(TA.gaussian_blur(gen(), imgs, 0.5), ref)
    g = gen()
    ref = TA.flip_with(imgs, u(g) < 0.5, u(g) < 0.5)
    torch.testing.assert_close(TA.random_flip(gen(), imgs, 0.5, 0.5), ref)
    ref = TA.color_jitter_with(imgs, TA.sample_color_jitter(gen(), B))
    torch.testing.assert_close(TA.color_jitter(gen(), imgs), ref)
