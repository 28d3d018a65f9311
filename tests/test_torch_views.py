"""The views of the methods that read crop geometry or region masks, and
random rotation, in the port against the JAX package.

The rotation on the angles and apply flags the JAX ``random_rotate`` draws
from its key; ``crop_resize_nearest`` bitwise on
integer ids; ``make_views``' mask crops and geometry arrays against the lists
the JAX step's ``_grads_for_microbatch`` appends, on the crop boxes and flips
the JAX step drew; the ``ValueError`` both raise for vertical flips or
rotation with DetCon's dataset masks or DINOv31; ``random_rotation`` in
``transform_args``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightly_train_tpu._commands import train_loop as JTL
from lightly_train_tpu.methods import detcon as JDT
from lightly_train_tpu.methods import dinov31 as JD31
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops import augment as JA
from lightly_train_tpu_torch._commands.train_loop import (
    make_train_step,
    make_views,
)
from lightly_train_tpu_torch.methods import detcon as DT
from lightly_train_tpu_torch.methods import dinov31 as D31
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops import augment as TA
from torch_fixtures.threads import one_torch_thread  # noqa: F401

STUDENT = "dinov2/vittest14"


def _jax_rotation_draw(key, batch, prob, degrees):
    """The apply flags and angles (radians, 0 where not applied) the JAX
    ``random_rotate`` draws from ``key``."""
    k_apply, k_angle = jax.random.split(key)
    apply = jax.random.uniform(k_apply, (batch,)) < prob
    angle = jax.random.uniform(k_angle, (batch,), minval=-degrees,
                               maxval=degrees) * (jnp.pi / 180.0)
    return np.asarray(apply), np.asarray(jnp.where(apply, angle, 0.0))


@pytest.mark.parametrize("hw,prob,degrees", [
    ((32, 32), 0.7, 30.0), ((17, 23), 1.0, 180.0), ((96, 96), 0.5, 10.0),
    ((1, 9), 1.0, 45.0), ((224, 224), 1.0, 90.0)])
def test_random_rotate_matches_jax(hw, prob, degrees):
    """On JAX's cosines and sines of the drawn angles within 1e-5 of 0-255
    values. From the angles alone, XLA's and PyTorch's float32 cos and sin
    differ by an ulp on some angles (neither is always correctly rounded):
    that moves a sample's two coordinates by up to (|dcos| + |dsin|) times
    the sum of its offsets from the centre (at most the image's larger
    side), plus an ulp of each coordinate where its rounding tips (below
    1.5 times that side before the border reflects), and a value by 255
    times the move, which bounds the difference there."""
    rng = np.random.default_rng(hw[0])
    images = rng.uniform(0, 255, (6, *hw, 3)).astype(np.float32)
    key = jax.random.key(hw[1])
    ref = np.asarray(JA.random_rotate(key, jnp.asarray(images), prob,
                                      degrees))
    apply, angle = _jax_rotation_draw(key, 6, prob, degrees)
    cos, sin = np.asarray(jnp.cos(angle)), np.asarray(jnp.sin(angle))
    got = TA.rotate_with_cos_sin(torch.tensor(images), torch.tensor(apply),
                                 torch.tensor(cos), torch.tensor(sin))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    got = TA.random_rotate_with(torch.tensor(images), torch.tensor(apply),
                                torch.tensor(angle)).numpy()
    t = torch.tensor(angle)
    ulp = (np.abs(torch.cos(t).numpy() - cos).max()
           + np.abs(torch.sin(t).numpy() - sin).max())
    side = max(hw)
    move = (ulp * side + 2 * 2.0 ** -23 * 1.5 * side) if ulp else 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 + 255 * move)
    assert apply.any()


def test_rotation_draws_are_in_bounds():
    gen = torch.Generator().manual_seed(0)
    p = TA.sample_rotation(gen, 4096, 0.3, 20.0)
    assert 0.25 < p["rotate"].float().mean() < 0.35
    assert (p["rotate_angle"][~p["rotate"]] == 0).all()
    bound = 20.0 * np.pi / 180.0
    assert p["rotate_angle"].abs().max() <= bound
    assert p["rotate_angle"][p["rotate"]].abs().max() > 0.9 * bound
    images = torch.rand(3, 8, 8, 3)
    assert torch.equal(TA.random_rotate(gen, images, 0.0, 30.0), images)
    assert torch.equal(TA.random_rotate(gen, images, 1.0, 0.0), images)


@pytest.mark.parametrize("rotation", [
    None, {"prob": 0.5, "degrees": 15}, {"degrees": [-30, 10]}, {}])
def test_random_rotation_transform_args_match_jax(rotation):
    cfg = TA.ViewAugmentConfig()
    got = TA.view_config_with_overrides(cfg, {"random_rotation": rotation})
    ref = JA.view_config_with_overrides(JA.ViewAugmentConfig(),
                                        {"random_rotation": rotation})
    assert (got.rotation_prob, got.rotation_degrees) == (
        ref.rotation_prob, ref.rotation_degrees)


def test_a_rotated_view_is_the_rotation_of_the_unrotated_one():
    """In the view pipeline the rotation runs after the crop and flips,
    before the photometric ops, and leaves the geometry as it was."""
    images = torch.randint(0, 256, (3, 40, 40, 3), dtype=torch.uint8)
    cfg = TA.ViewAugmentConfig(out_size=(28, 28), rotation_prob=1.0,
                               rotation_degrees=30.0, cj_prob=0.0,
                               gray_prob=0.0, blur_prob=0.0)
    p = TA.sample_view_params(torch.Generator().manual_seed(1), 3, (40, 40),
                              cfg)
    assert {"rotate", "rotate_angle"} <= set(p)
    view, geom = TA.augment_view_with_params(images, cfg, p)
    plain = dataclasses.replace(cfg, rotation_prob=0.0)
    base, base_geom = TA.augment_view_with_params(
        images, plain, {k: v for k, v in p.items()
                        if not k.startswith("rotate")})
    mean = torch.tensor(cfg.mean)
    std = torch.tensor(cfg.std)
    expected = TA.normalize(TA.random_rotate_with(
        base * std + mean, p["rotate"], p["rotate_angle"]), cfg.mean,
        cfg.std)
    torch.testing.assert_close(view, expected, rtol=0, atol=1e-5)
    assert torch.equal(geom, base_geom)


@pytest.mark.parametrize("in_hw,out_hw", [((36, 36), (28, 28)),
                                          ((37, 23), (13, 11)),
                                          ((20, 20), (56, 56))])
def test_crop_resize_nearest_matches_jax_bitwise(in_hw, out_hw):
    rng = np.random.default_rng(in_hw[0])
    H, W = in_hw
    masks = rng.integers(0, 70000, (5, H, W)).astype(np.int32)
    h = rng.uniform(1, H, 5).astype(np.float32)
    w = rng.uniform(1, W, 5).astype(np.float32)
    y0 = (rng.uniform(0, 1, 5) * (H - h)).astype(np.float32)
    x0 = (rng.uniform(0, 1, 5) * (W - w)).astype(np.float32)
    boxes = (y0, x0, h, w)
    ref = np.asarray(JA.crop_resize_nearest(
        jnp.asarray(masks), *(jnp.asarray(b) for b in boxes), out_hw))
    got = TA.crop_resize_nearest(torch.tensor(masks),
                                 *(torch.tensor(b) for b in boxes), out_hw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _jax_lists(method, images, masks, seed):
    """The views list the JAX step hands ``method.loss_fn`` for one
    microbatch (its ``_grads_for_microbatch``)."""
    captured = []

    def loss_fn(params, model_state, method_state, views, rng, step,
                total_steps):
        captured.append(views)
        return params["w"] * 0.0, (model_state, method_state, {})

    method.loss_fn = loss_fn
    step = JTL.make_train_step(method, optax.sgd(0.1), 10)
    step.grads_for_microbatch(
        {"w": jnp.zeros(())}, {}, {}, jnp.asarray(images),
        None if masks is None else jnp.asarray(masks), jax.random.key(seed),
        jnp.asarray(0))
    return [np.asarray(v) for v in captured[0]]


def _port_params(geom):
    """The crop and flip of a (B, 5) geometry array as port view params
    (the photometric draws left out)."""
    g = torch.tensor(geom)
    return {"y0": g[:, 0], "x0": g[:, 1], "h": g[:, 2], "w": g[:, 3],
            "hflip": g[:, 4] > 0.5}


@pytest.mark.parametrize("seed", [0, 1])
def test_mask_and_geometry_views_match_the_jax_step(seed):
    """DetCon-B with dataset masks (and, to read the JAX boxes, geometry
    too): views, then a mask crop per view, then a geometry array per
    view; the mask crops bitwise, flipped where the view is."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (4, 36, 36, 3), dtype=np.uint8)
    masks = rng.integers(0, 9, (4, 36, 36)).astype(np.int32)
    args = dict(image_size=28, hidden_dim=8, output_dim=4, num_masks=4,
                use_dataset_masks=True)
    j_method = JDT.DetConB(jax_get_wrapped_model(STUDENT),
                           JDT.DetConBArgs(**args))
    j_method.needs_geometry = True
    ref = _jax_lists(j_method, images, masks, seed)
    assert len(ref) == 6
    geoms = ref[4:]
    assert all(g.shape == (4, 5) for g in geoms)
    assert {0.0, 1.0} >= set(np.concatenate([g[:, 4] for g in geoms]))
    method = DT.DetConB(get_wrapped_model(STUDENT), DT.DetConBArgs(**args))
    assert method.needs_masks
    got = make_views(method.view_specs(), torch.tensor(images), None,
                     torch.float32, masks=torch.tensor(masks),
                     needs_masks=True, needs_geometry=True,
                     view_params=[_port_params(g) for g in geoms])
    assert len(got) == 6
    assert [tuple(v.shape) for v in got[:2]] == [(4, 28, 28, 3)] * 2
    for i in (2, 3):
        assert got[i].dtype == torch.int32
        np.testing.assert_array_equal(got[i].numpy(), ref[i])
    for i in (4, 5):
        np.testing.assert_array_equal(got[i].numpy(), ref[i])
    # Without geometry the list ends with the mask crops, as in the JAX
    # step for DetCon-B.
    assert len(make_views(method.view_specs(), torch.tensor(images), None,
                          torch.float32, masks=torch.tensor(masks),
                          needs_masks=True,
                          view_params=[_port_params(g) for g in geoms])) == 4


def test_geometry_views_of_dinov31_match_the_jax_step():
    """DINOv31: its 5 views (g1, g2, the clean view, 2 locals), then their
    5 geometry arrays; the clean view is never flipped."""
    args = dict(output_dim=8, hidden_dim=8, bottleneck_dim=4,
                local_view_count=2, global_image_size=28,
                local_image_size=14, paka_hidden_dim=8,
                paka_bottleneck_dim=4)
    images = np.random.default_rng(0).integers(0, 256, (4, 36, 36, 3),
                                               dtype=np.uint8)
    ref = _jax_lists(JD31.DINOv31(jax_get_wrapped_model(STUDENT),
                                  JD31.DINOv31Args(**args)), images, None, 3)
    method = D31.DINOv31(get_wrapped_model(STUDENT), D31.DINOv31Args(**args))
    geoms = ref[5:]
    got = make_views(method.view_specs(), torch.tensor(images), None,
                     torch.float32, needs_geometry=method.needs_geometry,
                     view_params=[_port_params(g) for g in geoms])
    assert [tuple(v.shape) for v in got] == [r.shape for r in ref]
    for g, r in zip(got[5:], geoms):
        np.testing.assert_array_equal(g.numpy(), r)
    assert not geoms[2][:, 4].any()
    # Drawn from a generator: every box inside the image, the clean view
    # never flipped.
    drawn = make_views(method.view_specs(), torch.tensor(images),
                       torch.Generator().manual_seed(0), torch.float32,
                       needs_geometry=True)
    assert len(drawn) == 10
    for g in drawn[5:]:
        assert (g[:, 0] >= 0).all() and (g[:, 0] + g[:, 2] <= 36 + 1e-4).all()
    assert not drawn[7][:, 4].any()


@pytest.mark.parametrize("case", ["detcon_vflip", "detcon_rotation",
                                  "dinov31_vflip", "dinov31_rotation"])
def test_vflip_or_rotation_with_geometry_methods_is_refused(case):
    """Both packages raise the same ValueError; DetCon-B without dataset
    masks reads no geometry and takes them."""
    transform = ({"random_flip": {"vertical_prob": 0.5}}
                 if case.endswith("vflip")
                 else {"random_rotation": {"prob": 0.5, "degrees": 10}})
    if case.startswith("detcon"):
        args = dict(image_size=28, hidden_dim=8, output_dim=4,
                    use_dataset_masks=True)
        pairs = [(JDT.DetConB(jax_get_wrapped_model(STUDENT),
                              JDT.DetConBArgs(**args)),
                  DT.DetConB(get_wrapped_model(STUDENT),
                             DT.DetConBArgs(**args)))]
    else:
        args = dict(output_dim=8, hidden_dim=8, bottleneck_dim=4,
                    local_view_count=1, global_image_size=28,
                    local_image_size=14)
        pairs = [(JD31.DINOv31(jax_get_wrapped_model(STUDENT),
                               JD31.DINOv31Args(**args)),
                  D31.DINOv31(get_wrapped_model(STUDENT),
                              D31.DINOv31Args(**args)))]
    for j_method, method in pairs:
        with pytest.raises(ValueError) as j_err:
            JTL.make_train_step(j_method, optax.sgd(0.1), 10,
                                transform_args=transform)
        with pytest.raises(ValueError) as err:
            make_train_step(method, 10, transform_args=transform)
        assert str(err.value) == str(j_err.value)
    if case.startswith("detcon"):
        args["use_dataset_masks"] = False
        JTL.make_train_step(JDT.DetConB(jax_get_wrapped_model(STUDENT),
                                        JDT.DetConBArgs(**args)),
                            optax.sgd(0.1), 10, transform_args=transform)
        make_train_step(DT.DetConB(get_wrapped_model(STUDENT),
                                   DT.DetConBArgs(**args)), 10,
                        transform_args=transform)
