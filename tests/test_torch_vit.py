"""The port's DINOv2 and DINOv3 ViTs and DINO head against the JAX
package's.

Both run in float32 at full precision (the JAX conftest forces "highest";
PyTorch's CPU matmuls are full fp32, and TF32 is off) on the same
checkpoint-scale weights (std well above 0.02, LayerScale near 1, so every
block matters), carried into the port by ``params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.models import vit as JV
from lightly_train_tpu.models import wrapper as JW
from lightly_train_tpu.models.heads import DINOHead as JaxDINOHead
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu_torch.models import vit as TV
from lightly_train_tpu_torch.models import wrapper as TW
from lightly_train_tpu_torch.models.from_jax import (
    method_state_from_jax,
    params_from_jax,
)
from lightly_train_tpu_torch.models.heads import DINOHead
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model


@pytest.fixture(autouse=True)
def _no_tf32():
    prior = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prior


def checkpoint_scale(tree, seed):
    """Replace every leaf with random values at checkpoint scale."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        shape = x.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name == "scale":
            return 1.0 + 0.2 * rng.standard_normal(shape)
        if name == "gamma":
            return 0.5 + 0.2 * rng.standard_normal(shape)
        if name == "v":
            return rng.standard_normal(shape) * 0.3
        if name == "g":
            return 1.0 + 0.2 * rng.standard_normal(shape)
        return 0.5 * rng.standard_normal(shape)  # biases, tokens, pos_embed

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(leaf(p, x), np.float32), tree)


# A SwiGLU FFN (DINOv2's ViT-g, the DINOv3 "plus" sizes) at the test size.
SWIGLU = "dinov2/vittest14+swiglu"


def _wrapped_pair(model):
    """(JAX wrapped model, port wrapped model) of a registry name, or of the
    test-size ViT with a SwiGLU FFN."""
    if model != SWIGLU:
        return jax_get_wrapped_model(model), get_wrapped_model(model)
    cfg_j = dataclasses.replace(JV.vit_config("vittest", 14), use_swiglu=True)
    cfg_t = dataclasses.replace(TV.vit_config("vittest", 14), use_swiglu=True)
    return (JW.WrappedModel(model, JV.VisionTransformer(cfg_j), 32, 14),
            TW.WrappedModel(model, TV.VisionTransformer(cfg_t), 32, 14))


def _vit_pair(seed=0, model="dinov2/vittest14"):
    wrapped_j, wrapped_t = _wrapped_pair(model)
    variables = wrapped_j.init(jax.random.key(seed),
                               jnp.zeros((1, 32, 32, 3)))
    params = checkpoint_scale(jax.device_get(variables["params"]), seed)
    wrapped_t.module.load_state_dict(params_from_jax(params))
    return wrapped_j, params, wrapped_t


# (model, masked, size); the DINOv2 cases keep their original ids.
FORWARD_CASES = [
    pytest.param(model, masked, size,
                 id=(f"{masked}-{size}" if model == "dinov2/vittest14"
                     else f"{model}-{masked}-{size}"))
    for model in ("dinov2/vittest14", "dinov3/vittest16", SWIGLU)
    for size in (42, 224) for masked in (False, True)
]


@pytest.mark.parametrize("model,masked,size", FORWARD_CASES)
def test_vit_forward_matches_jax(model, masked, size):
    wrapped_j, params, wrapped_t = _vit_pair(model=model)
    rng = np.random.default_rng(size)
    images = rng.standard_normal((3, size, size, 3)).astype(np.float32)
    n = (size // wrapped_t.patch_size) ** 2
    mask = rng.random((3, n)) < 0.4 if masked else None
    out_j = wrapped_j.forward_features(
        {"params": params}, jnp.asarray(images),
        mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out_t = wrapped_t.forward_features(
            torch.tensor(images),
            None if mask is None else torch.tensor(mask))
    for key in ("cls_token", "patch_tokens", "features", "register_tokens"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("grid,head_dim", [((7, 7), 16), ((14, 14), 64),
                                           ((2, 3), 8), ((16, 16), 64)])
def test_rope_tables_are_the_jax_tables_bitwise(grid, head_dim):
    cos_j, sin_j = JV._rope_angles(grid, head_dim, 100.0)
    cos_t, sin_t = TV.rope_angles(grid, head_dim, 100.0)
    assert cos_t.dtype == sin_t.dtype == np.float32
    np.testing.assert_array_equal(cos_t, np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t, np.asarray(sin_j))


def test_dinov3_vit_skips_the_prefix_in_rope_and_has_no_key_bias():
    """RoPE rotates the patch tokens only: with the tables at angle 0 the
    prefix (CLS, 4 registers) sees no change, and neither do the patches."""
    module = get_wrapped_model("dinov3/vittest16").module
    attn = module.blocks[0].attn
    assert attn.num_prefix_tokens == 5 and attn.k.bias is None
    assert module.pos_embed is None and module.register_tokens.shape == (
        1, 4, 32)
    assert module.cfg.norm_eps == 1e-5
    x = torch.randn(2, 5 + 9, 32)
    q = x.unflatten(-1, (2, 16))
    ones, zeros = torch.ones(9, 8), torch.zeros(9, 8)
    rotated = TV.apply_rope(q[:, 5:], ones, zeros)
    assert torch.equal(rotated, q[:, 5:])
    # A quarter turn swaps the halves (x1, x2) -> (-x2, x1).
    turned = TV.apply_rope(q[:, 5:], zeros, ones)
    assert torch.equal(turned, torch.cat([-q[:, 5:, :, 8:], q[:, 5:, :, :8]],
                                         dim=-1))


def test_dino_head_matches_jax():
    head_j = JaxDINOHead(out_dim=64, hidden_dim=32, bottleneck_dim=16)
    params = head_j.init(jax.random.key(1), jnp.zeros((1, 24)))["params"]
    params = checkpoint_scale(jax.device_get(params), 1)
    head_t = DINOHead(24, 64, 32, 16)
    head_t.load_state_dict(params_from_jax(params))
    x = np.random.default_rng(2).standard_normal((5, 24)).astype(np.float32)
    ref = head_j.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = head_t(torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_params_from_jax_layouts():
    params = {
        "patch_embed": {"kernel": np.zeros((14, 14, 3, 8)),
                        "bias": np.zeros(8)},
        "block3": {"attn": {"q": {"kernel": np.ones((8, 4))}},
                   "norm1": {"scale": np.ones(8)}},
        "head": {"mlp0": {"kernel": np.ones((8, 2))},
                 "prototypes": {"v": np.ones((16, 5)), "g": np.ones(5)}},
    }
    state = params_from_jax(params)
    assert state["patch_embed.weight"].shape == (8, 3, 14, 14)
    assert state["blocks.3.attn.q.weight"].shape == (4, 8)
    assert state["blocks.3.norm1.weight"].shape == (8,)
    assert state["head.mlp.0.weight"].shape == (2, 8)
    assert state["head.prototypes.v"].shape == (5, 16)
    assert state["head.prototypes.g"].shape == (5,)
    ms = method_state_from_jax({"teacher": {"x": {"bias": np.ones(2)}},
                                "dino_center": np.ones(3),
                                "ibot_center": np.zeros(3)})
    assert set(ms) == {"teacher", "dino_center", "ibot_center"}
    assert ms["teacher"]["x.bias"].dtype == torch.float32


def test_params_from_jax_carries_dinov3_and_distillation_leaves():
    params = {
        "register_tokens": np.zeros((1, 4, 8)),
        "block0": {"attn": {"k": {"kernel": np.ones((8, 8))}},
                   "mlp": {"w1": {"kernel": np.ones((8, 6)),
                                  "bias": np.ones(6)},
                           "w2": {"kernel": np.ones((8, 6))},
                           "w3": {"kernel": np.ones((6, 8))}}},
        "global_head": {"proj": {"kernel": np.ones((8, 5)),
                                 "bias": np.zeros(5)}},
    }
    state = params_from_jax(params)
    assert state["register_tokens"].shape == (1, 4, 8)
    assert "blocks.0.attn.k.bias" not in state
    assert state["blocks.0.mlp.w1.weight"].shape == (6, 8)
    assert state["blocks.0.mlp.w3.weight"].shape == (8, 6)
    assert state["global_head.proj.weight"].shape == (5, 8)
    ms = method_state_from_jax({
        "teacher": {"params": {"cls_token": np.ones((1, 1, 8))}},
        "queue": np.ones((4, 8)), "queue_ptr": np.int32(3),
        "queue_filled": np.int32(4)})
    assert set(ms) == {"teacher", "queue", "queue_ptr", "queue_filled"}
    assert set(ms["teacher"]) == {"cls_token"}
    assert ms["queue_ptr"] == 3 and isinstance(ms["queue_filled"], int)


@pytest.mark.parametrize("model", ["dinov3/vitb16", "dinov2/vitg14",
                                   "dinov3/vits16plus"])
def test_parameter_count_matches_jax(model):
    """The teacher of the default method, DINOv2's ViT-g (SwiGLU) and a
    DINOv3 "plus" size (SwiGLU): the JAX model's parameter count."""
    with torch.device("meta"):
        module = get_wrapped_model(model).module
    n_torch = sum(p.numel() for p in module.parameters())
    wrapped_j = jax_get_wrapped_model(model)
    shapes = jax.eval_shape(
        lambda: wrapped_j.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_torch == n_jax


def test_vitb14_parameter_count():
    """ViT-B/14: the same parameter count as the JAX model."""
    with torch.device("meta"):
        module = get_wrapped_model("dinov2/vitb14").module
    n_torch = sum(p.numel() for p in module.parameters())
    wrapped_j = jax_get_wrapped_model("dinov2/vitb14")
    shapes = jax.eval_shape(
        lambda: wrapped_j.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_torch == n_jax == 85_724_928


def test_vitb14_forward_matches_jax():
    """ViT-B/14 (12 blocks, width 768, 12 heads) at batch 1 and 224^2, fp32,
    on checkpoint-scale weights carried by ``params_from_jax``. Measured on
    the CPU: 4.8e-7 relative L2 on the CLS token, 3.6e-6 max-abs on
    outputs of magnitude up to 5.6; held to the tolerance of the vittest14
    cases, rtol and atol 1e-4."""
    wrapped_j, params, wrapped_t = _vit_pair(model="dinov2/vitb14")
    images = np.random.default_rng(7).standard_normal(
        (1, 224, 224, 3)).astype(np.float32)
    out_j = jax.jit(lambda p, x: wrapped_j.forward_features(
        {"params": p}, x))(params, jnp.asarray(images))
    with torch.no_grad():
        out_t = wrapped_t.forward_features(torch.tensor(images), None)
    for key in ("cls_token", "patch_tokens"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("model", ["dinov2/vittest14", "dinov3/vittest16"])
def test_bf16_vit_forward_matches_jax(model):
    """bf16 compute against fp32 parameters in both packages (projections
    in bf16, LayerNorm statistics in fp32), at batch 3 and 224^2 (256
    tokens, 2 blocks). The two round in different orders: measured on the
    CPU, 4.5e-3 to 5.2e-3 relative L2 and at most 1.26e-2 of the largest
    magnitude apart (about three bf16 ulps); held to 2e-2 relative L2 and
    2^-5 of the largest magnitude (eight ulps)."""
    wrapped_j, params, _ = _vit_pair(model=model)
    wrapped_j = jax_get_wrapped_model(model, dtype=jnp.bfloat16)
    wrapped_t = get_wrapped_model(model, dtype=torch.bfloat16)
    wrapped_t.module.load_state_dict(params_from_jax(params))
    images = np.random.default_rng(3).standard_normal(
        (3, 224, 224, 3)).astype(np.float32)
    out_j = wrapped_j.forward_features({"params": params},
                                       jnp.asarray(images))
    with torch.no_grad():
        out_t = wrapped_t.forward_features(torch.tensor(images), None)
    for key in ("cls_token", "patch_tokens"):
        got = out_t[key].float().numpy()
        ref = np.asarray(out_j[key].astype(jnp.float32))
        assert out_t[key].dtype == torch.bfloat16
        assert out_j[key].dtype == jnp.bfloat16
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel < 2e-2, (key, rel)
        assert np.abs(got - ref).max() <= 2 ** -5 * np.abs(ref).max(), key
