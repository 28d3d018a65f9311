"""The port's DINOv2 ViT and DINO head against the JAX package's.

Both run in float32 at full precision (the JAX conftest forces "highest";
PyTorch's CPU matmuls are full fp32, and TF32 is off) on the same
checkpoint-scale weights (std well above 0.02, LayerScale near 1, so every
block matters), carried into the port by ``params_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.models.heads import DINOHead as JaxDINOHead
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
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


def _vit_pair(seed=0):
    wrapped_j = jax_get_wrapped_model("dinov2/vittest14")
    variables = wrapped_j.init(jax.random.key(seed),
                               jnp.zeros((1, 28, 28, 3)))
    params = checkpoint_scale(jax.device_get(variables["params"]), seed)
    wrapped_t = get_wrapped_model("dinov2/vittest14")
    wrapped_t.module.load_state_dict(params_from_jax(params))
    return wrapped_j, params, wrapped_t


@pytest.mark.parametrize("size", [42, 224])
@pytest.mark.parametrize("masked", [False, True])
def test_vit_forward_matches_jax(size, masked):
    wrapped_j, params, wrapped_t = _vit_pair()
    rng = np.random.default_rng(size)
    images = rng.standard_normal((3, size, size, 3)).astype(np.float32)
    n = (size // 14) ** 2
    mask = rng.random((3, n)) < 0.4 if masked else None
    out_j = wrapped_j.forward_features(
        {"params": params}, jnp.asarray(images),
        mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out_t = wrapped_t.forward_features(
            torch.tensor(images),
            None if mask is None else torch.tensor(mask))
    for key in ("cls_token", "patch_tokens", "features"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


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
