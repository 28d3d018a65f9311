"""The port's ``embed`` and ``embed_dim`` projection against the JAX
package's, on the same weights carried across by ``params_from_jax``. All on
the CPU in fp32 at the ``vittest14`` size; the JAX artifacts are written
with orbax, the port's with ``torch.save``."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu._checkpoint.checkpoint import (
    export_model as jax_export_model,
)
from lightly_train_tpu.models.embedding import (
    project_wrapped as jax_project_wrapped,
)
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu_torch._checkpoint.checkpoint import export_model
from lightly_train_tpu_torch.errors import ConfigValidationError
from lightly_train_tpu_torch.models.embedding import project_wrapped
from lightly_train_tpu_torch.models.from_jax import params_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from test_torch_vit import checkpoint_scale

MODEL = "dinov2/vittest14"
EMBED_DIM = 24


@pytest.fixture(autouse=True)
def _no_tf32():
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prior


@pytest.fixture
def data(tmp_path):
    """Ten PPM images of mixed sizes (each decodes and resizes)."""
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        h, w = 30 + 3 * i, 50 - 2 * i
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        (folder / f"{i:02d}.ppm").write_bytes(
            f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
    return folder


def _jax_params(embed_dim, seed=0):
    """Checkpoint-scale weights of the (projected) JAX vittest14."""
    wrapped = jax_get_wrapped_model(MODEL)
    if embed_dim is not None:
        wrapped = jax_project_wrapped(wrapped, embed_dim, jnp.float32)
    variables = wrapped.init(jax.random.key(seed), jnp.zeros((1, 28, 28, 3)))
    return wrapped, checkpoint_scale(jax.device_get(variables["params"]),
                                     seed)


@pytest.mark.parametrize("masked", [False, True])
def test_projected_features_module_matches_jax(masked):
    wrapped_j, params = _jax_params(EMBED_DIM)
    wrapped_t = project_wrapped(get_wrapped_model(MODEL), EMBED_DIM,
                                torch.float32)
    wrapped_t.module.load_state_dict(params_from_jax(params))
    assert wrapped_t.feature_dim == wrapped_j.feature_dim == EMBED_DIM
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, 42, 42, 3)).astype(np.float32)
    mask = rng.random((3, 9)) < 0.4 if masked else None
    out_j = wrapped_j.forward_features(
        {"params": params}, jnp.asarray(images),
        mask=None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out_t = wrapped_t.forward_features(
            torch.tensor(images), None if mask is None else torch.tensor(mask))
    for key in ("cls_token", "patch_tokens", "features"):
        assert out_t[key].shape[-1] == EMBED_DIM
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(
        wrapped_t.forward_pool(out_t).numpy(),
        np.asarray(wrapped_j.forward_pool(out_j)), rtol=1e-4, atol=1e-5)


def test_forward_pool_averages_without_a_cls_token():
    feats = torch.randn(2, 3, 4, 5)
    wrapped = get_wrapped_model(MODEL)
    torch.testing.assert_close(wrapped.forward_pool({"features": feats}),
                               feats.mean(dim=(1, 2)))


def _artifacts(tmp_path, embed_dim):
    """The same weights as a JAX artifact and as a port artifact."""
    _, params = _jax_params(embed_dim)
    meta = {"method": "dinov2", "steps": 7}
    j_dir, t_dir = tmp_path / "jax_artifact", tmp_path / "port_artifact"
    if embed_dim is None:
        jax_export_model(j_dir, MODEL, params, extra_meta=meta)
        export_model(t_dir, MODEL, params_from_jax(params), extra_meta=meta)
    else:
        meta["embed_dim"] = embed_dim
        head = {"params": {"embed": params["embed"]}}
        jax_export_model(j_dir, MODEL, params["backbone"], extra_meta=meta,
                         embed_head=head)
        export_model(t_dir, MODEL, params_from_jax(params["backbone"]),
                     extra_meta=meta,
                     embed_head=params_from_jax(params["embed"]))
    return j_dir, t_dir


def _read(path, fmt):
    """(filenames, embeddings) of an embed output file."""
    if fmt == "npz":
        z = np.load(path)
        return list(z["filenames"]), z["embeddings"]
    if fmt == "torch":
        z = torch.load(path, weights_only=False)
        return list(z["filenames"]), z["embeddings"].numpy()
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if fmt == "lightly_csv":
        assert rows[0][0] == "filenames"
        assert rows[0][1:] == [f"embedding_{i}"
                               for i in range(len(rows[0]) - 1)]
        rows = rows[1:]
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:]]
                                           for r in rows])


@pytest.mark.parametrize("fmt, embed_dim", [
    ("npz", None), ("csv", None), ("npz", EMBED_DIM), ("csv", EMBED_DIM),
    ("lightly_csv", EMBED_DIM), ("torch", None),
])
def test_embed_matches_jax(tmp_path, data, fmt, embed_dim):
    """10 images at batch 8: the second batch is padded."""
    j_dir, t_dir = _artifacts(tmp_path, embed_dim)
    suffix = {"npz": ".npz", "torch": ".pt"}.get(fmt, ".csv")
    kwargs = dict(data=str(data), format=fmt, image_size=28, batch_size=8,
                  precision="fp32")
    j_out = jlt.embed(out=str(tmp_path / f"jax{suffix}"),
                      checkpoint=str(j_dir), **kwargs)
    t_out = lt.embed(out=str(tmp_path / f"port{suffix}"),
                     checkpoint=str(t_dir), accelerator="cpu", **kwargs)
    j_files, j_emb = _read(j_out, fmt)
    t_files, t_emb = _read(t_out, fmt)
    assert t_files == j_files and len(t_files) == 10
    dim = embed_dim or get_wrapped_model(MODEL).feature_dim
    assert t_emb.shape == j_emb.shape == (10, dim)
    # The csv formats hold 8 decimals.
    atol = 1e-5 if fmt in ("npz", "torch") else 2e-5
    np.testing.assert_allclose(t_emb, j_emb, rtol=1e-4, atol=atol)


def test_embed_config_is_checked(tmp_path, data):
    _, t_dir = _artifacts(tmp_path, None)
    with pytest.raises(ConfigValidationError, match="parquet"):
        lt.embed(out=str(tmp_path / "e"), data=str(data),
                 checkpoint=str(t_dir), format="parquet", accelerator="cpu")


def test_embed_refuses_to_fall_back_to_the_cpu(tmp_path, data):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device exists")
    _, t_dir = _artifacts(tmp_path, None)
    with pytest.raises(RuntimeError, match="accelerator='cpu'"):
        lt.embed(out=str(tmp_path / "e.npz"), data=str(data),
                 checkpoint=str(t_dir))
