"""The port's ``export`` and its inverse converters against the JAX package.

``models/convert.py::params_to_jax`` (the port's state dict back to the
Flax tree) is held bitwise to the tree that ``variables_from_jax`` carried
into each model family at its test size; the Meta ViT converter bitwise to
the JAX one. ``export`` is held to the JAX package's on the same weights:
``numpy_state_dict`` and ``torch_state_dict`` with the same keys, dtypes and
arrays, bitwise, for each part, and the same ``ConfigError`` without a head.
Trees come from ``jax.eval_shape`` filled with seeded numpy, so no JAX
forward runs. All on the CPU.
"""

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
from lightly_train_tpu.errors import ConfigError as JaxConfigError
from lightly_train_tpu.models.convert import (
    convert_flax_vit_to_torch_state_dict as jax_flax_to_meta,
)
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu_torch._checkpoint.checkpoint import (
    export_model,
    load_exported_model,
    resolve_pretrained_source,
)
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.convert import (
    convert_flax_vit_to_torch_state_dict,
    params_to_jax,
)
from lightly_train_tpu_torch.models.from_jax import variables_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from torch_fixtures.threads import one_torch_thread  # noqa: F401

# Every family at its test size, with an input size its init takes.
FAMILIES = {
    "dinov2/vittest14": 28, "dinov3/vittest16": 32,
    "torchvision/resnettest": 64, "torchvision/resnettestvd": 64,
    "torchvision/shufflenettest": 64, "dinov3/convnext-test": 64,
    "ecvit/ecvittest": 96, "ultralytics/yolov8test": 64,
    "ultralytics/yolov5test": 64, "ultralytics/yolo11test": 64,
    "super_gradients/yolo_nas_test": 64,
}
VIT = "dinov2/vittest14"
EMBED_DIM = 24


def seeded_variables(model, seed=0, wrapped_j=None):
    """The JAX init's variables of ``model``, shapes from ``eval_shape``
    and values from a numpy seed (float32)."""
    wrapped_j = wrapped_j or jax_get_wrapped_model(model)
    size = FAMILIES.get(model, 28)
    shapes = jax.eval_shape(lambda: wrapped_j.init(
        jax.random.key(0), jnp.zeros((1, size, size, 3))))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (0.5 * rng.standard_normal(x.shape)).astype(np.float32),
        shapes)


def assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), (path, set(got)
                                                             ^ set(want))
    for key, value in want.items():
        if isinstance(value, dict):
            assert_trees_equal(got[key], value, f"{path}/{key}")
        else:
            assert got[key].dtype == np.float32, f"{path}/{key}"
            np.testing.assert_array_equal(got[key], value,
                                          err_msg=f"{path}/{key}")


@pytest.mark.parametrize("model", list(FAMILIES))
def test_params_to_jax_inverts_the_carry(model):
    """The tree carried into the port's module and read back from its
    parameters (buffers left out, as ``export`` leaves them) is the tree,
    bitwise, 0-d leaves included."""
    variables = seeded_variables(model)
    module = get_wrapped_model(model).module
    module.load_state_dict(variables_from_jax(variables))
    names = dict(module.named_parameters())
    params = {k: v for k, v in module.state_dict().items() if k in names}
    assert_trees_equal(params_to_jax(params), variables["params"])


@pytest.mark.parametrize("model", ["dinov2/vittest14", "dinov3/vittest16"])
def test_meta_vit_converter_matches_jax(model):
    params = seeded_variables(model)["params"]
    depth = sum(1 for k in params if k.startswith("block"))
    got = convert_flax_vit_to_torch_state_dict(params, depth)
    want = jax_flax_to_meta(params, depth)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


# case -> (model, embed_dim)
CASES = {"vit": (VIT, None), "vit_embed": (VIT, EMBED_DIM),
         "resnet": ("torchvision/resnettest", None)}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The same weights as a JAX artifact and as a port artifact, per case:
    {case: (jax dir, port dir, variables)}."""
    root = tmp_path_factory.mktemp("artifacts")
    out = {}
    for case, (model, embed_dim) in CASES.items():
        variables = seeded_variables(model, seed=len(out))
        meta = {"method": "dinov2", "steps": 3}
        j_dir, t_dir = root / f"jax_{case}", root / f"port_{case}"
        state = {k: v for k, v in variables.items() if k != "params"}
        head = head_t = None
        if embed_dim is not None:
            meta["embed_dim"] = embed_dim
            rng = np.random.default_rng(7)
            width = get_wrapped_model(model).feature_dim
            embed = {"kernel": rng.standard_normal(
                (width, embed_dim)).astype(np.float32),
                "bias": rng.standard_normal(embed_dim).astype(np.float32)}
            head = {"params": {"embed": embed}}
            head_t = {"weight": torch.from_numpy(embed["kernel"].T.copy()),
                      "bias": torch.from_numpy(embed["bias"])}
        jax_export_model(j_dir, model, variables["params"],
                         model_state=state or None, extra_meta=meta,
                         embed_head=head)
        export_model(t_dir, model, variables_from_jax(variables),
                     extra_meta=meta, embed_head=head_t)
        out[case] = (j_dir, t_dir, variables)
    return out


def _read(path, fmt):
    if fmt == "numpy_state_dict":
        z = np.load(path)
        return {k: z[k] for k in z.files}
    return {k: v.numpy() for k, v in torch.load(path).items()}


@pytest.mark.parametrize("case,fmt,part", [
    (case, fmt, part)
    for case in CASES
    for fmt in ("numpy_state_dict", "torch_state_dict")
    for part in (("model", "embedding_model") if CASES[case][1]
                 else ("model",))
])
def test_state_dict_exports_match_jax(tmp_path, artifacts, case, fmt, part):
    """Keys, dtypes and arrays bitwise; a CNN's BatchNorm statistics are in
    neither package's file (they write the parameters only)."""
    j_dir, t_dir, _ = artifacts[case]
    suffix = ".npz" if fmt == "numpy_state_dict" else ".pt"
    j_out = jlt.export(out=str(tmp_path / f"jax{suffix}"),
                       checkpoint=str(j_dir), format=fmt, part=part)
    t_out = lt.export(out=str(tmp_path / f"port{suffix}"),
                      checkpoint=str(t_dir), format=fmt, part=part)
    assert t_out == tmp_path / f"port{suffix}"
    got, want = _read(t_out, fmt), _read(j_out, fmt)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    if case == "resnet":
        assert not any(k.endswith(("mean", "var")) for k in got)
    if part == "embedding_model":
        head = ("embed_head/kernel" if fmt == "numpy_state_dict"
                else "embed_head.weight")
        assert head in got


def test_embedding_model_without_a_head_is_refused(tmp_path, artifacts):
    j_dir, t_dir, _ = artifacts["vit"]
    with pytest.raises(JaxConfigError, match="no embedding head"):
        jlt.export(out=str(tmp_path / "j.npz"), checkpoint=str(j_dir),
                   format="numpy_state_dict", part="embedding_model")
    with pytest.raises(ConfigError, match="no embedding head"):
        lt.export(out=str(tmp_path / "t.npz"), checkpoint=str(t_dir),
                  format="numpy_state_dict", part="embedding_model")


@pytest.mark.parametrize("part", ["model", "embedding_model"])
def test_package_default_round_trips_through_embed(tmp_path, artifacts,
                                                   part):
    """The re-export embeds as the original does; without the head its
    metadata no longer claims ``embed_dim``, as in the JAX package."""
    _, t_dir, _ = artifacts["vit_embed"]
    again = lt.export(out=str(tmp_path / "again"), checkpoint=str(t_dir),
                      part=part)
    art, orig = load_exported_model(again), load_exported_model(t_dir)
    assert art["model_name"] == VIT and art["steps"] == 3
    assert ("embed_dim" in art) == (part == "embedding_model")
    assert ("embed_head" in art) == (part == "embedding_model")
    for k, v in orig["state_dict"].items():
        assert torch.equal(art["state_dict"][k], v), k
    data = tmp_path / "images"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        img = rng.integers(0, 256, (30, 30, 3), dtype=np.uint8)
        (data / f"{i}.ppm").write_bytes(b"P6\n30 30\n255\n" + img.tobytes())
    kwargs = dict(data=str(data), image_size=28, batch_size=2,
                  accelerator="cpu")
    got = np.load(lt.embed(out=str(tmp_path / "a.npz"),
                           checkpoint=str(again), **kwargs))["embeddings"]
    if part == "model":  # the bare backbone: the original without its head
        ref = lt.export(out=str(tmp_path / "bare"), checkpoint=str(t_dir))
    else:
        ref = t_dir
    want = np.load(lt.embed(out=str(tmp_path / "b.npz"), checkpoint=str(ref),
                            **kwargs))["embeddings"]
    assert got.shape[1] == (EMBED_DIM if part == "embedding_model"
                            else get_wrapped_model(VIT).feature_dim)
    np.testing.assert_array_equal(got, want)


def test_meta_torch_state_dict_loads_back_as_checkpoint(tmp_path,
                                                        artifacts):
    """The ViT's ``torch_state_dict`` (Meta's names), given back as
    ``checkpoint=``, converts to the exported weights bitwise."""
    _, t_dir, _ = artifacts["vit"]
    path = lt.export(out=str(tmp_path / "meta.pt"), checkpoint=str(t_dir),
                     format="torch_state_dict")
    assert "blocks.0.attn.qkv.weight" in torch.load(path)
    state, name, head = resolve_pretrained_source(str(path), VIT)
    orig = load_exported_model(t_dir)["state_dict"]
    assert name == VIT and head is None and set(state) == set(orig)
    for k, v in orig.items():
        assert torch.equal(state[k], v), k
