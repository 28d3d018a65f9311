"""A model object as ``pretrain``'s ``model``: a user's own
``torch.nn.Module`` (and the live timm and ultralytics wrappers that take
the same path), a ``WrappedModel``, and the refusal of a Flax module.

- The module's features through the port equal those through the JAX
  package's torch bridge (``wrap_torch_module``) within 1e-5 relative L2,
  in eval and in train mode, where its ``nn.BatchNorm2d`` buffers move as
  the bridge moves them.
- Two SimCLR steps of ``pretrain(model=module)`` run in both packages,
  under the same hidden name ``torch/<class>``; the user's module itself is
  left as it was.
- A run with a model object resumes bitwise, exports under its name and
  ``embed`` of the export is an eval-mode forward of the exported weights.
- DINOv2 and DINOv31 leave the module's buffers as they were, as the JAX
  bridge does where its student is applied without ``mutable``.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu.models.torch_bridge import (
    wrap_torch_module as jax_wrap_torch_module,
)
from lightly_train_tpu_torch._checkpoint.checkpoint import load_exported_model
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._data.image_dataset import (
    ImageDataset,
    list_image_files,
)
from lightly_train_tpu_torch._data.loader import PretrainLoader
from lightly_train_tpu_torch.errors import ConfigError, UnknownModelError
from lightly_train_tpu_torch.models import package_registry as R
from lightly_train_tpu_torch.models import torch_module as TM
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from test_torch_parity import rel_l2
from torch_fixtures.threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _ieee_fp32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


class SmallCNN(nn.Module):
    """Convolutions with BatchNorm, returning a dict whose ``features``
    entry is the map (and a shallower map beside it)."""

    def __init__(self, width: int = 8):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 3, 2, 1)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, 2 * width, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(2 * width)

    def forward(self, x):
        h = torch.relu(self.bn1(self.conv1(x)))
        return {"shallow": h, "features": torch.relu(self.bn2(self.conv2(h)))}


def small_cnn(seed=0):
    torch.manual_seed(seed)
    module = SmallCNN()
    with torch.no_grad():  # statistics away from their init
        for bn in (module.bn1, module.bn2):
            bn.running_mean.uniform_(-0.5, 0.5)
            bn.running_var.uniform_(0.5, 1.5)
    return module


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_features_match_the_jax_bridge(train):
    module = small_cnn()
    wrapped_j = jax_wrap_torch_module(module)
    wrapped = R.get_wrapped_model(module)
    assert (wrapped.name, wrapped.feature_dim, wrapped.patch_size,
            wrapped.architecture, wrapped.supports_mask) == (
        wrapped_j.name, wrapped_j.feature_dim, wrapped_j.patch_size,
        wrapped_j.architecture, wrapped_j.supports_mask) == (
        "torch/smallcnn", 16, None, "conv", False)
    x = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    variables = wrapped_j.module.init(jax.random.key(0),
                                      jnp.zeros((1, 32, 32, 3)))
    if train:
        ref, new = wrapped_j.module.apply(variables, jnp.asarray(x),
                                          train=True, mutable=["batch_stats"])
    else:
        ref = wrapped_j.module.apply(variables, jnp.asarray(x), train=False)
    got = wrapped.forward_features(torch.from_numpy(x), train=train)
    for key in ("features", "patch_tokens", "cls_token"):
        assert got[key].shape == ref[key].shape, key
        assert rel_l2(got[key].detach(), ref[key]) <= 1e-5, key
    buffers = {k.removeprefix("inner."): v
               for k, v in wrapped.module.named_buffers()}
    want = new["batch_stats"] if train else variables["batch_stats"]
    assert set(buffers) == set(want)
    for k, v in want.items():
        assert rel_l2(buffers[k], np.asarray(v)) <= 1e-6, k
    if train:
        assert int(buffers["bn1.num_batches_tracked"]) == 1
    # The user's module is not the one that trains.
    assert int(module.bn1.num_batches_tracked) == 0
    assert wrapped.module.inner is not module


@pytest.fixture
def data(tmp_path):
    """Eight 40 x 44 PPM images."""
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        img = rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(b"P6\n44 40\n255\n" + img.tobytes())
    return folder


SIMCLR = dict(method="simclr", batch_size=4, steps=2, precision="fp32",
              canonical_size=48, num_workers=0,
              method_args={"image_size": 32, "hidden_dim": 16,
                           "output_dim": 8})


def test_two_simclr_steps_run_in_both_packages(tmp_path, data):
    module = small_cnn()
    before = {k: v.clone() for k, v in module.state_dict().items()}
    j_state = jlt.pretrain(out=str(tmp_path / "jax"), data=str(data),
                           model=module, **SIMCLR)
    state = lt.pretrain(out=str(tmp_path / "port"), data=str(data),
                        model=module, accelerator="cpu", **SIMCLR)
    assert int(j_state.step) == state.step == 2
    assert "torch/smallcnn" not in R.list_models()
    assert R.get_wrapped_model("torch/smallcnn").module.inner is \
        state.params["student"].inner
    student = state.params["student"].inner
    # One student forward of both views a step.
    assert int(student.bn2.num_batches_tracked) == 2
    assert not torch.equal(student.bn2.running_mean,
                           before["bn2.running_mean"])
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("method", ["dinov2", "dinov31"])
def test_dinov2_leaves_the_modules_buffers(tmp_path, data, method):
    """DINOv2 and DINOv31 apply the student without ``mutable``: the JAX
    bridge then drops the module's buffer updates (a train-mode apply
    returns no state), and the port's student keeps its buffers as they
    were through the step, while the parameters train."""
    module = small_cnn()
    wrapped_j = jax_wrap_torch_module(module)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    variables = wrapped_j.module.init(jax.random.key(0), x)
    out = wrapped_j.module.apply(variables, x, train=True)
    assert set(out) == {"features", "patch_tokens", "cls_token"}
    state = lt.pretrain(
        out=str(tmp_path / "o"), data=str(data), model=module,
        method=method, accelerator="cpu", batch_size=4, steps=1,
        precision="fp32", canonical_size=48, num_workers=0,
        method_args=dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
                         local_view_count=2, global_image_size=32,
                         local_image_size=16))
    student = state.params["student"].inner
    for k, v in module.state_dict().items():
        if k.endswith(("running_mean", "running_var",
                       "num_batches_tracked")):
            assert torch.equal(student.state_dict()[k], v), k
    assert not torch.equal(student.conv1.weight, module.conv1.weight)


class _Interrupted(Exception):
    pass


def test_resume_export_and_embed_with_a_module(tmp_path, data, monkeypatch):
    """SimCLR on the module stopped after its step-2 checkpoint and resumed
    ends bitwise in the uninterrupted run's state, buffers included; its
    export is named ``torch/smallcnn`` and ``embed`` of it is the module's
    eval-mode forward on the exported weights."""
    args = dict(data=str(data), accelerator="cpu", checkpoint_every=2,
                **{**SIMCLR, "steps": 4})
    full = lt.pretrain(out=str(tmp_path / "full"), model=small_cnn(), **args)

    class Loader(PretrainLoader):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 2:
                    raise _Interrupted
                yield batch

    monkeypatch.setattr(T, "PretrainLoader", Loader)
    with pytest.raises(_Interrupted):
        lt.pretrain(out=str(tmp_path / "cut"), model=small_cnn(), **args)
    monkeypatch.undo()
    resumed = lt.pretrain(out=str(tmp_path / "cut"), model=small_cnn(),
                          resume_interrupted=True, **args)
    a, b = full.params.state_dict(), resumed.params.state_dict()
    assert a.keys() == b.keys()
    assert "student.inner.bn1.running_var" in a
    for k in a:
        assert torch.equal(a[k], b[k]), k

    art = tmp_path / "full" / "exported_models" / "exported_last"
    exported = load_exported_model(art)
    assert exported["model_name"] == "torch/smallcnn"
    path = lt.embed(out=str(tmp_path / "emb.npz"), data=str(data),
                    checkpoint=str(art), image_size=32, batch_size=3,
                    accelerator="cpu")
    emb = np.load(path)["embeddings"]
    module = small_cnn()
    module.load_state_dict({k.removeprefix("inner."): v
                            for k, v in exported["state_dict"].items()})
    module.eval()
    dataset = ImageDataset(list_image_files(data), (32, 32))
    x = torch.from_numpy(np.stack([dataset[i] for i in range(8)])) / 255.0
    with torch.no_grad():
        want = module(x.permute(0, 3, 1, 2).float())["features"].mean(
            dim=(2, 3))
    assert emb.shape == (8, 16)
    np.testing.assert_allclose(emb, want.numpy(), rtol=1e-5, atol=1e-6)


def test_a_wrapped_model_is_taken_as_it_is(tmp_path, data):
    wrapped = R.get_wrapped_model("torchvision/resnettest")
    wrapped = WrappedModel(name="custom/resnet", module=wrapped.module,
                           feature_dim=wrapped.feature_dim,
                           architecture="conv", supports_mask=False)
    state = lt.pretrain(out=str(tmp_path / "o"), data=str(data),
                        model=wrapped, accelerator="cpu", **SIMCLR)
    assert state.params["student"] is wrapped.module
    assert R.get_wrapped_model("custom/resnet") is wrapped


def test_an_object_of_a_built_in_name_leaves_the_registry(tmp_path, data):
    """A model object under a built-in name is not registered, as in the
    JAX package: ``list_models()`` and every entry stay as they were, and
    the run builds that model afresh, so a distillation student of the
    teacher's name is another module than its frozen teacher."""
    names, entries = R.list_models(), dict(R._REGISTRY)
    built_in = R.get_wrapped_model("dinov3/vitb16")
    assert R.resolve_model_name(built_in) == "dinov3/vitb16"
    assert R.get_wrapped_model("dinov3/vitb16") is not built_in
    wrapped = R.get_wrapped_model("dinov3/vittest16")
    state = lt.pretrain(
        out=str(tmp_path / "o"), data=str(data), model=wrapped,
        accelerator="cpu", batch_size=4, steps=1, precision="fp32",
        canonical_size=36, num_workers=0,
        method_args={"teacher": "dinov3/vittest16", "image_size": 32})
    assert R.list_models() == names
    assert R._REGISTRY == entries
    student, teacher = state.params["student"], state.method_state["teacher"]
    assert student is not teacher and student is not wrapped.module
    assert all(p.requires_grad for p in student.parameters())
    assert not any(p.requires_grad for p in teacher.parameters())


def test_a_flax_module_or_other_object_is_refused():
    """The port runs no Flax module (it imports no Flax); both packages
    refuse an object that is no model."""
    import flax.linen as fnn

    class UserFlax(fnn.Module):
        @fnn.compact
        def __call__(self, images):
            return fnn.Conv(8, (4, 4), strides=(4, 4))(images)

    with pytest.raises(UnknownModelError, match="Flax module"):
        R.get_wrapped_model(UserFlax())
    from lightly_train_tpu.errors import UnknownModelError as JaxUnknown
    from lightly_train_tpu.models.package_registry import (
        get_wrapped_model as jax_get_wrapped_model,
    )

    for thing in (3, object()):
        with pytest.raises(JaxUnknown):
            jax_get_wrapped_model(thing)
        with pytest.raises(UnknownModelError, match="torch module"):
            R.get_wrapped_model(thing)
    with pytest.raises(ConfigError, match="4D"):
        R.get_wrapped_model(nn.Flatten())


class _FeaturesOnly(nn.Module):
    """timm's ``features_only`` output: a list of maps."""

    def __init__(self):
        super().__init__()
        self.a = nn.Conv2d(3, 4, 3, 2, 1)
        self.b = nn.Conv2d(4, 6, 3, 2, 1)
        self.pretrained_cfg = {"input_size": (3, 48, 48)}

    def forward(self, x):
        h = self.a(x)
        return [h, self.b(h)]


class _Layer(nn.Module):
    def __init__(self, f, module):
        super().__init__()
        self.f, self.m = f, module

    def forward(self, x):
        return self.m(torch.cat(x, 1) if isinstance(x, list) else x)


def test_live_timm_and_ultralytics_models_take_the_same_path(monkeypatch):
    """Where timm or ultralytics imports, an unregistered ``timm/*`` or
    ``ultralytics/*`` name wraps the live model as a torch module (here
    stand-ins of both packages); where they do not, it raises as in the
    JAX package."""
    created = {}

    def create_model(name, pretrained, features_only):
        created[name] = (pretrained, features_only)
        return _FeaturesOnly()

    layers = [_Layer(-1, nn.Conv2d(3, 4, 3, 2, 1)),
              _Layer(-1, nn.Conv2d(4, 4, 3, 1, 1)),
              _Layer([-1, 0], nn.Conv2d(8, 5, 1)),
              _Layer(-1, nn.Flatten())]  # the head, dropped

    class YOLO:
        def __init__(self, name):
            self.model = types.SimpleNamespace(
                model=layers, eval=lambda: None)

    monkeypatch.setitem(sys.modules, "timm",
                        types.SimpleNamespace(create_model=create_model))
    monkeypatch.setitem(sys.modules, "ultralytics",
                        types.SimpleNamespace(YOLO=YOLO))
    monkeypatch.setattr(TM, "timm_available", lambda: True)
    monkeypatch.setattr(TM, "ultralytics_available", lambda: True)
    timm_model = R.get_wrapped_model("timm/efficientnet_b0")
    assert created == {"efficientnet_b0": (False, True)}
    assert (timm_model.name, timm_model.feature_dim) == (
        "timm/efficientnet_b0", 6)
    out = timm_model.forward_features(torch.zeros(2, 48, 48, 3))
    assert out["features"].shape == (2, 12, 12, 6)
    yolo = R.get_wrapped_model("ultralytics/yolov9t.pt")
    assert (yolo.name, yolo.feature_dim) == ("ultralytics/yolov9t.pt", 5)
    assert len(yolo.module.inner.layers) == 3
    out = yolo.forward_features(torch.zeros(2, 32, 32, 3))
    assert out["features"].shape == (2, 16, 16, 5)
    monkeypatch.undo()
    for name in ("timm/efficientnet_b0", "ultralytics/yolov9t.pt"):
        with pytest.raises(UnknownModelError):
            R.get_wrapped_model(name)
