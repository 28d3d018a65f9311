"""The CNN backbones of the port (ResNet with RT-DETR's "vd", DINOv3
ConvNeXt, ShuffleNetV2), the model names, the ResNet and ConvNeXt
converters, and the runtime around a CNN's BatchNorm state, against the
JAX package.

- *Backbones*: ``resnettest``, ``resnettestvd`` (at 72^2 and 200^2, whose
  odd feature maps take the "vd" shortcut's padded average pool),
  ``shufflenettest``, ``convnext-test`` and a full-width ResNet-50 at 64^2,
  from checkpoint-scale weights and running statistics carried by
  ``variables_from_jax``, in train and in eval mode: every output within
  1e-5 relative L2 (float32, TF32 off; in train mode, or within the JAX
  package's own distance from itself when the batch is permuted, where
  that is larger) and the updated statistics within 1e-5.
- *Names*: every one of the JAX package's 66 public names resolves in the
  port to the same wrapped name, feature width, patch size and parameter
  and statistics shapes (built on the meta device against ``eval_shape``
  of the JAX init); so do the hidden test sizes and suffixed names and
  the timm patterns.
- *Converters*: torchvision-named ResNet and DINOv3-named ConvNeXt state
  dicts, bitwise as the JAX conversion; ``checkpoint=`` and a ResNet
  ``teacher_weights`` take them.
- *Runtime*: ``embed`` of a CNN export equals an eval-mode forward of the
  exported weights (with and without ``embed_dim``); a warm start carries
  the export's statistics into the student and the EMA teacher's copy; the
  NaN replay restores the checkpoint's statistics.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu.errors import UnknownModelError as JaxUnknownModel
from lightly_train_tpu.methods import distillationv3 as JV3
from lightly_train_tpu.models import convert as JC
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.models.package_registry import (
    list_models as jax_list_models,
)
from lightly_train_tpu_torch._checkpoint.checkpoint import load_exported_model
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._debug import NaNGuard, replay_nan_capture
from lightly_train_tpu_torch.errors import UnknownModelError
from lightly_train_tpu_torch.methods import distillationv3 as V3
from lightly_train_tpu_torch.models import from_jax
from lightly_train_tpu_torch.models.convert import (
    load_torch_checkpoint_for_model,
)
from lightly_train_tpu_torch.models.from_jax import variables_from_jax
from lightly_train_tpu_torch.models.package_registry import (
    get_wrapped_model,
    list_models,
)
from test_torch_parity import rel_l2
from torch_fixtures.threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _ieee_fp32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def checkpoint_scale(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "var"):
            return 1.0 + 0.2 * np.abs(rng.standard_normal(x.shape))
        if name == "gamma":
            return 0.5 + 0.2 * rng.standard_normal(x.shape)
        return 0.5 * rng.standard_normal(x.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: np.asarray(leaf(p, x), np.float32), tree)


# (model, input size)
BACKBONES = [
    ("torchvision/resnettest", 64),
    ("torchvision/resnettestvd", 72),
    ("torchvision/resnettestvd", 200),
    ("torchvision/shufflenettest", 72),
    ("dinov3/convnext-test", 64),
    ("torchvision/resnet50", 64),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("model,size", BACKBONES)
def test_backbone_matches_jax(model, size, train):
    wrapped_j = jax_get_wrapped_model(model)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    # The tree's shapes only (no init to compile), drawn at checkpoint
    # scale.
    variables = checkpoint_scale(jax.eval_shape(lambda: wrapped_j.init(
        jax.random.key(0), jnp.zeros((1, size, size, 3)))), 1)
    module = get_wrapped_model(model).module
    module.load_state_dict(variables_from_jax(variables))
    stateful = "batch_stats" in variables
    if train and stateful:
        ref, new_state = wrapped_j.module.apply(
            variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = wrapped_j.module.apply(variables, jnp.asarray(x), train=train)
    got = module(torch.from_numpy(x), train=train)
    # In train mode the batch statistics couple the samples, and BatchNorm
    # amplifies rounding down a deep stack: the JAX package's own outputs
    # move when only the batch order changes (a full-width ResNet-50 at
    # 64^2, 16 samples a channel in its last stage: by 3.4e-4). The port
    # is held to 1e-5 or to that distance of the JAX package from itself,
    # whichever is larger.
    perm = np.array([1, 3, 0, 2])
    if train and stateful:
        again, _ = wrapped_j.module.apply(
            variables, jnp.asarray(x[perm]), train=True,
            mutable=["batch_stats"])
        back = np.argsort(perm)
    else:
        again, back = ref, np.arange(4)

    def tol(mine, ref_out):
        return max(1e-5, rel_l2(np.asarray(mine)[back], ref_out))

    for key in ("features", "cls_token", "patch_tokens"):
        assert got[key].shape == ref[key].shape, key
        assert rel_l2(got[key].detach(), ref[key]) <= tol(again[key],
                                                          ref[key]), key
    assert len(got["stage_features"]) == len(ref["stage_features"])
    for g, r, a in zip(got["stage_features"], ref["stage_features"],
                       again["stage_features"]):
        assert g.shape == r.shape
        assert rel_l2(g.detach(), r) <= tol(a, r)
    buffers = dict(module.named_buffers())
    if train and stateful:
        want = variables_from_jax(jax.device_get(new_state))
        assert set(want) == set(buffers)
        for name, value in want.items():
            assert rel_l2(buffers[name], value) <= 1e-5, name
            assert not torch.equal(
                buffers[name], variables_from_jax(variables)[name])
    else:  # eval mode reads the statistics and leaves them
        for name, value in buffers.items():
            assert torch.equal(value, variables_from_jax(variables)[name])


def _shapes_of_jax(model):
    """The port's names and shapes of the JAX init's parameters and
    statistics, from ``eval_shape`` mapped onto zero-stride views."""
    wrapped = jax_get_wrapped_model(model)
    shapes = jax.eval_shape(lambda: wrapped.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3))))
    out = {}
    for collection in shapes.values():
        views = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
            collection)
        for name, value in from_jax._flatten(views).items():
            path, value = from_jax._convert_leaf(name, value)
            out[path] = tuple(value.shape)
    return out, wrapped


JAX_NAMES = jax_list_models()
PORTED_HIDDEN = ["torchvision/resnettest", "torchvision/resnettestvd",
                 "torchvision/resnet50vd", "rtdetr/rtdetr_rtestvd",
                 "torchvision/shufflenettest", "dinov3/convnext-test",
                 "ecvit/ecvittest", "ultralytics/yolov8test",
                 "ultralytics/yolov8n-seg.pt", "ultralytics/yolov5test",
                 "ultralytics/yolov5su.pt", "ultralytics/yolo11test",
                 "ultralytics/yolo11n-cls.pt",
                 "super_gradients/yolo_nas_test"]
TIMM_PATTERNS = ["timm/resnet101", "timm/resnet34", "timm/resnettestvd",
                 "timm/convnext_large", "timm/shufflenet_v2_x0_5",
                 "timm/vit_base_patch16_384", "timm/vit_small_patch14"]


def test_the_port_lists_44_of_the_66_names():
    """The port lists all 66 of the JAX package's public names (44 until
    the ECViT, ultralytics and super_gradients families were ported)."""
    assert len(JAX_NAMES) == 66
    assert list_models() == JAX_NAMES


@pytest.mark.parametrize("name", JAX_NAMES + PORTED_HIDDEN + TIMM_PATTERNS)
def test_a_name_resolves_as_in_jax(name):
    want, wrapped_j = _shapes_of_jax(name)
    with torch.device("meta"):
        wrapped = get_wrapped_model(name)
    assert (wrapped.name, wrapped.feature_dim, wrapped.patch_size,
            wrapped.architecture, wrapped.supports_mask) == (
        wrapped_j.name, wrapped_j.feature_dim, wrapped_j.patch_size,
        wrapped_j.architecture, wrapped_j.supports_mask)
    module = wrapped.module
    ours = {n: tuple(t.shape) for n, t in
            [*module.named_parameters(), *module.named_buffers()]}
    assert ours == want
    # A CNN config has no ``depth``: DINOv2's layer decay reads it.
    assert hasattr(module.cfg, "depth") == hasattr(wrapped_j.module.cfg,
                                                   "depth")


def test_an_unknown_timm_name_raises_as_without_timm():
    with pytest.raises(JaxUnknownModel):
        jax_get_wrapped_model("timm/efficientnet_b0")
    with pytest.raises(UnknownModelError):
        get_wrapped_model("timm/efficientnet_b0")
    with pytest.raises(UnknownModelError):
        get_wrapped_model("ecvit/nonesuch")


def torchvision_resnet_state_dict(stage_sizes, bottleneck, width, seed):
    """A torchvision-named ResNet state dict (with ``num_batches_tracked``
    and the ``fc`` head, which the conversion drops)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def bn(prefix, c):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = t(c), t(c)
        sd[f"{prefix}.running_mean"] = t(c)
        sd[f"{prefix}.running_var"] = t(c).abs() + 0.5
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(7)

    sd["conv1.weight"] = t(width, 3, 7, 7)
    bn("bn1", width)
    in_ch = width
    for s, n in enumerate(stage_sizes):
        f = width * 2 ** s
        out = 4 * f if bottleneck else f
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            if bottleneck:
                sd[f"{p}.conv1.weight"] = t(f, in_ch, 1, 1)
                sd[f"{p}.conv2.weight"] = t(f, f, 3, 3)
                sd[f"{p}.conv3.weight"] = t(out, f, 1, 1)
                bn(f"{p}.bn1", f), bn(f"{p}.bn2", f), bn(f"{p}.bn3", out)
            else:
                sd[f"{p}.conv1.weight"] = t(f, in_ch, 3, 3)
                sd[f"{p}.conv2.weight"] = t(f, f, 3, 3)
                bn(f"{p}.bn1", f), bn(f"{p}.bn2", f)
            if b == 0 and (in_ch != out or s > 0):
                sd[f"{p}.downsample.0.weight"] = t(out, in_ch, 1, 1)
                bn(f"{p}.downsample.1", out)
            in_ch = out
    sd["fc.weight"], sd["fc.bias"] = t(10, in_ch), t(10)
    return sd


def dinov3_convnext_state_dict(depths, dims, seed):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    sd = {"downsample_layers.0.0.weight": t(dims[0], 3, 4, 4),
          "downsample_layers.0.0.bias": t(dims[0]),
          "downsample_layers.0.1.weight": t(dims[0]),
          "downsample_layers.0.1.bias": t(dims[0]),
          "norm.weight": t(dims[-1]), "norm.bias": t(dims[-1])}
    for i in range(1, 4):
        sd[f"downsample_layers.{i}.0.weight"] = t(dims[i - 1])
        sd[f"downsample_layers.{i}.0.bias"] = t(dims[i - 1])
        sd[f"downsample_layers.{i}.1.weight"] = t(dims[i], dims[i - 1], 2, 2)
        sd[f"downsample_layers.{i}.1.bias"] = t(dims[i])
    for s, n in enumerate(depths):
        d = dims[s]
        for b in range(n):
            p = f"stages.{s}.{b}."
            sd[p + "dwconv.weight"], sd[p + "dwconv.bias"] = t(d, 1, 7, 7), t(d)
            sd[p + "norm.weight"], sd[p + "norm.bias"] = t(d), t(d)
            sd[p + "pwconv1.weight"] = t(4 * d, d)
            sd[p + "pwconv1.bias"] = t(4 * d)
            sd[p + "pwconv2.weight"] = t(d, 4 * d)
            sd[p + "pwconv2.bias"] = t(d)
            sd[p + "gamma"] = t(d)
    return sd


CONVERT = {
    "torchvision/resnettest": lambda: torchvision_resnet_state_dict(
        (1, 1, 1, 1), False, 8, 0),
    "timm/resnet50": lambda: torchvision_resnet_state_dict(
        (3, 4, 6, 3), True, 64, 1),
    "dinov3/convnext-test": lambda: dinov3_convnext_state_dict(
        (1, 1, 1, 1), (8, 16, 32, 64), 2),
    "dinov3/convnext-tiny": lambda: {
        f"backbone.{k}": v for k, v in dinov3_convnext_state_dict(
            (3, 3, 9, 3), (96, 192, 384, 768), 3).items()},
}


@pytest.mark.parametrize("model", sorted(CONVERT))
def test_conversion_is_the_jax_conversion_bitwise(tmp_path, model):
    path = tmp_path / "weights.pth"
    torch.save({"model": CONVERT[model]()}, path)
    got = load_torch_checkpoint_for_model(path, model)
    want = variables_from_jax(JC.load_torch_checkpoint_for_model(path, model))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name
    # Every parameter and statistic of the model, nothing else.
    module = get_wrapped_model(model).module
    assert set(module.state_dict()) == set(got)
    module.load_state_dict(got)


@pytest.fixture
def images(tmp_path):
    """Eight 40 x 44 PPM images."""
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        img = rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(b"P6\n44 40\n255\n" + img.tobytes())
    return folder


RUN = dict(accelerator="cpu", batch_size=4, precision="fp32",
           canonical_size=48, num_workers=0, log_every=1)
SMALL_DINO = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
                  local_view_count=2, global_image_size=32,
                  local_image_size=16)


def test_checkpoint_pth_starts_the_student_from_the_conversion(
        tmp_path, images, monkeypatch):
    """``checkpoint=`` a torchvision ResNet ``.pth``: the student and the
    EMA teacher's copy start from its conversion, statistics included."""
    path = tmp_path / "resnet.pth"
    torch.save(CONVERT["torchvision/resnettest"](), path)
    seen = {}
    original = T._load_pretrained

    def spy(params, method_state, pretrained, config):
        original(params, method_state, pretrained, config)
        seen["student"] = {k: v.clone() for k, v in
                           params["student"].state_dict().items()}
        seen["teacher"] = {k: v.clone() for k, v in method_state[
            "teacher"]["student"].state_dict().items()}

    monkeypatch.setattr(T, "_load_pretrained", spy)
    lt.pretrain(out=str(tmp_path / "out"), data=str(images),
                model="torchvision/resnettest", method="dino", steps=1,
                checkpoint=str(path), method_args=SMALL_DINO, **RUN)
    want = load_torch_checkpoint_for_model(path, "torchvision/resnettest")
    for who in ("student", "teacher"):
        assert set(seen[who]) == set(want)
        for k, v in want.items():
            assert torch.equal(seen[who][k], v), (who, k)


def test_a_resnet_teacher_from_a_pth_is_the_jax_packages(tmp_path):
    """Distillation from a ResNet ``teacher_weights`` file: the frozen
    teacher holds the JAX distillation's teacher variables, running
    statistics included, bitwise."""
    path = tmp_path / "resnet.pth"
    torch.save(CONVERT["torchvision/resnettest"](), path)
    args = dict(teacher="torchvision/resnettest", teacher_weights=str(path),
                image_size=32, queue_size=16)
    method = V3.DistillationV3(get_wrapped_model("dinov2/vittest14"),
                               V3.DistillationV3Args(**args))
    _, method_state = method.init(torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    j_method = JV3.DistillationV3(jax_get_wrapped_model("dinov2/vittest14"),
                                  JV3.DistillationV3Args(**args))
    want = variables_from_jax(jax.device_get(j_method._teacher_variables_init))
    got = method_state["teacher"].state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("embed_dim", [None, 24])
def test_embed_of_a_cnn_export_is_its_eval_forward(tmp_path, images,
                                                   embed_dim):
    """``embed`` builds the exported ResNet and runs it in eval mode on the
    exported running statistics (which the run moved), then the exported
    head where there is one."""
    out = tmp_path / "run"
    lt.pretrain(out=str(out), data=str(images),
                model="torchvision/resnettest", method="simclr", steps=2,
                embed_dim=embed_dim,
                method_args={"image_size": 32, "hidden_dim": 16,
                             "output_dim": 8}, **RUN)
    art = out / "exported_models" / "exported_last"
    exported = load_exported_model(art)
    assert exported["model_name"] == "torchvision/resnettest"
    assert any(k.endswith(".mean") for k in exported["state_dict"])
    assert any(not torch.equal(v, torch.zeros_like(v)) for k, v in
               exported["state_dict"].items() if k.endswith(".mean"))
    path = lt.embed(out=str(tmp_path / "emb.npz"), data=str(images),
                    checkpoint=str(art), image_size=32, batch_size=3,
                    accelerator="cpu")
    emb = np.load(path)["embeddings"]
    wrapped = get_wrapped_model("torchvision/resnettest")
    wrapped.module.load_state_dict(exported["state_dict"])
    from lightly_train_tpu_torch._data.image_dataset import (
        ImageDataset,
        list_image_files,
    )

    dataset = ImageDataset(list_image_files(images), (32, 32))
    x = torch.from_numpy(np.stack([dataset[i] for i in range(8)])) / 255.0
    with torch.no_grad():
        want = wrapped.forward_pool(wrapped.forward_features(x))
        if embed_dim is not None:
            head = exported["embed_head"]
            want = want @ head["weight"].T + head["bias"]
    assert emb.shape == (8, embed_dim or wrapped.feature_dim)
    np.testing.assert_allclose(emb, want.numpy(), rtol=1e-5, atol=1e-6)


def test_a_warm_start_carries_the_statistics(tmp_path, images, monkeypatch):
    """``checkpoint=`` an export folder: the new run's student and its EMA
    teacher's copy start from the export's weights and statistics."""
    first = tmp_path / "first"
    lt.pretrain(out=str(first), data=str(images),
                model="torchvision/resnettest", method="dino", steps=2,
                method_args=SMALL_DINO, **RUN)
    art = first / "exported_models" / "exported_last"
    exported = load_exported_model(art)["state_dict"]
    seen = {}
    original = T._load_pretrained

    def spy(params, method_state, pretrained, config):
        original(params, method_state, pretrained, config)
        seen["student"] = {k: v.clone() for k, v in
                           params["student"].named_buffers()}
        seen["teacher"] = {k: v.clone() for k, v in method_state[
            "teacher"]["student"].named_buffers()}

    monkeypatch.setattr(T, "_load_pretrained", spy)
    lt.pretrain(out=str(tmp_path / "second"), data=str(images),
                model="torchvision/resnettest", method="dino", steps=1,
                checkpoint=str(art), method_args=SMALL_DINO, **RUN)
    for who in ("student", "teacher"):
        assert seen[who]
        for k, v in seen[who].items():
            assert torch.equal(v, exported[k]), (who, k)


def test_the_nan_replay_restores_the_statistics(tmp_path, images,
                                                monkeypatch):
    """A capture of DINO's second step on a ResNet (forced by a guard that
    reports it non-finite) replays from the step-1 checkpoint to bitwise
    the loss that step logged: DINO's teacher reads the running
    statistics, so the replay has the checkpoint's."""

    class Guard(NaNGuard):
        def check(self, finite, step, batch, generator_state, params=None):
            if step == 1:
                try:
                    super().check(False, step, batch, generator_state)
                except Exception:
                    pass

    monkeypatch.setattr(T, "NaNGuard", Guard)
    out = tmp_path / "run"
    lt.pretrain(out=str(out), data=str(images),
                model="torchvision/resnettest", method="dino", steps=2,
                checkpoint_every=1, method_args=SMALL_DINO, **RUN)
    (out / "checkpoints" / "step_2.pt").unlink()
    logged = [json.loads(line) for line in
              (out / "metrics.jsonl").read_text().splitlines()]
    loss = [r for r in logged if r.get("step") == 2][0]["train_loss"]
    report = replay_nan_capture(out)
    assert report["restored_checkpoint_step"] == 1 and report["step"] == 1
    assert report["loss"] == loss
