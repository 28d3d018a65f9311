"""The port's fine-tuning task models against the JAX package's, one step
at a time, and the entry points' refusals, warm start and resume.

Each task model (classification with label smoothing, trained and frozen,
on ``dinov2/vittest14`` and ``torchvision/resnettest``; the linear
segmentation probe; both multihead models) gets the same checkpoint-scale
weights (``models/from_jax.py::task_state_from_jax``) and the same
normalized batch in both packages, fp32 with TF32 off: the loss and its
metrics (1e-5 relative), every gradient (1e-4 relative, atol 1e-6; through a
train-mode BatchNorm CNN 1e-4 relative L2 a leaf, the CNN tests' rule; a
frozen backbone's are zero in JAX and absent in the port) and the validation
statistics (confusion matrices equal, sums 1e-5), tiled above the training
size, and their reduction to the final metrics. The inputs have no exact
ties among the logits, so argmax and top-5 agree.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.tasks import image_classification as JIC
from lightly_train_tpu.tasks import multihead as JMH
from lightly_train_tpu.tasks import semantic_segmentation_linear as JSEG
from lightly_train_tpu_torch._commands import train_task as TT
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.models.from_jax import task_state_from_jax
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.tasks import image_classification as IC
from lightly_train_tpu_torch.tasks import multihead as MH
from lightly_train_tpu_torch.tasks import semantic_segmentation_linear as SEG
from torch_fixtures.finetune import (
    checkpoint_scale,
    write_class_folders,
    write_mask_pairs,
)
from torch_fixtures.threads import one_torch_thread  # noqa: F401

B, NC = 4, 5
HEADS = {"a": 1.0, "b": 0.25}
CASES = {
    "cls_vit": (JIC.ImageClassificationTrainModel, JIC.ImageClassificationArgs,
                IC.ImageClassificationTrainModel, IC.ImageClassificationArgs,
                "dinov2/vittest14", 28, {"label_smoothing": 0.1}),
    "cls_vit_frozen": (JIC.ImageClassificationTrainModel,
                       JIC.ImageClassificationArgs,
                       IC.ImageClassificationTrainModel,
                       IC.ImageClassificationArgs, "dinov2/vittest14", 28,
                       {"freeze_backbone": True}),
    "cls_cnn": (JIC.ImageClassificationTrainModel, JIC.ImageClassificationArgs,
                IC.ImageClassificationTrainModel, IC.ImageClassificationArgs,
                "torchvision/resnettest", 32, {"label_smoothing": 0.2}),
    "seg_vit": (JSEG.LinearSemanticSegmentationTrainModel,
                JSEG.LinearSemanticSegmentationArgs,
                SEG.LinearSemanticSegmentationTrainModel,
                SEG.LinearSemanticSegmentationArgs, "dinov2/vittest14", 28, {}),
    "seg_cnn_trained": (JSEG.LinearSemanticSegmentationTrainModel,
                        JSEG.LinearSemanticSegmentationArgs,
                        SEG.LinearSemanticSegmentationTrainModel,
                        SEG.LinearSemanticSegmentationArgs,
                        "torchvision/resnettest", 64,
                        {"freeze_backbone": False}),
    "cls_multihead": (JMH.ImageClassificationMultiheadTrainModel,
                      JMH.ImageClassificationMultiheadArgs,
                      MH.ImageClassificationMultiheadTrainModel,
                      MH.ImageClassificationMultiheadArgs, "dinov2/vittest14",
                      28, {"head_lr_multipliers": HEADS}),
    "seg_multihead": (JMH.SemanticSegmentationMultiheadTrainModel,
                      JMH.SemanticSegmentationMultiheadArgs,
                      MH.SemanticSegmentationMultiheadTrainModel,
                      MH.SemanticSegmentationMultiheadArgs,
                      "dinov2/vittest14", 28,
                      {"head_lr_multipliers": HEADS}),
}


def _models(case):
    j_cls, j_args, p_cls, p_args, model, size, extra = CASES[case]
    args = {"num_classes": NC, **extra}
    j_model = j_cls(jax_get_wrapped_model(model, dtype=jnp.float32),
                    j_args(**args))
    p_model = p_cls(get_wrapped_model(model), p_args(**args))
    shapes = jax.eval_shape(j_model.init, jax.random.key(0),
                            {"images": jnp.zeros((2, size, size, 3))})
    params = jax.device_get(checkpoint_scale(shapes[0], 1))
    model_state = jax.tree_util.tree_map(
        lambda x: np.full(x.shape, 0.0 if x.shape else 0, x.dtype), shapes[1])
    if "batch_stats" in model_state:
        model_state = jax.device_get(checkpoint_scale(model_state, 2))
    module = p_model.init(torch.Generator().manual_seed(0),
                          torch.device("cpu"))
    module.load_state_dict(task_state_from_jax(params, model_state))
    return j_model, p_model, params, model_state, module, size


def _batch(case, size, seed=0, val=False):
    rng = np.random.default_rng(seed)
    batch = {"images": rng.standard_normal((B, size, size, 3)).astype(
        np.float32)}
    if case.startswith("cls"):
        batch["labels"] = rng.integers(0, NC, B).astype(np.int32)
    else:
        masks = rng.integers(0, NC, (B, size, size)).astype(np.int32)
        masks[:, :3, :5] = 255
        batch["masks"] = masks
    if val:
        batch["valid"] = np.array([True] * (B - 1) + [False])
    return batch


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradients_match_jax(case):
    torch.backends.cuda.matmul.allow_tf32 = False
    j_model, p_model, params, model_state, module, size = _models(case)
    batch = _batch(case, size)

    def loss(p):
        return j_model.loss_fn(p, model_state, {
            k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.key(0), jnp.int32(0))

    (j_loss, (_, j_metrics)), j_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    p_loss, p_metrics = p_model.loss_fn(
        module, {k: torch.from_numpy(v) for k, v in batch.items()}, None, 0)
    p_loss.backward()
    np.testing.assert_allclose(p_loss.item(), float(j_loss), rtol=1e-5)
    assert set(p_metrics) == set(j_metrics)
    for key, value in j_metrics.items():
        np.testing.assert_allclose(float(p_metrics[key]), float(value),
                                   rtol=1e-5)
    want = task_state_from_jax(jax.device_get(j_grads))
    frozen = p_model.freeze_backbone
    for name, p in module.named_parameters():
        if name.endswith("attn.k.bias"):
            continue  # the exact gradient is zero: rounding noise
        if frozen and name.startswith("backbone."):
            assert p.grad is None and not p.requires_grad
            assert not want[name].any(), name
            continue
        # A leaf the loss does not reach (the mask token) has no gradient.
        grad = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        if "cnn" in case:
            # Train-mode BatchNorm's backward (test_torch_cnn_methods.py's
            # rule): relative L2 a leaf.
            assert _rel(grad, want[name].numpy()) <= 1e-4, name
        else:
            np.testing.assert_allclose(grad, want[name].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_val_statistics_match_jax(case):
    """Segmentation validates at twice the training size, tiled."""
    j_model, p_model, params, model_state, module, size = _models(case)
    val_size = 2 * size if case.startswith("seg") else size
    j_model.val_tile_size = p_model.val_tile_size = size
    batch = _batch(case, val_size, seed=1, val=True)
    want = jax.device_get(jax.jit(j_model.val_step)(
        params, model_state, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = p_model.val_step(module, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith("confusion"):
            np.testing.assert_array_equal(got[key].numpy(), value)
            assert got[key].dtype == torch.float32
        else:
            np.testing.assert_allclose(got[key].numpy(), value, rtol=1e-5)
    assert p_model.val_finalize(got) == pytest.approx(
        j_model.val_finalize(want), rel=1e-5)
    assert p_model.watch_metric == j_model.watch_metric


@pytest.mark.parametrize("case", ["cls_multihead", "seg_multihead"])
def test_multihead_lr_scales_match_jax(case):
    j_model, p_model, params, _, module, _ = _models(case)
    scales = j_model.lr_scales(params)
    want = task_state_from_jax(jax.tree_util.tree_map(
        lambda s, p: np.full(p.shape, s, np.float32), scales, params))
    got = p_model.lr_scales(dict(module.named_parameters()))
    assert set(got) == set(want)
    for name, value in got.items():
        assert torch.all(want[name] == value), name
    assert sorted(set(got.values())) == [0.25, 1.0]


@pytest.mark.parametrize("case", ["cls_vit", "seg_vit", "cls_multihead",
                                  "seg_multihead"])
def test_predict_matches_jax(case):
    j_model, p_model, params, model_state, module, size = _models(case)
    images = _batch(case, size, seed=2)["images"]
    want = np.asarray(j_model.predict({"params": params, **model_state},
                                      jnp.asarray(images)))
    with torch.no_grad():
        got = p_model.predict(module, torch.from_numpy(images)).numpy()
    if case.startswith("cls"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


def test_multihead_segmentation_refuses_a_trained_backbone():
    _, p_model, _, _, module, size = _models("seg_multihead")
    p_model.args.freeze_backbone = False
    with pytest.raises(NotImplementedError, match="FROZEN backbone"):
        p_model.loss_fn(module, {k: torch.from_numpy(v) for k, v in
                                 _batch("seg_multihead", size).items()},
                        None, 0)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _classify(tmp_path, out="out", **kwargs):
    data = (tmp_path / "data" if (tmp_path / "data").exists()
            else write_class_folders(tmp_path / "data", n_train=4, n_val=2))
    if not isinstance(data, dict):
        data = {"train": str(data / "train"), "val": str(data / "val")}
    args = dict(out=str(tmp_path / out), data=data, model="dinov2/vittest14",
                steps=3, batch_size=4, image_size=28, precision="fp32",
                num_workers=1, log_every=1, accelerator="cpu")
    args.update(kwargs)
    return lt.train_image_classification(**args)


@pytest.mark.parametrize("command,item", [
    ("predict_semantic_segmentation", "15"), ("export_onnx", "16"),
    ("extract_video_frames", "17")])
def test_unported_entry_points_name_their_item(tmp_path, capsys, command,
                                               item):
    """Every ``train_*`` entry point runs with every model family; what is
    left unported are the CLI's commands of items 15, 16 and 17, which
    exit 2 naming their item and write nothing."""
    from lightly_train_tpu_torch._cli import NOT_PORTED, main

    assert NOT_PORTED[command] == item
    assert main([command, f"out={tmp_path / 'out'}"]) == 2
    assert f"ROADMAP item {item}" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("entry", ["train_semantic_segmentation",
                                   "train_instance_segmentation",
                                   "train_panoptic_segmentation"])
def test_eomt_is_refused_before_anything_is_built(tmp_path, entry):
    """EoMT on a CNN backbone is refused before the output folder is
    made."""
    from torch_fixtures.eomt_data import (
        write_coco_instance,
        write_coco_panoptic,
    )

    data = {"train_semantic_segmentation": lambda r: write_mask_pairs(r),
            "train_instance_segmentation": write_coco_instance,
            "train_panoptic_segmentation": write_coco_panoptic}[entry](
        tmp_path / "data")
    with pytest.raises(ConfigError, match="EoMT needs a ViT backbone"):
        getattr(lt, entry)(out=str(tmp_path / "out"), data=data,
                           model="torchvision/resnettest-eomt",
                           accelerator="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("kwargs,error,match", [
    ({"checkpoint": "auto"}, NotImplementedError, "ROADMAP item 20"),
    ({"transform_args": {"channel_drop": {}}}, NotImplementedError,
     "ROADMAP item 19"),
    ({"accelerator": "cuda"}, RuntimeError, "no CUDA device"),
    ({"task_args": {"num_clases": 3}}, ConfigError, "num_classes"),
    ({"optim": "adamw9"}, ConfigError, "Unknown optimizer"),
])
def test_entry_point_refusals(tmp_path, monkeypatch, kwargs, error, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        _classify(tmp_path, **kwargs)


def test_a_checkpoint_sharing_no_names_is_refused(tmp_path):
    """A task export (``backbone.*``, ``head.*``) as the backbone's
    checkpoint merges nothing: the JAX package's ConfigError."""
    _classify(tmp_path, steps=1)
    with pytest.raises(ConfigError, match="shares no parameter names"):
        _classify(tmp_path, out="again", checkpoint=str(
            tmp_path / "out" / "exported_models" / "exported_last"))


def test_warm_start_from_a_pretrain_export(tmp_path):
    """``checkpoint=`` a ``pretrain`` export: the backbone starts from it
    (every tensor equal after 0 steps' worth: the head is fresh)."""
    from lightly_train_tpu_torch._checkpoint.checkpoint import export_model

    backbone = get_wrapped_model("dinov2/vittest14").module
    backbone.reset_parameters(torch.Generator().manual_seed(5))
    export_model(tmp_path / "pre", "dinov2/vittest14", backbone.state_dict())
    seen = {}
    run = TT.run_task_training

    def spy(config, train_model, *args):
        seen["pretrained"] = args[-1]
        return run(config, train_model, *args)

    TT.run_task_training = spy
    try:
        state, _ = _classify(tmp_path, steps=1, learning_rate=0.0,
                             checkpoint=str(tmp_path / "pre"))
    finally:
        TT.run_task_training = run
    got = state.params.backbone.state_dict()
    for name, value in backbone.state_dict().items():
        assert torch.equal(got[name], value), name
    assert set(seen["pretrained"]) == set(backbone.state_dict())


def test_resume_continues_the_same_batch_stream(tmp_path, monkeypatch):
    """A run stopped after its step-2 checkpoint and resumed ends bitwise
    where the uninterrupted run ends (random transforms on: each step's
    generator is seeded from (seed, step), and the loader skips the
    consumed batches)."""
    straight, _ = _classify(tmp_path, out="straight", save_every=1)

    class StopAfterTwo(TT.PretrainLoader):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 2:
                    raise KeyboardInterrupt
                yield batch

    monkeypatch.setattr(TT, "PretrainLoader", StopAfterTwo)
    with pytest.raises(KeyboardInterrupt):
        _classify(tmp_path, out="resumed", save_every=1)
    monkeypatch.undo()
    assert sorted(p.name for p in (tmp_path / "resumed" / "checkpoints")
                  .iterdir()) == ["step_1.pt", "step_2.pt"]
    resumed, _ = _classify(tmp_path, out="resumed", save_every=1,
                           resume_interrupted=True)
    assert resumed.step == straight.step == 3
    for name, value in straight.params.state_dict().items():
        assert torch.equal(resumed.params.state_dict()[name], value), name
    records = [json.loads(line) for line in (
        tmp_path / "resumed" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train_loss" in r] == [1, 2, 3]


def test_segmentation_multihead_end_to_end(tmp_path):
    data = write_mask_pairs(tmp_path / "data", n=4)
    state, val = lt.train_semantic_segmentation_multihead(
        out=str(tmp_path / "out"), data=data, model="dinov2/vittest14",
        steps=2, batch_size=4, image_size=28, val_image_size=42,
        precision="fp32", num_workers=1, log_every=1, accelerator="cpu",
        task_args={"head_lr_multipliers": HEADS})
    assert state.step == 2
    assert set(val) == {"val_miou_a", "val_miou_b", "val_miou_best"}
    assert val["val_miou_best"] == max(val["val_miou_a"], val["val_miou_b"])
    meta = json.loads((tmp_path / "out" / "exported_models" / "exported_best"
                       / "metadata.json").read_text())
    assert meta["task"] == "semantic_segmentation_multihead"
    assert meta["task_args"]["head_lr_multipliers"] == HEADS
    assert not any(p.requires_grad for p in state.params.backbone.parameters())


def test_a_task_without_a_schema_gets_the_shared_flip():
    """A task model without a transform schema (the detection tasks of
    ROADMAP item 14) is flipped and normalized, and refuses
    ``transform_args`` as the JAX runtime does."""
    _, p_model, *_ = _models("cls_vit")
    p_model.transform_kind = None
    config = TT.config_validate(TT.TrainTaskConfig, {
        "out": "unused", "model": "dinov2/vittest14", "hflip_prob": 1.0})
    fn = TT._build_transform(config, p_model, torch.float32)
    images = torch.arange(2 * 3 * 4 * 3, dtype=torch.uint8).reshape(2, 3, 4, 3)
    out = fn({"images": images}, torch.Generator().manual_seed(0))
    want = TT._device_val_transform({"images": images.flip(2)},
                                    torch.float32)["images"]
    assert torch.equal(out["images"], want)
    config.transform_args = {"random_flip": None}
    with pytest.raises(ConfigError, match="transform_args is not supported"):
        TT._build_transform(config, p_model, torch.float32)
