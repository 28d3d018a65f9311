"""``train_image_classification`` and linear ``train_semantic_segmentation``
end to end on the CPU, in the JAX package and in the port.

Three steps of ``dinov2/vittest14`` at 28^2, batch 8 (a multiple of the JAX
tests' 8 virtual devices), fp32 with TF32 off, from the same
checkpoint-scale weights (``torch_fixtures/finetune.py``: both packages'
task inits patched to return them), with the random transforms off so
both see the same pixels; drop path is 0. Both read the same images in the
same order (the loaders' shared numpy stream). Held: the logged losses
(rtol 1e-4) and metric keys, every parameter after the run (rtol 1e-4,
atol 1e-5; the key bias, whose exact gradient is zero, is rounding noise
that AdamW scales to full steps and is not compared), the val metrics
(argmax-based ones equal, the loss 1e-4), the files and exported metadata,
the resolved batch and steps, and the learning rate of every step.

The segmentation run trains the frozen-backbone probe and validates at
56^2, twice the training size, so validation runs tiled (3 x 3 tiles of
28^2). Its frozen backbone has no gradient, yet both packages shrink each
decayed leaf by ``1 - lr * wd`` a step (AdamW's decoupled decay on a zero
update): checked against that product on both sides.
"""

import json

import jax
import numpy as np
import pytest
import torch

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu.tasks import image_classification as JIC
from lightly_train_tpu.tasks import semantic_segmentation_linear as JSEG
from lightly_train_tpu_torch._optim.optimizers import no_weight_decay_mask
from lightly_train_tpu_torch.models.from_jax import task_state_from_jax
from lightly_train_tpu_torch.tasks import image_classification as IC
from lightly_train_tpu_torch.tasks import semantic_segmentation_linear as SEG
from torch_fixtures.finetune import (
    shared_init,
    write_class_folders,
    write_mask_pairs,
)
from torch_fixtures.threads import one_torch_thread  # noqa: F401

MODEL, SIZE, STEPS, LR = "dinov2/vittest14", 28, 3, 2e-3
DEGENERATE = "attn.k.bias"
NO_AUG = {
    "image_classification": {"random_crop": None, "random_flip": None,
                             "color_jitter": None},
    "semantic_segmentation": {"scale_jitter": None, "random_crop": None,
                              "random_flip": None, "color_jitter": None},
}
TASKS = {
    "image_classification": (JIC.ImageClassificationTrainModel,
                             IC.ImageClassificationTrainModel,
                             "train_image_classification", {}),
    "semantic_segmentation": (JSEG.LinearSemanticSegmentationTrainModel,
                              SEG.LinearSemanticSegmentationTrainModel,
                              "train_semantic_segmentation",
                              {"val_image_size": 2 * SIZE}),
}


def _run(pkg, out, data, task, **kwargs):
    args = dict(out=str(out), data=data, model=MODEL, steps=STEPS,
                batch_size=8, image_size=SIZE, precision="fp32",
                num_workers=2, log_every=1, val_every=STEPS,
                learning_rate=LR, transform_args=NO_AUG[task],
                **TASKS[task][3], **kwargs)
    if pkg is lt:
        args["accelerator"] = "cpu"
    return getattr(pkg, TASKS[task][2])(**args)


@pytest.fixture(scope="module", params=sorted(TASKS))
def runs(request, tmp_path_factory):
    task = request.param
    root = tmp_path_factory.mktemp(task)
    data = (write_class_folders(root / "data")
            if task == "image_classification"
            else write_mask_pairs(root / "data"))
    with pytest.MonkeyPatch.context() as mp:
        held = shared_init(mp, TASKS[task][0], TASKS[task][1], SIZE)
        j_state, j_val = _run(jlt, root / "jax", data, task)
        torch.backends.cuda.matmul.allow_tf32 = False
        p_state, p_val = _run(lt, root / "port", data, task)
    return dict(task=task, root=root, held=held, j_state=j_state,
                j_val=j_val, p_state=p_state, p_val=p_val)


def _records(out):
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


def test_losses_and_metrics_match(runs):
    got, want = _records(runs["root"] / "port"), _records(runs["root"] / "jax")
    hp, j_hp = got[0]["hyperparams"], want[0]["hyperparams"]
    for key in ("task", "resolved_steps", "resolved_batch_size",
                "model_name", "steps", "image_size", "val_image_size"):
        assert hp[key] == j_hp[key], key
    assert hp.get("classes") == j_hp.get("classes")
    assert hp.get("architecture") == j_hp.get("architecture")
    assert [r["step"] for r in got[1:]] == [r["step"] for r in want[1:]]
    train = [(r, j) for r, j in zip(got[1:], want[1:]) if "train_loss" in r]
    assert len(train) == STEPS
    for r, j in zip(got[1:], want[1:]):
        assert set(r) == set(j)
    for r, j in train:
        np.testing.assert_allclose(r["train_loss"], j["train_loss"],
                                   rtol=1e-4)
        for key in ("train_acc",):
            if key in j:
                assert r[key] == j[key]
        np.testing.assert_allclose(r["grad_norm"], j["grad_norm"], rtol=1e-4)


def test_parameters_match(runs):
    ref = task_state_from_jax(jax.device_get(runs["j_state"].params),
                              jax.device_get(runs["j_state"].model_state))
    got = runs["p_state"].params.state_dict()
    assert set(ref) == set(got)
    moved = 0
    for name, r in ref.items():
        if name.endswith(DEGENERATE):
            continue
        start = task_state_from_jax(runs["held"]["params"])[name]
        moved += int(not torch.equal(start, r))
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert moved > 0
    assert runs["p_state"].step == int(runs["j_state"].step) == STEPS


def test_val_metrics_match(runs):
    j_val, p_val = runs["j_val"], runs["p_val"]
    assert set(j_val) == set(p_val)
    for key, value in j_val.items():
        if key == "val_loss":
            np.testing.assert_allclose(p_val[key], value, rtol=1e-4)
        else:
            assert p_val[key] == pytest.approx(value, abs=1e-12), key
    keys = ({"val_loss", "val_top1", "val_top5", "val_f1"}
            if runs["task"] == "image_classification"
            else {"val_loss", "val_miou"})
    assert set(p_val) == keys


def test_files_and_exports_match(runs):
    port, ref = runs["root"] / "port", runs["root"] / "jax"
    assert sorted(p.name for p in port.iterdir()) == sorted(
        p.name for p in ref.iterdir())
    assert sorted(p.name for p in (port / "checkpoints").iterdir()) == sorted(
        f"step_{p.name}.pt" for p in (ref / "checkpoints").iterdir()
        if p.name.isdigit())
    for name in ("exported_best", "exported_last"):
        meta = f"exported_models/{name}/metadata.json"
        assert json.loads((port / meta).read_text()) == json.loads(
            (ref / meta).read_text())
    assert (port / "visualizations" / "first_batch_labels.png").is_file()


def test_learning_rate_of_every_step_matches(runs):
    j_cls, p_cls = TASKS[runs["task"]][:2]
    j_sched = j_cls.lr_schedule(None, LR, STEPS)
    p_sched = runs["p_state"].updater.learning_rate
    for step in range(STEPS):
        assert p_sched(step) == pytest.approx(float(j_sched(step)), rel=1e-6)


def test_backbone_frozen_or_trained(runs):
    """The probe's backbone gets no gradient, yet every decayed leaf
    shrinks by (1 - lr_t * wd) a step in both packages and the others
    stay; the classification backbone trains."""
    start = task_state_from_jax(runs["held"]["params"])
    p_model = runs["p_state"].params
    backbone = {n: p for n, p in p_model.named_parameters()
                if n.startswith("backbone.")}
    if runs["task"] == "image_classification":
        assert all(p.requires_grad for p in backbone.values())
        assert not torch.equal(backbone["backbone.blocks.0.mlp.fc1.weight"],
                               start["backbone.blocks.0.mlp.fc1.weight"])
        return
    shrink = np.prod([1.0 - runs["p_state"].updater.learning_rate(t) * 0.05
                      for t in range(STEPS)])
    j_end = task_state_from_jax(jax.device_get(runs["j_state"].params))
    decays = no_weight_decay_mask(dict(p_model.named_parameters()))
    assert not any(p.requires_grad for p in backbone.values())
    assert sum(decays[n] for n in backbone) > 0
    for name, p in backbone.items():
        want = start[name] * (shrink if decays[name] else 1.0)
        for got in (p.detach(), j_end[name]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
