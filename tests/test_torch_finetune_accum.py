"""Two more end-to-end fine-tuning runs in both packages: gradient
accumulation with label smoothing on a BatchNorm CNN, and the multihead
classification probe.

As ``test_torch_finetune.py``: three steps at batch 8 from shared
checkpoint-scale weights, fp32, TF32 off, the random transforms off.

- ``train_image_classification`` of ``torchvision/resnettest`` at 32^2
  with ``grad_accum_steps=2`` and ``label_smoothing=0.1``: the JAX package
  scans the two microbatches, averaging gradients, loss and metrics and
  carrying the BatchNorm statistics from one microbatch to the next; the
  port loops over them with the statistics in its buffers. Losses 1e-4,
  parameters and running statistics 1e-4 relative L2 a leaf (the CNN
  tests' rule).
- ``train_image_classification_multihead`` of ``dinov2/vittest14``: two
  heads at lr multipliers 1 and 0.1 on a frozen backbone; each head's
  logged loss, its parameters after the run, ``val_top1_<head>`` and
  ``val_top1_best``, and ``exported_best`` picked by it.
"""

import json

import jax
import numpy as np
import pytest
import torch

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu.tasks import image_classification as JIC
from lightly_train_tpu.tasks import multihead as JMH
from lightly_train_tpu_torch.models.from_jax import task_state_from_jax
from lightly_train_tpu_torch.tasks import image_classification as IC
from lightly_train_tpu_torch.tasks import multihead as MH
from torch_fixtures.finetune import shared_init, write_class_folders
from torch_fixtures.threads import one_torch_thread  # noqa: F401

STEPS = 3
NO_AUG = {"random_crop": None, "random_flip": None, "color_jitter": None}
HEADS = {"fast": 1.0, "slow": 0.1}
RUNS = {
    "accum_cnn": ("train_image_classification", JIC.ImageClassificationTrainModel,
                  IC.ImageClassificationTrainModel,
                  dict(model="torchvision/resnettest", image_size=32,
                       grad_accum_steps=2,
                       task_args={"label_smoothing": 0.1})),
    "multihead": ("train_image_classification_multihead",
                  JMH.ImageClassificationMultiheadTrainModel,
                  MH.ImageClassificationMultiheadTrainModel,
                  dict(model="dinov2/vittest14", image_size=28,
                       task_args={"head_lr_multipliers": HEADS})),
}
DEGENERATE = "attn.k.bias"


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, tmp_path_factory):
    name = request.param
    entry, j_cls, p_cls, kwargs = RUNS[name]
    root = tmp_path_factory.mktemp(name)
    data = write_class_folders(root / "data")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        held = shared_init(mp, j_cls, p_cls, kwargs["image_size"])
        for pkg, tag in ((jlt, "jax"), (lt, "port")):
            args = dict(out=str(root / tag), data=data, steps=STEPS,
                        batch_size=8, precision="fp32", num_workers=2,
                        log_every=1, val_every=1, learning_rate=2e-3,
                        transform_args=NO_AUG, **kwargs)
            if pkg is lt:
                args["accelerator"] = "cpu"
                torch.backends.cuda.matmul.allow_tf32 = False
            out[tag] = getattr(pkg, entry)(**args)
    return dict(name=name, root=root, held=held, out=out)


def _records(out):
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()][1:]


def test_logged_steps_match(runs):
    got = _records(runs["root"] / "port")
    want = _records(runs["root"] / "jax")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for r, j in zip(got, want):
        assert set(r) == set(j)
        for key, value in j.items():
            if key.startswith("profiling/") or key == "time":
                continue
            if key.startswith("val_top1") or key == "train_acc":
                assert r[key] == value, key
            else:
                np.testing.assert_allclose(r[key], value, rtol=1e-4,
                                           err_msg=f"step {j['step']} {key}")
    if runs["name"] == "multihead":
        keys = set().union(*got)
        assert {"loss_fast", "loss_slow", "val_top1_fast", "val_top1_slow",
                "val_top1_best"} <= keys


def test_parameters_and_statistics_match(runs):
    j_state, _ = runs["out"]["jax"]
    p_state, _ = runs["out"]["port"]
    ref = task_state_from_jax(jax.device_get(j_state.params),
                              jax.device_get(j_state.model_state))
    got = p_state.params.state_dict()
    assert set(ref) == set(got)
    start = task_state_from_jax(runs["held"]["params"],
                                runs["held"]["model_state"])
    moved = [n for n in ref if not torch.equal(start[n], ref[n])]
    assert moved
    for name, r in ref.items():
        if name.endswith(DEGENERATE):
            continue
        if runs["name"] == "accum_cnn":
            # The CNN tests' rule (test_torch_cnn_methods.py): relative L2
            # a leaf, since AdamW turns an element's near-zero gradient,
            # where the two packages' convolution backwards round apart,
            # into a step of either sign.
            assert rel_l2(got[name], r) <= 1e-4, name
        else:
            np.testing.assert_allclose(got[name].numpy(), r.numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    if runs["name"] == "accum_cnn":
        assert any(n.endswith(".mean") for n in moved)


def test_multihead_scales_and_best_export(runs):
    """The updater scales the slow head's steps by 0.1 and the rest by 1,
    and exported_best holds the first step whose best head scored
    highest; the single-head run has no scales."""
    if runs["name"] != "multihead":
        state, _ = runs["out"]["port"]
        assert state.updater.lr_scales is None
        return
    state, val = runs["out"]["port"]
    scales = dict(zip(state.updater.names, state.updater.lr_scales))
    assert scales["heads.slow.fc.weight"] == 0.1
    assert scales["heads.fast.fc.bias"] == 1.0
    assert scales["backbone.cls_token"] == 1.0
    records = _records(runs["root"] / "port")
    best = max(r["val_top1_best"] for r in records if "val_top1_best" in r)
    first = min(r["step"] for r in records
                if r.get("val_top1_best") == best)
    meta = json.loads((runs["root"] / "port" / "exported_models"
                       / "exported_best" / "metadata.json").read_text())
    assert meta["steps"] == first
    assert meta["task"] == "image_classification_multihead"
    assert val["val_top1_best"] == max(val["val_top1_fast"],
                                       val["val_top1_slow"])
