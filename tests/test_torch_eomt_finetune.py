"""EoMT's three entry points end to end on the CPU, in the JAX package and
in the port: ``train_semantic_segmentation`` with a ``-eomt`` model,
``train_instance_segmentation`` on COCO JSON and on YOLO-seg labels, and
``train_panoptic_segmentation``.

Three steps of ``dinov2/vittest14`` at 28^2, batch 8 (a multiple of the
JAX tests' 8 virtual devices), fp32 with TF32 off, from the same
checkpoint-scale weights (``torch_fixtures/finetune.py::shared_init``),
with the random transforms off and both warmups one step long (so the
backbone and the heads both move). On the JAX test mesh the host
Hungarian cannot run beside the collectives, so both packages match with
``LIGHTLY_TRAIN_MATCHER=greedy``; each JAX run has a time limit of its own
(a thread joined with a timeout), so that a hang fails its test only. The
port's loss of each step is handed the uniforms the JAX step draws, taken
from the JAX keys (``fold_in(base_key, step)``, ``fold_in(k, 1)``, the
loss's splits; ``test_torch_eomt.py``'s helpers).

Held: each step's loss (1e-4 relative) and the metric keys, every
parameter after the run (rtol 1e-4, atol 1e-5; the key bias, rounding
noise that AdamW scales to full steps, is not compared), the validation
metrics, the files and the exported metadata (``architecture`` "eomt",
the resolved ``task_args``); and a semantic run stopped after its step-2
checkpoint and resumed ends bitwise where the uninterrupted one ends,
annealing included.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu.tasks import eomt_instance_panoptic as JIP
from lightly_train_tpu.tasks import eomt_semantic_segmentation as JE
from lightly_train_tpu_torch._commands import train_task as TT
from lightly_train_tpu_torch.models.from_jax import task_state_from_jax
from lightly_train_tpu_torch.ops import point_sampling as PS
from lightly_train_tpu_torch.tasks import eomt_instance_panoptic as IP
from lightly_train_tpu_torch.tasks import eomt_semantic_segmentation as E
from test_torch_eomt import _loss_draws
from torch_fixtures.eomt_data import (
    write_coco_instance,
    write_coco_panoptic,
    write_yolo_instance,
)
from torch_fixtures.finetune import shared_init, write_mask_pairs
from torch_fixtures.threads import one_torch_thread  # noqa: F401

MODEL, SIZE, STEPS, BATCH, POINTS, Q = "dinov2/vittest14", 28, 3, 8, 64, 8
DEGENERATE = "attn.k.bias"
NO_AUG = {"scale_jitter": None, "random_crop": None, "random_flip": None,
          "color_jitter": None}
TASK_ARGS = {"num_queries": Q, "num_points": POINTS,
             "lr_warmup_steps": [1, 1]}
JAX_TIME_LIMIT = 240
# name: (entry, JAX and port task models, data writer, extra task args,
#        extra run args)
RUNS = {
    "semantic": ("train_semantic_segmentation",
                 JE.EoMTSemanticSegmentationTrainModel,
                 E.EoMTSemanticSegmentationTrainModel,
                 lambda root: write_mask_pairs(root, n=6, num_classes=3),
                 {"max_active_slots": 2, "num_joint_blocks": 1}, {}),
    "instance_coco": ("train_instance_segmentation",
                      JIP.EoMTInstanceSegmentationTrainModel,
                      IP.EoMTInstanceSegmentationTrainModel,
                      write_coco_instance,
                      {"max_instances": 8, "num_joint_blocks": 1}, {}),
    "instance_yolo": ("train_instance_segmentation",
                      JIP.EoMTInstanceSegmentationTrainModel,
                      IP.EoMTInstanceSegmentationTrainModel,
                      write_yolo_instance,
                      {"max_instances": 6, "num_joint_blocks": 1}, {}),
    "panoptic": ("train_panoptic_segmentation",
                 JIP.EoMTPanopticSegmentationTrainModel,
                 IP.EoMTPanopticSegmentationTrainModel,
                 write_coco_panoptic,
                 {"max_instances": 5, "num_joint_blocks": 1}, {}),
}
VAL_KEYS = {"semantic": {"val_miou"},
            "instance_coco": {"val_mask_map", "val_mask_map50"},
            "instance_yolo": {"val_mask_map", "val_mask_map50"},
            "panoptic": {"val_pq"}}


def _args(name, out, data, **kwargs):
    entry, _, _, _, task_args, extra = RUNS[name]
    return dict(out=str(out), data=data, model=f"{MODEL}-eomt", steps=STEPS,
                batch_size=BATCH, image_size=SIZE, precision="fp32",
                num_workers=2, log_every=1, val_every=STEPS,
                learning_rate=2e-3, transform_args=NO_AUG,
                task_args={**TASK_ARGS, **task_args}, **extra, **kwargs)


def _with_time_limit(fn, seconds):
    """``fn()`` in a daemon thread; fails the test where it has not ended
    within ``seconds``."""
    result = {}

    def run():
        try:
            result["value"] = fn()
        except BaseException as e:  # re-raised in the test's thread
            result["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(seconds)
    if thread.is_alive():
        pytest.fail(f"the JAX run did not end within {seconds} s")
    if "error" in result:
        raise result["error"]
    return result["value"]


def _step_draws(model, step: int):
    """The uniforms of the JAX train step ``step``'s loss, in the port's
    order: each joint block's releases, then each level's point draws."""
    k = jax.random.fold_in(jax.random.key(0), step)
    rng_trunk, rng_loss, _ = jax.random.split(jax.random.fold_in(k, 1), 3)
    a = model.args
    J = a.num_joint_blocks
    draws = [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(rng_trunk, j), (BATCH, Q)))) for j in range(J)]
    K = (getattr(a, "max_instances", None) if isinstance(
        model, IP.EoMTInstanceSegmentationTrainModel)
        else min(a.max_active_slots or a.num_classes, a.num_classes))
    for li in range(J + 1):
        draws += _loss_draws(jax.random.fold_in(rng_loss, li), K,
                             n_points=POINTS, batch=BATCH)
    return draws


def _jax_draws(monkeypatch, p_cls):
    """The port's ``loss_fn`` of ``p_cls`` handed the JAX step's draws."""
    inner = p_cls.loss_fn

    def loss_fn(self, model, batch, generator, step):
        with PS.injected(_step_draws(self, step)):
            return inner(self, model, batch, generator, step)

    monkeypatch.setattr(p_cls, "loss_fn", loss_fn)


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, tmp_path_factory):
    name = request.param
    entry, j_cls, p_cls, write, _, _ = RUNS[name]
    root = tmp_path_factory.mktemp(name)
    data = write(root / "data")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIGHTLY_TRAIN_MATCHER", "greedy")
        held = shared_init(mp, j_cls, p_cls, SIZE)
        j_state, j_val = _with_time_limit(
            lambda: getattr(jlt, entry)(**_args(name, root / "jax", data)),
            JAX_TIME_LIMIT)
        torch.backends.cuda.matmul.allow_tf32 = False
        _jax_draws(mp, p_cls)
        p_state, p_val = getattr(lt, entry)(
            **_args(name, root / "port", data, accelerator="cpu"))
    return dict(name=name, root=root, held=held, j_state=j_state,
                j_val=j_val, p_state=p_state, p_val=p_val, data=data)


def _records(out):
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


def test_losses_and_metric_keys_match(runs):
    got, want = _records(runs["root"] / "port"), _records(runs["root"] / "jax")
    hp, j_hp = got[0]["hyperparams"], want[0]["hyperparams"]
    for key in ("task", "resolved_steps", "resolved_batch_size",
                "model_name", "architecture", "steps", "image_size"):
        assert hp[key] == j_hp[key], key
    assert hp["architecture"] == "eomt"
    train = [(r, j) for r, j in zip(got[1:], want[1:]) if "train_loss" in r]
    assert len(train) == STEPS
    for r, j in zip(got[1:], want[1:]):
        assert set(r) == set(j)
    for r, j in train:
        np.testing.assert_allclose(r["train_loss"], j["train_loss"],
                                   rtol=1e-4)
        np.testing.assert_allclose(r["grad_norm"], j["grad_norm"], rtol=1e-4)
        if "loss_final" in j:
            np.testing.assert_allclose(r["loss_final"], j["loss_final"],
                                       rtol=1e-4)


def test_parameters_match(runs):
    ref = task_state_from_jax(jax.device_get(runs["j_state"].params))
    got = runs["p_state"].params.state_dict()
    assert set(ref) == set(got)
    start = task_state_from_jax(runs["held"]["params"])
    moved = set()
    for name, r in ref.items():
        if name.endswith(DEGENERATE):
            continue
        if not torch.equal(start[name], r):
            moved.add(name.split(".")[1])
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert {"blocks", "queries", "class_head", "upscale0"} <= moved
    assert runs["p_state"].step == int(runs["j_state"].step) == STEPS


def test_val_metrics_match(runs):
    j_val, p_val = runs["j_val"], runs["p_val"]
    assert set(p_val) == set(j_val) == VAL_KEYS[runs["name"]]
    for key, value in j_val.items():
        assert p_val[key] == pytest.approx(value, abs=1e-6), key


def test_files_and_exports_match(runs):
    port, ref = runs["root"] / "port", runs["root"] / "jax"
    assert sorted(p.name for p in port.iterdir()) == sorted(
        p.name for p in ref.iterdir())
    for name in ("exported_best", "exported_last"):
        meta = f"exported_models/{name}/metadata.json"
        got = json.loads((port / meta).read_text())
        assert got == json.loads((ref / meta).read_text())
        assert got["architecture"] == "eomt"
        assert got["task_args"]["num_joint_blocks"] == 1


class StopAfterTwo(TT.PretrainLoader):
    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            if i == 2:
                raise KeyboardInterrupt
            yield batch


def test_stop_and_resume_matches_the_uninterrupted_run(tmp_path,
                                                       monkeypatch):
    """A semantic run of 4 steps (its joint block annealing over steps
    1-2 of the run) stopped after its step-2 checkpoint and resumed: the
    losses of steps 3 and 4 and the parameters bitwise the uninterrupted
    run's."""
    data = write_mask_pairs(tmp_path / "data", n=6, num_classes=3)
    kw = dict(steps=4, save_every=2, val_every=4, accelerator="cpu",
              transform_args={})
    straight, _ = lt.train_semantic_segmentation(
        **{**_args("semantic", tmp_path / "straight", data), **kw})
    monkeypatch.setattr(TT, "PretrainLoader", StopAfterTwo)
    with pytest.raises(KeyboardInterrupt):
        lt.train_semantic_segmentation(
            **{**_args("semantic", tmp_path / "resumed", data), **kw})
    monkeypatch.undo()
    resumed, _ = lt.train_semantic_segmentation(
        **{**_args("semantic", tmp_path / "resumed", data), **kw},
        resume_interrupted=True)
    assert resumed.step == straight.step == 4
    for name, value in straight.params.state_dict().items():
        assert torch.equal(resumed.params.state_dict()[name], value), name
    losses = {out: [r["train_loss"] for r in _records(tmp_path / out)
                    if "train_loss" in r] for out in ("straight", "resumed")}
    assert len(losses["resumed"]) == 4
    assert losses["resumed"][2:] == losses["straight"][2:]
