"""``train_instance_segmentation`` with a ``-ltdetr`` model and
``train_object_detection`` with PicoDet end to end on the CPU, in the JAX
package and in the port.

Three steps at batch 8 (a multiple of the JAX tests' 8 virtual devices),
fp32 with TF32 off, from the same checkpoint-scale weights, with the flip
off:

- ``coco_vit_edgecrafter``: ``dinov2/vittest14-ltdetr`` on a COCO
  instance JSON, the EdgeCrafter mask head (its point draws handed to the
  port from the JAX step's keys: ``fold_in(base_key, step)``,
  ``fold_in(k, 1)``, the loss's split);
- ``yolo_ecvit_linear``: ``ecvit/ecvittest-ltdetr`` on YOLO-seg labels,
  the linear mask head, ``grad_accum_steps`` 2;
- ``picodet``: ``picodet-s`` at the test preset (``task_args={
  "model_size": "test"}``) on YOLO boxes at 64^2, its default SGD.

On the JAX test mesh the host callbacks cannot run beside the
collectives, so both packages match with ``LIGHTLY_TRAIN_MATCHER=greedy``
(the exact matcher is held in ``test_torch_ltdetr_seg.py``).

Held, as ``test_torch_ltdetr_finetune.py`` holds detection: the metric
keys, the hyperparameters and the exported metadata (``architecture``
"ltdetr" or "picodet", the resolved ``task_args``); every parameter,
BatchNorm statistic and EMA parameter after the run within 1e-5 of its
leaf's largest value (of 1 where that is smaller), but for the elements
whose exact gradient is 0 (picked out by the JAX package's gradient of
one loss on the run's train images, below 1e-7 of its largest element;
a leaf left out whole only where ``STRUCTURAL_ZEROS`` names it), whose
rounding noise AdamW would scale to full steps; the validation metrics,
equal; each step's loss, its terms and the gradient norm within 1e-5
relative.

The segmentation runs step with SGD at lr 1 (``SEG_RUN``; LT-DETR's
AdamW default is held end to end in ``test_torch_ltdetr_finetune.py``),
ECViT-test's with the two-pass BatchNorm variance in both packages
(``test_torch_ltdetr.py`` says why). PicoDet's run holds its
BatchNorms on their running statistics in both packages
(``_eval_batch_norm``), runs the JAX package on one device with SimOTA
eager on the host (``test_torch_picodet.py::_eager_simota``: the jitted
JAX SimOTA can drop a prior at its threshold), and steps with its
default SGD. A PicoDet run stopped after its step-2 checkpoint and
resumed (train mode) ends bitwise where the uninterrupted one ends, its
EMA and BatchNorm statistics included.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu._commands import train_task as JTT
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.tasks.detection import ltdetr_seg as JS
from lightly_train_tpu.tasks.detection import picodet as JP
from lightly_train_tpu_torch._commands import train_task as TT
from lightly_train_tpu_torch.models.from_jax import task_state_from_jax
from lightly_train_tpu_torch.ops import point_sampling as PS
from lightly_train_tpu_torch.tasks.detection import ltdetr_seg as S
from lightly_train_tpu_torch.tasks.detection import picodet as P
from test_torch_eomt_finetune import StopAfterTwo, _with_time_limit
from lightly_train_tpu.parallel.mesh import get_default_mesh
from test_torch_ltdetr import _scale, _two_pass_variance
from test_torch_picodet import _eager_simota
from test_torch_ltdetr_seg import point_draws
from torch_fixtures.detection_data import write_detection
from torch_fixtures.eomt_data import write_coco_instance, write_yolo_instance
from torch_fixtures.threads import one_torch_thread  # noqa: F401

STEPS, BATCH = 3, 8
SEG_ARGS = dict(num_queries=8, d_model=32, num_heads=2, dim_feedforward=48,
                num_decoder_layers=2, csp_blocks=1, num_points=[2, 2, 2],
                dfine_bins=17, max_instances=6)
# SGD: AdamW's first steps follow the sign of each gradient element, so
# an element whose gradient nearly cancels moves by a different fraction
# of a step in each package (by 3% in a fresh process).
SEG_RUN = {"optim": "sgd", "learning_rate": 1.0}
# name: (entry, model, size, JAX and port task models, data writer, task
#        args, extra run args)
RUNS = {
    "coco_vit_edgecrafter": (
        "train_instance_segmentation", "dinov2/vittest14-ltdetr", 56,
        JS.LTDETRInstanceSegmentationTrainModel,
        S.LTDETRInstanceSegmentationTrainModel, write_coco_instance,
        SEG_ARGS, SEG_RUN),
    "yolo_ecvit_linear": (
        "train_instance_segmentation", "ecvit/ecvittest-ltdetr", 64,
        JS.LTDETRInstanceSegmentationTrainModel,
        S.LTDETRInstanceSegmentationTrainModel, write_yolo_instance,
        {**SEG_ARGS, "mask_head_arch": "linear"},
        {**SEG_RUN, "grad_accum_steps": 2}),
    "picodet": (
        "train_object_detection", "picodet-s", 64, JP.PicoDetTrainModel,
        P.PicoDetTrainModel,
        lambda root: write_detection(root, n=BATCH, size=64, num_classes=3,
                                     boxes=(2, 6)),
        {"model_size": "test"}, {}),
}
JAX_TIME_LIMIT = 300
# The leaves whose exact gradient is 0 whole: a bias whose per-channel
# constant the next train-mode BatchNorm removes, an attention key bias,
# an unused table.
_BN_FED = {"backbone.encoder.input_proj0_norm.bias",
           "backbone.encoder.input_proj1_norm.bias",
           "backbone.encoder.encoder0_layer0.norm2.bias"}
STRUCTURAL_ZEROS = {
    "coco_vit_edgecrafter": _BN_FED | {
        "backbone.backbone_sta.norms0.bias",
        "backbone.backbone_sta.norms1.bias",
        "backbone.backbone_sta.norms2.bias",
        "backbone.backbone_sta.sta.conv4_norm.bias",
        "backbone.trunk.norm.bias",
        "backbone.trunk.blocks.0.attn.k.bias",
        "backbone.trunk.blocks.1.attn.k.bias",
        "backbone.trunk.mask_token",
        "backbone.decoder.denoising_class_embed"},
    "yolo_ecvit_linear": _BN_FED | {
        "backbone.trunk.projector0.norm.bias",
        "backbone.trunk.projector1.norm.bias",
        "backbone.trunk.projector2.norm.bias",
        "backbone.decoder.denoising_class_embed"},
    "picodet": set(),
}


def _args(name, out, data, **kwargs):
    _, model, size, _, _, _, task_args, extra = RUNS[name]
    return dict(out=str(out), data=data, model=model, steps=STEPS,
                batch_size=BATCH, image_size=size, precision="fp32",
                num_workers=2, log_every=1, val_every=STEPS, hflip_prob=0.0,
                task_args=dict(task_args), **extra, **kwargs)


def _shared_init(mp, j_cls, p_cls):
    """Both packages' inits return the same checkpoint-scale parameters
    (and the JAX init's BatchNorm state)."""
    held = {}
    j_init, p_init = j_cls.init, p_cls.init

    def jax_init(self, rng, sample_batch):
        params, model_state = j_init(self, rng, sample_batch)
        if "params" not in held:
            held["params"] = _scale(params, 0)
            held["model_state"] = jax.device_get(model_state)
        return (jax.tree_util.tree_map(jnp.asarray, held["params"]),
                held["model_state"])

    def port_init(self, generator, device):
        module = p_init(self, generator, device)
        module.load_state_dict(task_state_from_jax(held["params"],
                                                   held["model_state"]))
        return module

    mp.setattr(j_cls, "init", jax_init)
    mp.setattr(p_cls, "init", port_init)
    return held


def _hand_over_point_draws(mp, accum, size):
    """The port's point draws, in call order, from the JAX steps' keys."""
    calls = []
    inner = S.LTDETRInstanceSegmentationTrainModel.loss_fn

    def loss_fn(self, model, batch, generator, step):
        mb = len(calls) % accum
        calls.append(step)
        k_loss = jax.random.fold_in(jax.random.fold_in(jax.random.key(0),
                                                       step), 1)
        keys = jax.random.split(k_loss, accum) if accum > 1 else [k_loss]
        k_pts, _ = jax.random.split(keys[mb])
        draws = (point_draws(k_pts, batch["seg_labels"].numel(), size)
                 if self.args.mask_head_arch == "edgecrafter" else [])
        with PS.injected(draws):
            return inner(self, model, batch, generator, step)

    mp.setattr(S.LTDETRInstanceSegmentationTrainModel, "loss_fn", loss_fn)
    return calls


def _train_batch(name, data):
    """Every train image of the run (6) with its targets, as the JAX
    package's validation transform gives them."""
    from lightly_train_tpu_torch.tasks.detection.data import (
        YOLOObjectDetectionDataset,
    )
    from lightly_train_tpu_torch.tasks.eomt_instance_panoptic import (
        COCOInstanceSegmentationDataset,
        YOLOInstanceSegmentationDataset,
    )

    size = RUNS[name][2]
    split, hw = data["train"], (size, size)
    if name == "picodet":
        ds = YOLOObjectDetectionDataset(split["images"], split["labels"], hw)
    elif "labels" in split:
        ds = YOLOInstanceSegmentationDataset(split["images"], split["labels"],
                                             data["num_classes"], hw, 6)
    else:
        ds = COCOInstanceSegmentationDataset(split["images"],
                                             split["annotations"], hw, 6)
    items = [ds[i] for i in range(len(ds))]
    batch = {k: jnp.asarray(np.stack([it[k] for it in items]))
             for k in items[0]}
    return JTT._device_val_transform(batch, jnp.float32)


def _degenerate(held, name, data, num_classes):
    """{name: bool mask} of the parameter elements whose exact gradient is
    0: the JAX package's gradient of one loss on the run's train images,
    below 1e-7 of its largest element; none for PicoDet's SGD."""
    _, model, size, j_cls, _, _, task_args, _ = RUNS[name]
    if name == "picodet":
        # SGD scales a gradient's rounding noise by the learning rate, not
        # to a full step: nothing is left out.
        return {}
    j_model = j_cls(
        jax_get_wrapped_model(model.removesuffix("-ltdetr"),
                              dtype=jnp.float32),
        JS.InstanceSegmentationLTDETRArgs(num_classes=num_classes, **{
            **task_args, "num_points": (2, 2, 2)}))
    batch = _train_batch(name, data)
    grads = jax.jit(jax.grad(lambda p: j_model.loss_fn(
        p, held["model_state"], batch, jax.random.key(0), 0)[0]))(
        held["params"])
    grads = task_state_from_jax(jax.device_get(grads))
    top = max(float(g.abs().max()) for g in grads.values())
    # AdamW's update m / (sqrt(v) + 1e-8) follows a gradient's rounding
    # where the gradient is within a hundred times its epsilon.
    mask = {n: g.abs() < max(1e-7 * top, 1e-6) for n, g in grads.items()}
    whole = {n for n, m in mask.items() if bool(m.all())}
    assert whole <= STRUCTURAL_ZEROS[name], whole - STRUCTURAL_ZEROS[name]
    for n in STRUCTURAL_ZEROS[name]:
        mask[n] = torch.ones_like(mask[n])
    return mask


def _eval_batch_norm(mp):
    """Both packages' PicoDet steps with the BatchNorms on their running
    statistics: a train-mode PicoDet forward moves by up to 1.4e-3 when
    only the batch order changes (``test_torch_picodet.py``, which holds
    the train-mode step and the statistics), and over three steps that
    moves SimOTA's assignment (its loss 4.7% apart at step 3 in a trial
    run, the same at step 1)."""
    j_fwd, p_fwd = JP.PicoDetTrainModel._forward, P.PicoDetTrainModel._forward
    mp.setattr(JP.PicoDetTrainModel, "_forward",
               lambda self, p, s, x, train, rng=None: j_fwd(self, p, s, x,
                                                            False, rng))
    mp.setattr(P.PicoDetTrainModel, "_forward",
               lambda self, m, x, train: p_fwd(self, m, x, False))


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, tmp_path_factory):
    name = request.param
    entry, _, size, j_cls, p_cls, write, _, extra = RUNS[name]
    root = tmp_path_factory.mktemp(name)
    data = write(root / "data")
    accum = extra.get("grad_accum_steps", 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIGHTLY_TRAIN_MATCHER", "greedy")
        if name == "yolo_ecvit_linear":
            _two_pass_variance(mp)
        if name == "picodet":
            # One device, so that SimOTA's host callback runs beside no
            # collective.
            mp.setattr(JTT, "get_default_mesh",
                       lambda: get_default_mesh(jax.devices()[:1]))
            _eager_simota(mp)
            _eval_batch_norm(mp)
        held = _shared_init(mp, j_cls, p_cls)
        j_state, j_val = _with_time_limit(
            lambda: getattr(jlt, entry)(**_args(name, root / "jax", data)),
            JAX_TIME_LIMIT)
        torch.backends.cuda.matmul.allow_tf32 = False
        calls = _hand_over_point_draws(mp, accum, size)
        p_state, p_val = getattr(lt, entry)(
            **_args(name, root / "port", data, accelerator="cpu"))
        meta = json.loads((root / "jax" / "exported_models" / "exported_last"
                           / "metadata.json").read_text())
        num_classes = meta["task_args"]["num_classes"]
        degenerate = _degenerate(held, name, data, num_classes)
    return dict(name=name, root=root, held=held, j_state=j_state,
                j_val=j_val, p_state=p_state, p_val=p_val, calls=calls,
                degenerate=degenerate, accum=accum)


def _records(out):
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]


def test_losses_metrics_and_hyperparameters_match(runs):
    got, want = _records(runs["root"] / "port"), _records(runs["root"] / "jax")
    hp, j_hp = got[0]["hyperparams"], want[0]["hyperparams"]
    for key in ("task", "resolved_steps", "resolved_batch_size",
                "model_name", "architecture", "steps", "image_size",
                "model", "grad_accum_steps"):
        assert hp[key] == j_hp[key], key
    picodet = runs["name"] == "picodet"
    assert hp["architecture"] == ("picodet" if picodet else "ltdetr")
    train = [(r, j) for r, j in zip(got[1:], want[1:]) if "train_loss" in r]
    assert len(train) == STEPS
    for r, j in zip(got[1:], want[1:]):
        assert set(r) == set(j)
    rtol = 1e-5
    for r, j in train:
        for key, value in j.items():
            if key.startswith(("train_loss", "grad_norm", "loss_",
                               "mask_loss")):
                np.testing.assert_allclose(r[key], value, rtol=rtol,
                                           err_msg=key)
    assert picodet or "mask_loss" in train[0][1]
    assert len(runs["calls"]) == (0 if picodet else STEPS * runs["accum"])


def _close(got, want, degenerate):
    assert set(got) == set(want)
    for name, w in want.items():
        diff = (got[name].float() - w.float()).abs()
        if name in degenerate:
            diff = torch.where(degenerate[name], 0.0, diff)
        tol = 1e-5 * max(float(w.abs().max()), 1.0)
        assert float(diff.max()) <= tol, (name, float(diff.max()), tol, int(
            (diff > tol).sum()), diff.numel())


def test_parameters_statistics_and_ema_match(runs):
    j = runs["j_state"]
    want = task_state_from_jax(jax.device_get(j.params),
                               jax.device_get(j.model_state))
    got = runs["p_state"].params.state_dict()
    _close(got, want, runs["degenerate"])
    want_ema = task_state_from_jax(jax.device_get(j.ema_params))
    _close(runs["p_state"].method_state["ema"], want_ema, runs["degenerate"])
    start = task_state_from_jax(runs["held"]["params"])
    assert any(not torch.equal(got[n], start[n]) for n in start)
    if runs["name"] != "picodet":
        assert any(not torch.equal(got[n], start[n]) for n in start
                   if n.startswith("mask_head."))


def test_validation_and_exports_match(runs):
    assert runs["p_val"] == runs["j_val"]
    assert set(runs["p_val"]) == ({"val_map", "val_map50"}
                                  if runs["name"] == "picodet" else
                                  {"val_mask_map", "val_mask_map50"})
    for art in ("exported_last", "exported_best"):
        p_meta = json.loads((runs["root"] / "port" / "exported_models" / art
                             / "metadata.json").read_text())
        j_meta = json.loads((runs["root"] / "jax" / "exported_models" / art
                             / "metadata.json").read_text())
        for key in ("architecture", "task", "task_args", "steps",
                    "model_name"):
            assert p_meta[key] == j_meta[key], key


def test_picodet_stop_and_resume_matches_the_uninterrupted_run(
        tmp_path, monkeypatch):
    """A PicoDet run of 4 steps stopped after its step-2 checkpoint and
    resumed: the losses of steps 3 and 4, the parameters, the BatchNorm
    statistics and the EMA bitwise the uninterrupted run's."""
    data = RUNS["picodet"][5](tmp_path / "data")
    kw = dict(steps=4, save_every=2, val_every=4, accelerator="cpu")
    straight, _ = lt.train_object_detection(
        **{**_args("picodet", tmp_path / "straight", data), **kw})
    monkeypatch.setattr(TT, "PretrainLoader", StopAfterTwo)
    with pytest.raises(KeyboardInterrupt):
        lt.train_object_detection(
            **{**_args("picodet", tmp_path / "resumed", data), **kw})
    monkeypatch.undo()
    resumed, _ = lt.train_object_detection(
        **{**_args("picodet", tmp_path / "resumed", data), **kw},
        resume_interrupted=True)
    assert resumed.step == straight.step == 4
    for value_of in (lambda s: s.params.state_dict(),
                     lambda s: s.method_state["ema"]):
        for key, value in value_of(straight).items():
            assert torch.equal(value_of(resumed)[key], value), key
    losses = {out: [r["train_loss"] for r in _records(tmp_path / out)
                    if "train_loss" in r] for out in ("straight", "resumed")}
    assert len(losses["resumed"]) == 4
    assert losses["resumed"][2:] == losses["straight"][2:]
