"""``train_object_detection`` end to end on the CPU, in the JAX package
and in the port.

Three steps at batch 8 (a multiple of the JAX tests' 8 virtual devices),
fp32 with TF32 off, from the same checkpoint-scale weights, with the flip
off, in two cases that cover between them YOLO and COCO data, the D-FINE
and the RT-DETRv2 decoder, 2 and 0 denoising groups, a ViT through
DINOSTAs (``dinov2/vittest14-ltdetr``) and ECViT's pyramid
(``_ltdetrv2-test``), and ``grad_accum_steps`` 1 and 2. On the JAX test
mesh the host callbacks cannot run beside the collectives, so both
packages match with ``LIGHTLY_TRAIN_MATCHER=greedy`` (the greedy matcher
and the device GO union; the exact ones are held in
``test_torch_ltdetr.py``). The port's denoising queries are handed the
draws of the JAX step (``fold_in(base_key, step)``, ``fold_in(k, 1)``,
the microbatch splits, the loss's split).

Held: each step's loss, grad norm and criterion metrics (1e-5 relative)
and the metric keys; every parameter, BatchNorm statistic and EMA
parameter after the run within 1e-5 of its largest value (of 1 where
that is smaller: AdamW's near-sign first steps turn the 1e-7 relative
noise of a gradient element near 0 into a few 1e-6), but for the
elements whose exact gradient is 0 (a bias right before a train-mode
BatchNorm, a kernel tap whose input is constant over the batch of small
maps): their gradients are rounding noise that AdamW scales to full
steps. The JAX package's gradient of one loss on the run's first images,
at the run's own ``dn_groups``, picks them out (below 1e-7 of its largest
element), and a leaf is left out whole only where ``STRUCTURAL_ZEROS``
names it; the validation
metrics, equal; the hyperparameters and the exported metadata
(``architecture`` "ltdetr", the resolved ``task_args``). A run stopped
after its step-2 checkpoint and resumed ends bitwise where the
uninterrupted one ends, its EMA included.
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
from lightly_train_tpu.tasks.detection import ltdetr as JL
from lightly_train_tpu_torch._commands import train_task as TT
from lightly_train_tpu_torch.models.from_jax import task_state_from_jax
from lightly_train_tpu_torch.tasks.detection import ltdetr as L
from test_torch_eomt_finetune import StopAfterTwo, _with_time_limit
from test_torch_ltdetr import _dn_draws, _scale
from torch_fixtures.detection_data import write_detection
from torch_fixtures.threads import one_torch_thread  # noqa: F401

STEPS, BATCH = 3, 8
TASK_ARGS = dict(num_queries=8, d_model=32, num_heads=2, dim_feedforward=48,
                 num_decoder_layers=2, csp_blocks=1, num_points=[2, 2, 2],
                 dfine_bins=17)
# name: (model, size, data format, extra task args, extra run args)
RUNS = {
    "vit_yolo_dfine_dn2": ("dinov2/vittest14-ltdetr", 56, "yolo",
                           {"decoder": "dfine", "dn_groups": 2}, {}),
    "ecvit_coco_rtdetrv2_dn0_accum2": (
        "_ltdetrv2-test", 64, "coco", {"decoder": "rtdetrv2",
                                       "dn_groups": 0},
        {"grad_accum_steps": 2}),
}
JAX_TIME_LIMIT = 300
# The leaves whose exact gradient is 0 whole: a bias whose per-channel
# constant the next train-mode BatchNorm removes (through a convolution or
# a linear map), an attention key bias (the softmax is shift-invariant), an
# unused table. No other leaf may be left out of the comparison whole.
_BN_FED = {"backbone.encoder.input_proj0_norm.bias",
           "backbone.encoder.input_proj1_norm.bias",
           "backbone.encoder.encoder0_layer0.norm2.bias"}
STRUCTURAL_ZEROS = {
    "vit_yolo_dfine_dn2": _BN_FED | {
        "backbone.backbone_sta.norms0.bias",
        "backbone.backbone_sta.norms1.bias",
        "backbone.backbone_sta.norms2.bias",
        "backbone.backbone_sta.sta.conv4_norm.bias",
        "backbone.trunk.norm.bias",
        "backbone.trunk.blocks.0.attn.k.bias",
        "backbone.trunk.blocks.1.attn.k.bias",
        "backbone.trunk.mask_token"},
    "ecvit_coco_rtdetrv2_dn0_accum2": _BN_FED | {
        "backbone.trunk.projector0.norm.bias",
        "backbone.trunk.projector1.norm.bias",
        "backbone.trunk.projector2.norm.bias",
        "backbone.trunk.blocks.1.mlp.fc2.bias",
        "backbone.decoder.denoising_class_embed"},
}


def _args(name, out, data, **kwargs):
    model, size, _, task_args, extra = RUNS[name]
    return dict(out=str(out), data=data, model=model, steps=STEPS,
                batch_size=BATCH, image_size=size, precision="fp32",
                num_workers=2, log_every=1, val_every=STEPS,
                hflip_prob=0.0,
                task_args={**TASK_ARGS, **task_args}, **extra, **kwargs)


def _shared_init(mp):
    """Both packages' inits return the same checkpoint-scale parameters
    (and the JAX init's BatchNorm state)."""
    held = {}
    j_init, p_init = JL.ObjectDetectionTrainModel.init, \
        L.ObjectDetectionTrainModel.init

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

    mp.setattr(JL.ObjectDetectionTrainModel, "init", jax_init)
    mp.setattr(L.ObjectDetectionTrainModel, "init", port_init)
    return held


def _hand_over_dn_draws(mp, accum):
    """The port's denoising draws, in call order, from the JAX steps'
    keys."""
    calls = []

    def dn_draws(self, generator, shape, device):
        step, mb = divmod(len(calls), accum)
        calls.append(shape)
        k_loss = jax.random.fold_in(jax.random.fold_in(jax.random.key(0),
                                                       step), 1)
        keys = jax.random.split(k_loss, accum) if accum > 1 else [k_loss]
        k_dn, _ = jax.random.split(keys[mb])
        return _dn_draws(k_dn, self, shape)

    mp.setattr(L.ObjectDetectionTrainModel, "dn_draws", dn_draws)
    return calls


def _degenerate(held, name, data_root):
    """{name: bool mask} of the parameter elements whose exact gradient is
    0: the JAX package's gradient of one loss on the run's first images, at
    the run's own ``dn_groups``, below 1e-7 of its largest element."""
    from lightly_train_tpu.models.package_registry import (
        get_wrapped_model as jax_get_wrapped_model,
    )
    from lightly_train_tpu_torch._commands.train_task import _LTDETRV2_ZOO
    from lightly_train_tpu_torch.tasks.detection.data import (
        COCOObjectDetectionDataset,
        YOLOObjectDetectionDataset,
    )

    model, size, fmt, task_args, _ = RUNS[name]
    backbone = _LTDETRV2_ZOO.get(model, model.removesuffix("-ltdetr"))
    j_model = JL.ObjectDetectionTrainModel(
        jax_get_wrapped_model(backbone, dtype=jnp.float32),
        JL.ObjectDetectionArgs(num_classes=3, **{
            **TASK_ARGS, "num_points": (2, 2, 2), **task_args}))
    split = data_root["train"]
    ds = (YOLOObjectDetectionDataset(split["images"], split["labels"],
                                     (size, size)) if fmt == "yolo" else
          COCOObjectDetectionDataset(split["images"], split["annotations"],
                                     (size, size)))
    items = [ds[i] for i in range(4)]
    batch = {k: jnp.asarray(np.stack([it[k] for it in items]))
             for k in items[0]}
    batch = JTT._device_val_transform(batch, jnp.float32)
    grads = jax.jit(jax.grad(lambda p: j_model.loss_fn(
        p, held["model_state"], batch, jax.random.key(0), 0)[0]))(
        held["params"])
    grads = task_state_from_jax(jax.device_get(grads))
    top = max(float(g.abs().max()) for g in grads.values())
    mask = {n: g.abs() < 1e-7 * top for n, g in grads.items()}
    whole = {n for n, m in mask.items() if bool(m.all())}
    assert whole <= STRUCTURAL_ZEROS[name], whole - STRUCTURAL_ZEROS[name]
    for n in STRUCTURAL_ZEROS[name]:
        mask[n] = torch.ones_like(mask[n])
    return mask


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request, tmp_path_factory):
    name = request.param
    model, size, fmt, _, extra = RUNS[name]
    root = tmp_path_factory.mktemp(name)
    data = write_detection(root / "data", n=BATCH, num_classes=3, fmt=fmt,
                           seed=len(name))
    accum = extra.get("grad_accum_steps", 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LIGHTLY_TRAIN_MATCHER", "greedy")
        held = _shared_init(mp)
        j_state, j_val = _with_time_limit(
            lambda: jlt.train_object_detection(**_args(name, root / "jax",
                                                       data)),
            JAX_TIME_LIMIT)
        torch.backends.cuda.matmul.allow_tf32 = False
        calls = _hand_over_dn_draws(mp, accum)
        p_state, p_val = lt.train_object_detection(
            **_args(name, root / "port", data, accelerator="cpu"))
        degenerate = _degenerate(held, name, data)
    return dict(name=name, root=root, held=held, j_state=j_state,
                j_val=j_val, p_state=p_state, p_val=p_val, data=data,
                calls=calls, degenerate=degenerate)


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
    assert hp["architecture"] == "ltdetr"
    train = [(r, j) for r, j in zip(got[1:], want[1:]) if "train_loss" in r]
    assert len(train) == STEPS
    for r, j in zip(got[1:], want[1:]):
        assert set(r) == set(j)
    for r, j in train:
        for key, value in j.items():
            if key.startswith(("train_loss", "grad_norm", "loss_",
                               "dn_loss")):
                np.testing.assert_allclose(r[key], value, rtol=1e-5,
                                           err_msg=key)
    groups = RUNS[runs["name"]][3]["dn_groups"]
    accum = RUNS[runs["name"]][4].get("grad_accum_steps", 1)
    assert len(runs["calls"]) == (STEPS * accum if groups else 0)


def _close(got, want, degenerate):
    assert set(got) == set(want)
    for name, w in want.items():
        diff = (got[name].float() - w.float()).abs()
        if name in degenerate:
            diff = torch.where(degenerate[name], 0.0, diff)
        tol = 1e-5 * max(float(w.abs().max()), 1.0)
        assert float(diff.max()) <= tol, name


def test_parameters_statistics_and_ema_match(runs):
    j = runs["j_state"]
    want = task_state_from_jax(jax.device_get(j.params),
                               jax.device_get(j.model_state))
    got = runs["p_state"].params.state_dict()
    _close(got, want, runs["degenerate"])
    want_ema = task_state_from_jax(jax.device_get(j.ema_params))
    _close(runs["p_state"].method_state["ema"], want_ema, runs["degenerate"])
    # The run moved the parameters, and the EMA differs from them.
    start = task_state_from_jax(runs["held"]["params"])
    assert any(not torch.equal(got[n], start[n]) for n in start)


def test_validation_and_exports_match(runs):
    assert runs["p_val"] == runs["j_val"]
    assert set(runs["p_val"]) == {"val_map", "val_map50"}
    # The export holds the EMA of the parameters and the live buffers.
    state = runs["p_state"]
    exported = torch.load(runs["root"] / "port" / "exported_models" /
                          "exported_last" / "model.pt", weights_only=True)
    ema = state.method_state["ema"]
    live = state.params.state_dict()
    assert set(exported) == set(live)
    for key, value in exported.items():
        assert torch.equal(value, ema[key] if key in ema else live[key]), key
    for art in ("exported_last", "exported_best"):
        p_meta = json.loads((runs["root"] / "port" / "exported_models" / art
                             / "metadata.json").read_text())
        j_meta = json.loads((runs["root"] / "jax" / "exported_models" / art
                             / "metadata.json").read_text())
        for key in ("architecture", "task", "task_args", "steps",
                    "model_name"):
            assert p_meta[key] == j_meta[key], key


def test_stop_and_resume_matches_the_uninterrupted_run(tmp_path,
                                                       monkeypatch):
    """A ViT run of 4 steps stopped after its step-2 checkpoint and
    resumed: the losses of steps 3 and 4, the parameters and the EMA
    bitwise the uninterrupted run's."""
    name = "vit_yolo_dfine_dn2"
    data = write_detection(tmp_path / "data", n=BATCH, num_classes=3)
    kw = dict(steps=4, save_every=2, val_every=4, accelerator="cpu")
    straight, _ = lt.train_object_detection(
        **{**_args(name, tmp_path / "straight", data), **kw})
    monkeypatch.setattr(TT, "PretrainLoader", StopAfterTwo)
    with pytest.raises(KeyboardInterrupt):
        lt.train_object_detection(
            **{**_args(name, tmp_path / "resumed", data), **kw})
    monkeypatch.undo()
    resumed, _ = lt.train_object_detection(
        **{**_args(name, tmp_path / "resumed", data), **kw},
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


def test_checkpoint_warm_starts_the_trunk(tmp_path):
    """``checkpoint=`` an exported backbone loads it into the trunk
    (``backbone.trunk.*``), the detection head from its own init."""
    from lightly_train_tpu_torch._checkpoint.checkpoint import export_model
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    trunk = get_wrapped_model("dinov2/vittest14").module
    trunk.reset_parameters(torch.Generator().manual_seed(5))
    weights = {k: v.clone() for k, v in trunk.state_dict().items()}
    export_model(tmp_path / "export", "dinov2/vittest14", weights)
    data = write_detection(tmp_path / "data", n=4, num_classes=3)
    state, _ = lt.train_object_detection(
        out=str(tmp_path / "out"), data=data, model="dinov2/vittest14",
        checkpoint=str(tmp_path / "export"), steps=1, batch_size=2,
        image_size=28, precision="fp32", num_workers=0, accelerator="cpu",
        learning_rate=0.0, hflip_prob=0.0,
        task_args={**TASK_ARGS, "dn_groups": 0})
    got = state.params.state_dict()
    for key, value in weights.items():
        assert torch.equal(got[f"backbone.trunk.{key}"], value), key

