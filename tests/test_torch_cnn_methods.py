"""The methods on the CNN backbones, with their BatchNorm state, against
the JAX package.

``torchvision/resnettest`` (and, by distillation, ``dinov3/convnext-test``
and ``torchvision/shufflenettest``) at 64^2 (DINO's local views at 32^2),
batch 4, float32 with TF32 off, small heads. Both packages start from the
same checkpoint-scale weights and running statistics (``variables_from_jax``;
every EMA teacher drawn apart from its student) and take the same explicit
views; DenseCL's dense match and distillation's mixup are handed over from
the JAX draws. The JAX step threads its ``model_state`` through the loss as
the JAX train step does; the port's BatchNorm buffers are the student's.
Each step runs the loss, its gradient and the method's default update in
both (the fused AdamW+EMA update for DINO, LARS for SimCLR, DetCon-B and
distillation, SGD and the EMA for DenseCL); the loss (1e-5 relative), every
parameter and the running statistics (1e-4 relative L2) are compared after
each of three steps. DINO's and DenseCL's teachers read the student's
running statistics as the step found them.

Also: ``grad_accum_steps=2`` (the statistics move once a microbatch),
DINOv2 and DINOv31 refused at the student's forward on a BatchNorm CNN and
NaN on a ConvNeXt, as in the JAX package, an alias's export name, and a
resumed DINO run on a ResNet bitwise the uninterrupted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lightly_train_tpu as jlt
import lightly_train_tpu_torch as lt
from lightly_train_tpu._optim import build_optimizer
from lightly_train_tpu._optim import cosine_warmup as jax_cw
from lightly_train_tpu._optim.fused_update import build_fused_updater as jbfu
from lightly_train_tpu.methods import densecl as JDC
from lightly_train_tpu.methods import detcon as JDT
from lightly_train_tpu.methods import dino as JDINO
from lightly_train_tpu.methods import distillationv3 as JV3
from lightly_train_tpu.methods import simclr as JSC
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops import losses as JL
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._data.loader import PretrainLoader
from lightly_train_tpu_torch.errors import ModifyScopeVariableError
from lightly_train_tpu_torch.methods import densecl as DC
from lightly_train_tpu_torch.methods import detcon as DT
from lightly_train_tpu_torch.methods import dino as DINO
from lightly_train_tpu_torch.methods import distillationv3 as V3
from lightly_train_tpu_torch.methods import simclr as SC
from lightly_train_tpu_torch.models.from_jax import (
    params_from_jax,
    variables_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from test_torch_parity import (
    B,
    DISTILL,
    LOCAL,
    MULTI_CROP,
    SIZE,
    TOTAL,
    assert_close,
    jax_init,
    jax_mixup_draw,
    port_init,
    student_buffers,
)
from torch_fixtures.threads import one_torch_thread  # noqa: F401

RESNET = "torchvision/resnettest"
TWO_VIEWS = dict(image_size=SIZE, hidden_dim=32, output_dim=16)
# name -> (student, JAX method, JAX args, port method, port args,
# method_args, base learning rate).
CASES = {
    "dino": (RESNET, JDINO.DINO, JDINO.DINOArgs, DINO.DINO, DINO.DINOArgs,
             MULTI_CROP, 5e-3),
    "simclr": (RESNET, JSC.SimCLR, JSC.SimCLRArgs, SC.SimCLR, SC.SimCLRArgs,
               TWO_VIEWS, 20.0),
    # Train-mode BatchNorm's backward through the batch statistics turns
    # summation order into gradient rounding: the JAX DenseCL gradients of
    # this case differ from themselves by up to 4.2e-5 relative when the
    # batch is permuted, and from the port's by 3.0e-5. SGD with momentum
    # at lr 2 compounds that past 1e-4 by the third step; at lr 1 the
    # steps still move the weights well beyond the tolerance.
    "densecl": (RESNET, JDC.DenseCL, JDC.DenseCLArgs, DC.DenseCL,
                DC.DenseCLArgs, {**TWO_VIEWS, "queue_size": 16}, 1.0),
    "detconb": (RESNET, JDT.DetConB, JDT.DetConBArgs, DT.DetConB,
                DT.DetConBArgs, TWO_VIEWS, 20.0),
    "distillationv3": (RESNET, JV3.DistillationV3, JV3.DistillationV3Args,
                       V3.DistillationV3, V3.DistillationV3Args, DISTILL,
                       20.0),
    "distillationv3_convnext": (
        "dinov3/convnext-test", JV3.DistillationV3, JV3.DistillationV3Args,
        V3.DistillationV3, V3.DistillationV3Args, DISTILL, 20.0),
    "distillationv3_shufflenet": (
        "torchvision/shufflenettest", JV3.DistillationV3,
        JV3.DistillationV3Args, V3.DistillationV3, V3.DistillationV3Args,
        DISTILL, 20.0),
}


# A ShuffleNet unit's depthwise BatchNorm feeds a 1x1 convolution and a
# train-mode BatchNorm with no nonlinearity between: the second removes any
# shift of the first, so the first's bias has an exactly zero gradient, and
# what each package computes for it is rounding noise, which LARS's trust
# ratio scales up to a full step. That step shifts the second BatchNorm's
# batch mean, so its running mean differs by it too (its output and its
# variance do not).
DEGENERATE = ("dw_bn.bias", "short_pw_bn.mean", "pw2_bn.mean")


@pytest.fixture(autouse=True)
def _ieee_fp32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _jax_setup(name):
    student, j_cls, j_args_cls, _, _, args, _ = CASES[name]
    method = j_cls(jax_get_wrapped_model(student), j_args_cls(**args))
    return (method, *jax_init(method, weight_norm=True))


def _port_setup(name, j_params, j_model_state, j_method_state, fused,
                grad_accum_steps=1):
    student, _, _, cls, args_cls, args, lr = CASES[name]
    method = cls(get_wrapped_model(student), args_cls(**args))
    return (method, *port_init(method, j_params, j_model_state,
                               j_method_state, lr, fused, grad_accum_steps))


def _views(name, step):
    rng = np.random.default_rng(100 + step)

    def image(size):
        return rng.standard_normal((B, size, size, 3)).astype(np.float32)

    if name == "dino":
        return [image(SIZE), image(SIZE), image(LOCAL), image(LOCAL)]
    if name.startswith("distillation"):
        return [image(SIZE)]
    return [image(SIZE), image(SIZE)]


def _jax_match(j_method, params, model_state, method_state, views):
    """DenseCL's dense match as the JAX loss forms it (the student on the
    step's statistics in train mode, the teacher in eval mode)."""
    _, _, f_s, _ = j_method._encode(params, model_state,
                                    jnp.asarray(views[0]), True,
                                    jax.random.key(0))
    _, _, f_t, _ = j_method._encode(method_state["teacher"], model_state,
                                    jnp.asarray(views[1]), False,
                                    jax.random.key(0))
    corr = np.asarray(jnp.einsum("bnd,bmd->bnm", JL.l2_normalize(f_s),
                                 JL.l2_normalize(f_t)))
    top2 = np.sort(corr, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0] > 1e-5).all()
    return corr.argmax(-1)


def _jax_optimizer(j_method, j_params, lr, fused):
    j_args = j_method.default_optimizer_args()
    j_lr = jax_cw(lr, TOTAL, 2)
    j_opt = build_optimizer(
        j_args, j_lr, j_params, grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params))
    j_fused = (jbfu(j_method, j_args, j_lr, j_params, TOTAL, mode="jnp")
               if fused else None)
    return j_opt, j_fused


def _jax_update(j_method, j_opt, j_fused, opt_state, params, ms, grads,
                step):
    if j_fused is not None:
        params, teacher, opt_state, _ = j_fused.update_and_apply(
            grads, opt_state, params, ms["teacher"], jnp.asarray(step))
        return params, {**ms, "teacher": teacher}, opt_state
    updates, opt_state = j_opt.update(grads, opt_state, params)
    updates = j_method.mask_updates(updates, step)
    params = optax.apply_updates(params, updates)
    return params, j_method.post_update(params, ms, step, TOTAL), opt_state


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_jax(name):
    j_method, j_params, j_mstate, j_ms = _jax_setup(name)
    fused = name == "dino"
    method, state, step_fn = _port_setup(name, j_params, j_mstate, j_ms,
                                         fused)
    start = {k: v.detach().clone()
             for k, v in state.params.state_dict().items()}
    assert type(j_method.default_optimizer_args()).__name__ == type(
        method.default_optimizer_args()).__name__
    j_opt, j_fused = _jax_optimizer(j_method, j_params, CASES[name][6], fused)
    j_opt_state = jax.jit(j_opt.init)(j_params)

    @jax.jit
    def j_grad(p, model_state, method_state, views, rng, step):
        return jax.value_and_grad(
            lambda p: j_method.loss_fn(p, model_state, method_state, views,
                                       rng, step, TOTAL),
            has_aux=True)(p)

    # One compiled update (an eager one compiles each of its ops).
    j_update = jax.jit(lambda *args: _jax_update(j_method, j_opt, j_fused,
                                                 *args))

    for step in range(3):
        views = _views(name, step)
        rng = jax.random.key(1000 + step)
        pinned = None
        if name == "densecl":
            pinned = torch.tensor(_jax_match(j_method, j_params, j_mstate,
                                             j_ms, views))
        if name.startswith("distillation"):
            pinned = jax_mixup_draw(rng, method.args.mixup_prob)
        before = {k: v.clone() for k, v in
                  student_buffers(state.params).items()}
        (j_loss, (j_mstate, j_ms, _)), grads = j_grad(
            j_params, j_mstate, j_ms, [jnp.asarray(v) for v in views], rng,
            jnp.asarray(step))
        j_params, j_ms, j_opt_state = j_update(
            j_opt_state, j_params, j_ms, grads, jnp.asarray(step))

        metrics = step_fn(state, None, None,
                          views=[[torch.tensor(v) for v in views]],
                          masks=None if pinned is None else [pinned])
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(j_loss), rtol=1e-5)
        assert_close(dict(state.params.named_parameters()),
                     params_from_jax(jax.device_get(j_params)),
                     f"step {step} params", skip=DEGENERATE)
        assert_close(student_buffers(state.params),
                     variables_from_jax(jax.device_get(j_mstate),
                                        "student."),
                     f"step {step} running statistics", skip=DEGENERATE)
        teacher = state.method_state.get("teacher")
        if method.ema_teacher:
            assert_close(dict(teacher.named_parameters()),
                         params_from_jax(jax.device_get(j_ms["teacher"])),
                         f"step {step} teacher", skip=DEGENERATE)
            # The teacher ran on the statistics the step found.
            for k, v in teacher["student"].named_buffers():
                assert torch.equal(v, before[f"student.{k}"]), k
    assert state.step == 3
    moved = max((v - start[k]).abs().max().item()
                for k, v in state.params.state_dict().items())
    assert moved > 1e-3, moved
    if CASES[name][0] != "dinov3/convnext-test":
        # The running statistics moved too.
        assert any(not torch.equal(v, start[k]) for k, v in
                   student_buffers(state.params).items())


def test_grad_accum_moves_the_statistics_once_a_microbatch():
    """``grad_accum_steps=2``: SimCLR's two microbatches run one after the
    other on the statistics the first left, as the JAX step's scan; the
    gradients are averaged."""
    name = "simclr"
    j_method, j_params, j_mstate, j_ms = _jax_setup(name)
    method, state, step_fn = _port_setup(name, j_params, j_mstate, j_ms,
                                         False, grad_accum_steps=2)
    j_opt, _ = _jax_optimizer(j_method, j_params, CASES[name][6], False)
    j_opt_state = j_opt.init(j_params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, mstate, views, rng: j_method.loss_fn(
            p, mstate, {}, views, rng, 0, TOTAL), has_aux=True))
    for step in range(2):
        micro = [_views(name, 10 * step + i) for i in range(2)]
        losses, grad_sum = [], None
        for i, views in enumerate(micro):
            (loss, (j_mstate, _, _)), grads = grad_fn(
                j_params, j_mstate, [jnp.asarray(v) for v in views],
                jax.random.key(i))
            losses.append(float(loss))
            grad_sum = grads if grad_sum is None else jax.tree_util.tree_map(
                jnp.add, grad_sum, grads)
        grads = jax.tree_util.tree_map(lambda g: g * 0.5, grad_sum)
        j_params, _, j_opt_state = _jax_update(
            j_method, j_opt, None, j_opt_state, j_params, {}, grads, step)
        metrics = step_fn(state, None, None,
                          views=[[torch.tensor(v) for v in views]
                                 for views in micro])
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   np.mean(losses), rtol=1e-5)
        assert_close(dict(state.params.named_parameters()),
                     params_from_jax(jax.device_get(j_params)),
                     f"step {step} params", skip=DEGENERATE)
        assert_close(student_buffers(state.params),
                     variables_from_jax(jax.device_get(j_mstate),
                                        "student."),
                     f"step {step} running statistics", skip=DEGENERATE)


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


@pytest.mark.parametrize("model", [RESNET, "torchvision/shufflenettest"])
@pytest.mark.parametrize("method", ["dinov2", "dinov31"])
def test_dinov2_refuses_batchnorm_as_the_jax_package(tmp_path, data, model,
                                                     method):
    """DINOv2 and DINOv31 apply their student without ``mutable``: the JAX
    run stops at the first step's student forward with Flax's
    ModifyScopeVariableError, having written the same files; so does the
    port's, with its error of that name. The augmentation grid, which both
    would draw before the step (most of the case's time, in the JAX
    package's eager augmentation), is off in both: ``test_torch_checkpoint.
    py`` holds it."""
    args = dict(data=str(data), model=model, method=method, batch_size=4,
                steps=2, precision="fp32", canonical_size=48, num_workers=0,
                log_augmentations=False,
                method_args=dict(output_dim=64, hidden_dim=32,
                                 bottleneck_dim=16, local_view_count=2,
                                 global_image_size=64, local_image_size=32))
    with pytest.raises(Exception) as j_err:
        jlt.pretrain(out=str(tmp_path / "jax"), **args)
    assert type(j_err.value).__name__ == "ModifyScopeVariableError"
    with pytest.raises(ModifyScopeVariableError) as err:
        lt.pretrain(out=str(tmp_path / "port"), accelerator="cpu", **args)
    assert str(j_err.value).split(" because")[0] == \
        str(err.value).split(" because")[0]
    listing = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == listing


@pytest.mark.parametrize("method", ["dinov2", "dinov31"])
def test_dinov2_on_a_convnext_is_nan_as_the_jax_package(tmp_path, data,
                                                         method):
    """A ConvNeXt has no BatchNorm, so DINOv2 and DINOv31 run it, but its
    feature map holds fewer tokens than the mask grid of ``patch_size or
    16``: the JAX package's ``take_along_axis`` fills the missing ones with
    NaN, the first loss is NaN and the run stops with NaNDetectedError at
    its first step; the port's gather fills them alike. The augmentation
    grid is off in both, as in the refusal above."""
    from lightly_train_tpu.errors import NaNDetectedError as JaxNaN
    from lightly_train_tpu_torch.errors import NaNDetectedError

    args = dict(data=str(data), model="dinov3/convnext-test", method=method,
                batch_size=4, steps=2, precision="fp32", canonical_size=48,
                num_workers=0, log_augmentations=False, method_args=dict(
                    output_dim=64, hidden_dim=32, bottleneck_dim=16,
                    local_view_count=2, global_image_size=64,
                    local_image_size=32))
    with pytest.raises(JaxNaN, match="step 0"):
        jlt.pretrain(out=str(tmp_path / "jax"), **args)
    with pytest.raises(NaNDetectedError, match="state step 0"):
        lt.pretrain(out=str(tmp_path / "port"), accelerator="cpu", **args)
    assert (tmp_path / "port" / "debug" / "nan_capture_step0.npz").is_file()


def test_an_alias_exports_under_the_run_model_name(tmp_path, data):
    """``timm/resnettest`` builds the torchvision ResNet (the wrapped name is
    the target's) and, as in the JAX package, the export carries the name
    the run was given, which ``embed`` resolves again."""
    import json

    args = dict(data=str(data), model="timm/resnettest", method="simclr",
                batch_size=4, steps=1, precision="fp32", canonical_size=48,
                num_workers=0, method_args={"image_size": 32,
                                            "hidden_dim": 16,
                                            "output_dim": 8})
    jlt.pretrain(out=str(tmp_path / "jax"), **args)
    lt.pretrain(out=str(tmp_path / "port"), accelerator="cpu", **args)
    metas = [json.loads((tmp_path / side / "exported_models" / "exported_last"
                         / "metadata.json").read_text())
             for side in ("jax", "port")]
    assert metas[0]["model_name"] == metas[1]["model_name"] == \
        "timm/resnettest"
    assert get_wrapped_model("timm/resnettest").name == \
        jax_get_wrapped_model("timm/resnettest").name == \
        "torchvision/resnettest"
    emb = lt.embed(out=str(tmp_path / "emb.npz"), data=str(data),
                   checkpoint=str(tmp_path / "port" / "exported_models"
                                  / "exported_last"), image_size=32,
                   accelerator="cpu")
    assert np.load(emb)["embeddings"].shape == (8, 64)


class _Interrupted(Exception):
    pass


def test_resume_on_a_resnet_is_bitwise(tmp_path, data, monkeypatch):
    """DINO on a ResNet stopped after its step-2 checkpoint and resumed
    ends in bitwise the uninterrupted run's state: parameters, running
    statistics (the student's and the teacher's copy), the fused update's
    moments."""
    args = dict(data=str(data), model=RESNET, method="dino", batch_size=4,
                steps=4, precision="fp32", canonical_size=48, num_workers=0,
                accelerator="cpu", checkpoint_every=2,
                method_args=dict(MULTI_CROP, global_image_size=32,
                                 local_image_size=16))
    full = lt.pretrain(out=str(tmp_path / "full"), **args)

    class Loader(PretrainLoader):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 2:
                    raise _Interrupted
                yield batch

    monkeypatch.setattr(T, "PretrainLoader", Loader)
    with pytest.raises(_Interrupted):
        lt.pretrain(out=str(tmp_path / "cut"), **args)
    monkeypatch.undo()
    resumed = lt.pretrain(out=str(tmp_path / "cut"), resume_interrupted=True,
                          **args)

    def everything(state):
        out = {f"p.{k}": v for k, v in state.params.state_dict().items()}
        out.update({f"t.{k}": v for k, v in
                    state.method_state["teacher"].state_dict().items()})
        out.update({f"o.{k}": v for k, v in
                    state.updater.state_dict().items()
                    if isinstance(v, torch.Tensor)})
        return out

    a, b = everything(full), everything(resumed)
    assert a.keys() == b.keys()
    assert any(k.endswith(".mean") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
