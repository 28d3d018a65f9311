"""Parity helpers of the port's tests of ECViT, YOLO and YOLO-NAS (this
file holds no test of its own): a backbone's forward
(:func:`backbone_matches_jax`) and three pretraining steps of a method
(:func:`three_steps_match_jax`) in the JAX package and in the port, from
shared weights, running statistics and inputs; and synthetic
ultralytics- and EdgeCrafter-named checkpoints
(:func:`ultralytics_state_dict`, :func:`ecvit_state_dict`).

In the three steps both packages start from the same checkpoint-scale weights and statistics
(``variables_from_jax``; an EMA teacher drawn apart from its student) and
take the same explicit views at SIZE^2 (DINO's local views at LOCAL^2),
batch B, float32 with TF32 off; distillation's mixup is handed over from
the JAX draw. The JAX step threads its ``model_state`` through the loss as
the JAX train step does. Each step runs the loss, its gradient and the
method's default update in both (the fused AdamW+EMA update for DINO, LARS
for distillation); the loss (1e-5 relative), every parameter and the
running statistics (1e-4 relative L2) are compared after each step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lightly_train_tpu._optim import build_optimizer
from lightly_train_tpu._optim import cosine_warmup as jax_cw
from lightly_train_tpu._optim.fused_update import build_fused_updater as jbfu
from lightly_train_tpu.methods import dino as JDINO
from lightly_train_tpu.methods import distillationv3 as JV3
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu_torch._commands.train_loop import make_train_step
from lightly_train_tpu_torch._optim import cosine_warmup
from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
from lightly_train_tpu_torch._optim.update import build_update
from lightly_train_tpu_torch.methods import dino as DINO
from lightly_train_tpu_torch.methods import distillationv3 as V3
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.models.from_jax import (
    method_state_from_jax,
    params_from_jax,
    variables_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from torch_fixtures.threads import one_torch_thread  # noqa: F401

SIZE, LOCAL, B, TOTAL = 64, 32, 4, 10
MULTI_CROP = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
                  local_view_count=2, global_image_size=SIZE,
                  local_image_size=LOCAL, freeze_last_layer_steps=1)
DISTILL = dict(teacher="dinov3/vittest16", image_size=SIZE, queue_size=16)
# method -> (JAX method, JAX args, port method, port args, method_args,
# base learning rate)
METHODS = {
    "dino": (JDINO.DINO, JDINO.DINOArgs, DINO.DINO, DINO.DINOArgs,
             MULTI_CROP, 5e-3),
    "distillationv3": (JV3.DistillationV3, JV3.DistillationV3Args,
                       V3.DistillationV3, V3.DistillationV3Args, DISTILL,
                       20.0),
}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def checkpoint_scale(tree, seed, weight_norm=False):
    """Checkpoint-scale values for a Flax tree: kernels at 1/sqrt(fan-in),
    scales near 1, running means near 0 and variances near 1 (positive),
    0-d leaves (YOLO-NAS's ``alpha``) near 1. With ``weight_norm`` (the
    CNN methods' draw), also the weight-norm gains ``g`` near 1, their
    directions ``v`` at 0.3 and LayerScale's ``gamma`` near 0.5."""
    rng = np.random.default_rng(seed)
    near_one = ("scale", "var", "alpha") + (("g",) if weight_norm else ())

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in near_one:
            return 1.0 + 0.2 * np.abs(rng.standard_normal(x.shape))
        if weight_norm and name == "gamma":
            return 0.5 + 0.2 * rng.standard_normal(x.shape)
        if weight_norm and name == "v":
            return 0.3 * rng.standard_normal(x.shape)
        return 0.5 * rng.standard_normal(x.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), tree)


def views(method, step):
    rng = np.random.default_rng(100 + step)

    def image(size):
        return rng.standard_normal((B, size, size, 3)).astype(np.float32)

    if method == "dino":
        return [image(SIZE), image(SIZE), image(LOCAL), image(LOCAL)]
    return [image(SIZE)]


def jax_init(j_method, weight_norm=False):
    """A JAX method's (params, model_state, method_state) at checkpoint
    scale (:func:`checkpoint_scale`). Only the init's shapes are taken (no
    init to compile): every parameter and statistic is drawn, and the
    methods' other state (centers, queues, their pointers) starts at
    zero."""
    def draw(tree, seed):
        return checkpoint_scale(tree, seed, weight_norm)

    params, model_state, method_state = jax.eval_shape(
        j_method.init, jax.random.key(0),
        jnp.zeros((2, SIZE, SIZE, 3), jnp.float32))
    method_state = {k: jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, x.dtype), v)
        for k, v in method_state.items()}
    params = draw(params, 0)
    model_state = draw(model_state, 2)
    if "teacher" in method_state:
        teacher = method_state["teacher"]
        if set(teacher) == {"params"}:  # distillation's frozen teacher
            teacher = {"params": draw(teacher["params"], 1)}
        else:  # an EMA teacher, drawn apart from its student
            teacher = draw(teacher, 1)
        method_state = {**method_state, "teacher": teacher}
    return params, model_state, method_state


def jax_setup(student, method):
    j_cls, j_args_cls, _, _, args, _ = METHODS[method]
    j_method = j_cls(jax_get_wrapped_model(student), j_args_cls(**args))
    return (j_method, *jax_init(j_method))


def port_init(p_method, j_params, j_model_state, j_method_state, lr, fused,
              grad_accum_steps=1):
    """The port's TrainState and train step for ``p_method`` from the JAX
    package's state: parameters, running statistics and method state
    carried, and the fused AdamW+EMA update (``fused``) or the unfused
    default update at the JAX tests' schedule."""
    params, method_state = p_method.init(torch.Generator().manual_seed(0),
                                         torch.device("cpu"))
    params.load_state_dict({
        **params_from_jax(jax.device_get(j_params)),
        **variables_from_jax(jax.device_get(j_model_state), "student.")})
    carried = method_state_from_jax(jax.device_get(j_method_state))
    if "teacher" in carried:
        method_state["teacher"].load_state_dict(carried["teacher"],
                                                strict=False)
    method_state.update({k: v for k, v in carried.items() if k != "teacher"})
    build = build_fused_updater if fused else build_update
    updater = build(p_method, p_method.default_optimizer_args(),
                    cosine_warmup(lr, TOTAL, 2),
                    dict(params.named_parameters()), TOTAL)
    assert updater is not None
    return (TrainState(0, params, method_state, updater),
            make_train_step(p_method, TOTAL,
                            grad_accum_steps=grad_accum_steps))


def port_setup(student, method, j_params, j_model_state, j_method_state):
    _, _, cls, args_cls, args, lr = METHODS[method]
    p_method = cls(get_wrapped_model(student), args_cls(**args))
    return (p_method, *port_init(p_method, j_params, j_model_state,
                                 j_method_state, lr, method == "dino"))


def student_buffers(params):
    return {f"student.{k}": v for k, v in params["student"].named_buffers()}


def assert_close(got, ref, what, tol=1e-4, skip=()):
    assert set(ref) == set(got), what
    for name, r in ref.items():
        if name.endswith(skip):
            continue
        err = rel_l2(got[name].detach().numpy(), r.numpy())
        assert err <= tol, f"{what} {name}: {err}"


def jax_mixup_draw(rng, mixup_prob):
    """The (lam, apply) the JAX distillation loss draws from ``rng``."""
    k_apply, k_lam = jax.random.split(jax.random.split(rng)[0])
    lam = jax.random.uniform(k_lam, (B, 1, 1, 1), minval=0.5, maxval=1.0)
    apply = jax.random.uniform(k_apply, (B, 1, 1, 1)) < mixup_prob
    return (torch.tensor(np.asarray(lam)), torch.tensor(np.asarray(apply)))


def three_steps_match_jax(student, method, degenerate=(), shifted=()):
    """Three steps in both packages, compared after each; returns the
    port's state and its parameters before the first step.

    ``degenerate`` names (by suffix) the leaves whose gradient is zero in
    exact arithmetic: a bias whose constant shift the next train-mode
    BatchNorm removes. What each package computes for them is rounding
    noise, which AdamW's and LARS's normalisations scale to full steps,
    so they are not compared; the JAX gradient of each is held below 1e-5
    of the gradient's RMS (the other leaves' are above 1e-4 of it).
    ``shifted`` names the running means of the BatchNorms after them,
    which move with those steps."""
    j_method, j_params, j_mstate, j_ms = jax_setup(student, method)
    p_method, state, step_fn = port_setup(student, method, j_params,
                                          j_mstate, j_ms)
    start = {k: v.detach().clone()
             for k, v in state.params.state_dict().items()}
    lr = METHODS[method][5]
    j_args = j_method.default_optimizer_args()
    j_lr = jax_cw(lr, TOTAL, 2)
    j_opt = build_optimizer(
        j_args, j_lr, j_params, grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params))
    j_fused = (jbfu(j_method, j_args, j_lr, j_params, TOTAL, mode="jnp")
               if method == "dino" else None)
    j_opt_state = jax.jit(j_opt.init)(j_params)

    @jax.jit
    def j_step(p, opt_state, model_state, method_state, vs, rng, step):
        """The JAX train step's loss, gradient and update."""
        (loss, (model_state, method_state, _)), grads = jax.value_and_grad(
            lambda p: j_method.loss_fn(p, model_state, method_state, vs,
                                       rng, step, TOTAL),
            has_aux=True)(p)
        if j_fused is not None:
            p, teacher, opt_state, _ = j_fused.update_and_apply(
                grads, opt_state, p, method_state["teacher"], step)
            method_state = {**method_state, "teacher": teacher}
        else:
            updates, opt_state = j_opt.update(grads, opt_state, p)
            updates = j_method.mask_updates(updates, step)
            p = optax.apply_updates(p, updates)
            method_state = j_method.post_update(p, method_state, step, TOTAL)
        return loss, p, opt_state, model_state, method_state, grads

    for step in range(3):
        vs = views(method, step)
        rng = jax.random.key(1000 + step)
        pinned = (jax_mixup_draw(rng, p_method.args.mixup_prob)
                  if method == "distillationv3" else None)
        before = {k: v.clone()
                  for k, v in student_buffers(state.params).items()}
        j_loss, j_params, j_opt_state, j_mstate, j_ms, grads = j_step(
            j_params, j_opt_state, j_mstate, j_ms,
            [jnp.asarray(v) for v in vs], rng, jnp.asarray(step))

        if step == 0:
            g = params_from_jax(jax.device_get(grads))
            rms = np.sqrt(sum((v.double() ** 2).sum().item()
                              for v in g.values())
                          / sum(v.numel() for v in g.values()))
            assert all(any(k.endswith(d) for k in g) for d in degenerate)
            for k in [k for k in g if k.endswith(degenerate)]:
                assert g[k].double().pow(2).mean().sqrt() < 1e-5 * rms, k
        metrics = step_fn(state, None, None,
                          views=[[torch.tensor(v) for v in vs]],
                          masks=None if pinned is None else [pinned])
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(j_loss), rtol=1e-5)
        assert_close(dict(state.params.named_parameters()),
                     params_from_jax(jax.device_get(j_params)),
                     f"step {step} params", skip=degenerate)
        assert_close(student_buffers(state.params),
                     variables_from_jax(jax.device_get(j_mstate),
                                        "student."),
                     f"step {step} running statistics", skip=shifted)
        if p_method.ema_teacher:
            teacher = state.method_state["teacher"]
            assert_close(dict(teacher.named_parameters()),
                         params_from_jax(jax.device_get(j_ms["teacher"])),
                         f"step {step} teacher")
            # The teacher ran on the statistics the step found.
            for k, v in teacher["student"].named_buffers():
                assert torch.equal(v, before[f"student.{k}"]), k
    assert state.step == 3
    moved = max((v - start[k]).abs().max().item()
                for k, v in state.params.state_dict().items())
    assert moved > 1e-3, moved
    assert any(not torch.equal(v, start[k]) for k, v in
               student_buffers(state.params).items())
    return state, start


def backbone_matches_jax(model, size, train, wrapped_j=None, wrapped=None):
    """The port's forward of ``model`` on a (4, size, size, 3) batch against
    the JAX module's, from the same checkpoint-scale variables: every
    output within 1e-5 relative L2, or in train mode within the JAX
    package's own distance from itself when only the batch order changes
    (the largest over three orders), where that is larger; the updated
    statistics within 1e-5, and in eval mode left as they were. A pair of
    wrapped models (``wrapped_j``, ``wrapped``) stands in for the name."""
    wrapped_j = wrapped_j or jax_get_wrapped_model(model)
    rng = np.random.default_rng(size)
    x = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    variables = jax.device_get(checkpoint_scale(jax.eval_shape(
        lambda: wrapped_j.init(jax.random.key(0),
                               jnp.zeros((1, size, size, 3)))), 1))
    carried = variables_from_jax(variables)
    module = (wrapped or get_wrapped_model(model)).module
    module.load_state_dict(carried)
    # One compiled forward (an eager one compiles each of its ops).
    apply = jax.jit(lambda v, x: wrapped_j.module.apply(
        v, x, train=train, **({"mutable": ["batch_stats"]} if train else {})))
    if train:
        ref, new_state = apply(variables, jnp.asarray(x))
        # The batch statistics couple the samples and BatchNorm amplifies
        # rounding down the stack: the JAX package's own outputs move by
        # up to 3.6e-5 (yolo11test, yolo_nas_test) when only the batch
        # order changes, and by different amounts for each order.
        perms = [np.array(p) for p in ([1, 3, 0, 2], [3, 2, 1, 0],
                                       [2, 0, 3, 1])]
        agains = [apply(variables, jnp.asarray(x[p]))[0] for p in perms]
    else:
        ref = apply(variables, jnp.asarray(x))
        perms, agains = [], []
    got = module(torch.from_numpy(x), train=train)

    def tol(key, i=None):
        def pick(out):
            return out[key] if i is None else out[key][i]

        return max([1e-5] + [rel_l2(np.asarray(pick(a))[np.argsort(p)],
                                    pick(ref))
                             for p, a in zip(perms, agains)])

    for key in ("features", "cls_token", "patch_tokens"):
        assert got[key].shape == ref[key].shape, key
        assert rel_l2(got[key].detach(), ref[key]) <= tol(key), key
    assert len(got["stage_features"]) == len(ref["stage_features"])
    for i, (g, r) in enumerate(zip(got["stage_features"],
                                   ref["stage_features"])):
        assert g.shape == r.shape
        assert rel_l2(g.detach(), r) <= tol("stage_features", i), i
    buffers = dict(module.named_buffers())
    if train:
        want = variables_from_jax(jax.device_get(new_state))
        assert set(want) == set(buffers)
        for name, value in want.items():
            assert rel_l2(buffers[name], value) <= 1e-5, name
            assert not torch.equal(buffers[name], carried[name])
    else:  # eval mode reads the statistics and leaves them
        for name, value in buffers.items():
            assert torch.equal(value, carried[name])


def ultralytics_state_dict(model, seed):
    """An ultralytics-named state dict of ``model``'s backbone (``model.{i}``
    keys, ``m.{j}``, ``ffn.{k}``, ``running_mean``/``running_var`` and
    ``num_batches_tracked``) and of a head at index 23, which the
    conversion drops."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        module = get_wrapped_model(model).module
    sd = {}
    for key, value in module.state_dict().items():
        parts = key.split(".")
        parts[0] = f"model.{parts[0].removeprefix('layer')}"
        parts = [f"m.{p[1:]}" if p[:1] == "m" and p[1:].isdigit()
                 else f"ffn.{p[3:]}" if p[:3] == "ffn" else p for p in parts]
        parts[-1] = {"mean": "running_mean", "var": "running_var"}.get(
            parts[-1], parts[-1])
        draw = rng.standard_normal(value.shape).astype(np.float32)
        if parts[-1] == "running_var":
            draw = np.abs(draw) + 0.5
        sd[".".join(parts)] = torch.from_numpy(draw)
        if parts[-1] == "running_var":
            sd[".".join(parts[:-1] + ["num_batches_tracked"])] = \
                torch.tensor(7)
    sd["model.23.cv2.0.0.conv.weight"] = torch.zeros(4, 4, 3, 3)
    return sd


def ecvit_state_dict(model, seed):
    """An EdgeCrafter ``ECViTModelWrapper`` state dict of ``model``: the
    patch embed's ConvNormLayers (with ``num_batches_tracked``) and biased
    projection, the register token, the blocks with a fused qkv, the
    projectors; and a head, which the conversion drops."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        cfg = get_wrapped_model(model).module.cfg
    D, h = cfg.embed_dim, int(cfg.embed_dim * cfg.ffn_ratio)
    sd = {}

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def conv_norm(prefix, out_ch, in_ch, k):
        sd[f"{prefix}.conv.weight"] = t(out_ch, in_ch, k, k)
        sd[f"{prefix}.norm.weight"], sd[f"{prefix}.norm.bias"] = (
            t(out_ch), t(out_ch))
        sd[f"{prefix}.norm.running_mean"] = t(out_ch)
        sd[f"{prefix}.norm.running_var"] = t(out_ch).abs() + 0.5
        sd[f"{prefix}.norm.num_batches_tracked"] = torch.tensor(3)

    chans = (3, D // 8, D // 4, D // 2)
    for i in range(3):
        conv_norm(f"backbone.patch_embed.convs.{i}", chans[i + 1], chans[i],
                  3)
    sd["backbone.patch_embed.proj.weight"] = t(D, D // 2, 3, 3)
    sd["backbone.patch_embed.proj.bias"] = t(D)
    sd["backbone.register_token"] = t(1, 1, D)
    for i in range(cfg.depth):
        p = f"backbone.blocks.{i}."
        for norm in ("norm1", "norm2"):
            sd[f"{p}{norm}.weight"], sd[f"{p}{norm}.bias"] = t(D), t(D)
        sd[f"{p}attn.qkv.weight"], sd[f"{p}attn.qkv.bias"] = (
            t(3 * D, D), t(3 * D))
        sd[f"{p}attn.proj.weight"], sd[f"{p}attn.proj.bias"] = t(D, D), t(D)
        sd[f"{p}mlp.fc1.weight"], sd[f"{p}mlp.fc1.bias"] = t(h, D), t(h)
        sd[f"{p}mlp.fc2.weight"], sd[f"{p}mlp.fc2.bias"] = t(D, h), t(D)
    width = D if cfg.proj_dim is None else cfg.proj_dim
    for i in range(1 if cfg.proj_dim is None else 3):
        conv_norm(f"projector.{i}", width, D, 1)
    sd["head.weight"] = t(4, width)
    return sd
