"""Distillation (v3, v2, v1) of the port against the JAX package.

``dinov2/vittest14`` students learn from a frozen ``dinov3/vittest16``
teacher at 112^2 (an 8 x 8 student grid resampled to the teacher's 7 x 7),
queue 16, batch 4, float32. Both packages start from the same
checkpoint-scale weights, carried by ``params_from_jax``, and take the same
views; mixup's ``lam`` and ``apply`` are the ones the JAX loss draws from
its own key, handed to the port. Each step runs the loss, its gradient and
the unfused update (LARS for v3 and v2, AdamW for v1) in both; the loss,
the student, the heads and the queue are compared after every step.

Also: mixup, the resample, the enqueue and the losses against their JAX
counterparts; the teacher's and the heads' dtype in a bf16 run; the
teacher's weights from an exported folder; ``pretrain`` with every method
end to end on the CPU, and a resumed run bitwise the uninterrupted one.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu._optim import build_optimizer
from lightly_train_tpu._optim import cosine_warmup as jax_cw
from lightly_train_tpu.methods import distillation_v1v2 as JV12
from lightly_train_tpu.methods import distillationv3 as JV3
from lightly_train_tpu.models.heads import ProjectionHead as JaxProjectionHead
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops import losses as JL
from lightly_train_tpu_torch._checkpoint.checkpoint import (
    export_model,
    load_exported_model,
)
from lightly_train_tpu_torch._commands import train as T
from lightly_train_tpu_torch._commands.train_loop import make_train_step
from lightly_train_tpu_torch._data.loader import PretrainLoader
from lightly_train_tpu_torch._optim import cosine_warmup
from lightly_train_tpu_torch._optim.update import build_update
from lightly_train_tpu_torch.errors import ConfigError
from lightly_train_tpu_torch.methods import distillation_v1v2 as V12
from lightly_train_tpu_torch.methods import distillationv3 as V3
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.methods.method_helpers import get_method_cls
from lightly_train_tpu_torch.models.from_jax import (
    method_state_from_jax,
    params_from_jax,
)
from lightly_train_tpu_torch.models.heads import ProjectionHead
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops import losses as L
from torch_fixtures.threads import one_torch_thread  # noqa: F401

STUDENT, TEACHER = "dinov2/vittest14", "dinov3/vittest16"
SIZE, B, Q, TOTAL = 112, 4, 16, 10
METHODS = {
    "distillationv3": (JV3.DistillationV3, JV3.DistillationV3Args,
                       V3.DistillationV3, V3.DistillationV3Args),
    "distillationv2": (JV12.DistillationV2, JV12.DistillationV2Args,
                       V12.DistillationV2, V12.DistillationV2Args),
    "distillationv1": (JV12.DistillationV1, JV12.DistillationV1Args,
                       V12.DistillationV1, V12.DistillationV1Args),
}
# Base learning rates of the three steps: LARS scales each leaf's step to
# lr * 0.001 * ||p||, so lr 20 moves the weights by about 2% a step, well
# above the tolerance; AdamW's first steps move them by about lr.
LR = {"distillationv3": 20.0, "distillationv2": 20.0, "distillationv1": 5e-3}
ARGS = dict(teacher=TEACHER, image_size=SIZE, queue_size=Q)
# The student's key bias has an exactly zero gradient (a shift shared by
# all keys leaves the softmax as it is), so what each package computes for
# it is rounding noise, which LARS's trust ratio scales up to a full step.
DEGENERATE = "attn.k.bias"


def checkpoint_scale(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.2 * rng.standard_normal(x.shape)
        if name == "gamma":
            return 0.5 + 0.2 * rng.standard_normal(x.shape)
        return 0.5 * rng.standard_normal(x.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), tree)


def _jax_setup(name):
    j_cls, j_args_cls = METHODS[name][:2]
    method = j_cls(jax_get_wrapped_model(STUDENT), j_args_cls(**ARGS))
    params, model_state, method_state = method.init(
        jax.random.key(0), jnp.zeros((2, SIZE, SIZE, 3), jnp.float32))
    params = checkpoint_scale(params, 0)
    teacher = {"params": checkpoint_scale(method_state["teacher"]["params"],
                                          1)}
    return method, params, model_state, {**method_state, "teacher": teacher}


def _port_setup(name, jax_params, jax_method_state):
    cls, args_cls = METHODS[name][2:]
    method = cls(get_wrapped_model(STUDENT), args_cls(**ARGS))
    params, method_state = method.init(torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    params.load_state_dict(params_from_jax(jax.device_get(jax_params)))
    carried = method_state_from_jax(jax.device_get(jax_method_state))
    method_state["teacher"].load_state_dict(carried["teacher"])
    method_state.update({k: v for k, v in carried.items() if k != "teacher"})
    named = dict(params.named_parameters())
    updater = build_update(method, method.default_optimizer_args(),
                           cosine_warmup(LR[name], TOTAL, 2), named, TOTAL)
    return method, TrainState(0, params, method_state, updater)


def jax_mixup_draw(rng, mixup_prob):
    """The (lam, apply) the JAX loss draws from ``rng``
    (``distillationv3.py``: k_mix, _ = split(rng); k_apply, k_lam =
    split(k_mix))."""
    k_apply, k_lam = jax.random.split(jax.random.split(rng)[0])
    lam = jax.random.uniform(k_lam, (B, 1, 1, 1), minval=0.5, maxval=1.0)
    apply = jax.random.uniform(k_apply, (B, 1, 1, 1)) < mixup_prob
    return lam, apply


def _assert_close(state_dict, jax_tree, what):
    ref = params_from_jax(jax.device_get(jax_tree))
    assert set(ref) == set(state_dict), what
    for name, r in ref.items():
        if name.endswith(DEGENERATE):
            continue
        np.testing.assert_allclose(state_dict[name].detach().numpy(),
                                   r.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", sorted(METHODS))
def test_three_distillation_steps_match_jax(name):
    j_method, j_params, j_model_state, j_ms = _jax_setup(name)
    method, state = _port_setup(name, j_params, j_ms)
    start = {k: v.detach().clone() for k, v in state.params.state_dict().items()}
    j_args = j_method.default_optimizer_args()
    j_opt = build_optimizer(
        j_args, jax_cw(LR[name], TOTAL, 2), j_params,
        grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params))
    j_opt_state = j_opt.init(j_params)
    assert type(j_args).__name__ == type(
        method.default_optimizer_args()).__name__
    step_fn = make_train_step(method, TOTAL)

    @jax.jit
    def j_grad(p, method_state, views, rng, step):
        return jax.value_and_grad(
            lambda p: j_method.loss_fn(p, j_model_state, method_state, views,
                                       rng, step, TOTAL),
            has_aux=True)(p)

    applied = []
    for step in range(3):
        rng_np = np.random.default_rng(100 + step)
        view = rng_np.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
        rng = jax.random.key(1000 + step)
        (j_loss, (_, j_ms, _)), grads = j_grad(
            j_params, j_ms, [jnp.asarray(view)], rng, jnp.asarray(step))
        updates, j_opt_state = j_opt.update(grads, j_opt_state, j_params)
        updates = j_method.mask_updates(updates, step)
        j_params = optax.apply_updates(j_params, updates)
        j_ms = j_method.post_update(j_params, j_ms, step, TOTAL)

        masks = None
        if method.args.mixup_prob > 0:
            lam, apply = jax_mixup_draw(rng, method.args.mixup_prob)
            applied += np.asarray(apply).ravel().tolist()
            masks = [(torch.tensor(np.asarray(lam)),
                      torch.tensor(np.asarray(apply)))]
        metrics = step_fn(state, None, None, views=[[torch.tensor(view)]],
                          masks=masks)
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(j_loss), rtol=1e-4)
        _assert_close(dict(state.params.named_parameters()), j_params,
                      f"step {step} params")
        ms = state.method_state
        np.testing.assert_allclose(ms["queue"].numpy(),
                                   np.asarray(j_ms["queue"]), rtol=1e-4,
                                   atol=1e-5)
        assert (ms["queue_ptr"], ms["queue_filled"]) == (
            int(j_ms["queue_ptr"]), int(j_ms["queue_filled"]))
    assert state.step == 3
    if name != "distillationv1":
        # Steps 1 and 2 ran on a partly filled queue (4 and 8 of 16 rows):
        # its zero rows stay in the softmax.
        assert state.method_state["queue_filled"] == 12
        assert any(applied) and not all(applied)
    # The steps moved the weights well beyond the tolerance.
    moved = max((v - start[k]).abs().max().item()
                for k, v in state.params.state_dict().items())
    assert moved > 5e-3


def test_mixup_matches_jax():
    j_method = JV3.DistillationV3(jax_get_wrapped_model(STUDENT),
                                  JV3.DistillationV3Args(**ARGS))
    images = np.random.default_rng(0).standard_normal(
        (B, 8, 8, 3)).astype(np.float32)
    for seed in range(3):
        key = jax.random.key(seed)
        ref = j_method._mixup(key, jnp.asarray(images))
        k_apply, k_lam = jax.random.split(key)
        lam = jax.random.uniform(k_lam, (B, 1, 1, 1), minval=0.5, maxval=1.0)
        apply = jax.random.uniform(k_apply, (B, 1, 1, 1)) < 0.5
        got = V3.mixup(torch.tensor(images), torch.tensor(np.asarray(lam)),
                       torch.tensor(np.asarray(apply)))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def test_mixup_draw_from_the_generator():
    method = V3.DistillationV3(get_wrapped_model(STUDENT),
                               V3.DistillationV3Args(**ARGS))
    images = torch.zeros((64, 2, 2, 3))
    lam, apply = method.draw_mixup(torch.Generator().manual_seed(0), images)
    assert lam.shape == apply.shape == (64, 1, 1, 1)
    assert 0.5 <= lam.min() and lam.max() < 1.0
    assert 0 < apply.sum() < 64
    again = method.draw_mixup(torch.Generator().manual_seed(0), images)
    assert torch.equal(lam, again[0]) and torch.equal(apply, again[1])


@pytest.mark.parametrize("src,dst", [(16, 14), (8, 7), (7, 14)])
def test_resample_matches_jax_image_resize(src, dst):
    """16 -> 14 and 8 -> 7 downsample (antialiased in JAX), 7 -> 14
    upsamples; forward and gradient."""
    rng = np.random.default_rng(src)
    z = rng.standard_normal((2, src, src, 5)).astype(np.float32)
    w = rng.standard_normal((2, dst, dst, 5)).astype(np.float32)

    def j_fn(x):
        return jax.image.resize(x, (2, dst, dst, 5), "bilinear")

    ref = j_fn(jnp.asarray(z))
    ref_grad = jax.grad(lambda x: jnp.sum(j_fn(x) * w))(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    got = V3.resample_grid(zt, (dst, dst))
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [(16, 14), (8, 7), (7, 14), (16, 16)])
def test_resize_weights_match_jax_and_torch(src, dst):
    """The weights are JAX's ``compute_weight_mat``; the resample is
    ``F.interpolate``'s antialiased bilinear one within rounding."""
    import torch.nn.functional as F
    from jax._src.image.scale import compute_weight_mat

    ref = compute_weight_mat(src, dst, dst / src, 0.0,
                             lambda x: jnp.maximum(0, 1 - jnp.abs(x)), True)
    np.testing.assert_allclose(V3.resize_weights(src, dst),
                               np.asarray(ref).T, rtol=0, atol=1e-7)
    z = torch.randn(2, src, src, 3, generator=torch.Generator().manual_seed(0))
    aa = F.interpolate(z.permute(0, 3, 1, 2), size=(dst, dst),
                       mode="bilinear", align_corners=False, antialias=True)
    np.testing.assert_allclose(
        torch.einsum("oh,xw,bhwd->boxd",
                     torch.from_numpy(V3.resize_weights(src, dst)),
                     torch.from_numpy(V3.resize_weights(src, dst)),
                     z).numpy(),
        aa.permute(0, 2, 3, 1).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("q,ptr,b", [(4, 3, 6), (16, 0, 64), (16, 5, 3)])
def test_enqueue_matches_jax(q, ptr, b):
    """The JAX scatter keeps the last row written to a slot (B > Q); the
    port writes only those rows."""
    rng = np.random.default_rng(q + ptr + b)
    queue = rng.standard_normal((q, 3)).astype(np.float32)
    rows = rng.standard_normal((b, 3)).astype(np.float32)
    idx = (ptr + jnp.arange(b)) % q
    ref = jnp.asarray(queue).at[idx].set(jnp.asarray(rows))
    state = {"queue": torch.tensor(queue), "queue_ptr": ptr,
             "queue_filled": 1, "other": "kept"}
    new = V3.enqueue(state, torch.tensor(rows))
    np.testing.assert_array_equal(new["queue"].numpy(), np.asarray(ref))
    assert new["queue_ptr"] == (ptr + b) % q
    assert new["queue_filled"] == min(1 + b, q)
    assert new["other"] == "kept"
    assert np.array_equal(state["queue"].numpy(), queue)  # not in place


@pytest.mark.parametrize("shape", [(5, 8), (3, 4, 8)])
def test_losses_match_jax(shape):
    """A queue with zero rows (0 < filled < Q) keeps them in the softmax."""
    rng = np.random.default_rng(len(shape))
    s, t = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    queue = rng.standard_normal((6, 8)).astype(np.float32)
    queue[4:] = 0.0
    ref = JL.similarity_queue_ce(jnp.asarray(s), jnp.asarray(t),
                                 jnp.asarray(queue), 0.07)
    got = L.similarity_queue_ce(torch.tensor(s), torch.tensor(t),
                                torch.tensor(queue), 0.07)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(
        L.mse_feature_loss(torch.tensor(s), torch.tensor(t)).item(),
        float(JL.mse_feature_loss(jnp.asarray(s), jnp.asarray(t))),
        rtol=1e-6)


def test_projection_head_matches_jax():
    head_j = JaxProjectionHead(out_dim=12)
    params = head_j.init(jax.random.key(0), jnp.zeros((1, 8)))["params"]
    params = checkpoint_scale(jax.device_get(params), 2)
    head_t = ProjectionHead(8, 12)
    head_t.load_state_dict(params_from_jax(params))
    x = np.random.default_rng(3).standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_allclose(
        head_t(torch.tensor(x)).detach().numpy(),
        np.asarray(head_j.apply({"params": params}, jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


def test_teacher_and_heads_compute_in_fp32_in_a_bf16_run():
    """The JAX package builds the teacher at its default fp32 and the heads
    at ProjectionHead's fp32, whatever the run's precision; so does the
    port."""
    j_method = JV3.DistillationV3(
        jax_get_wrapped_model(STUDENT, dtype=jnp.bfloat16),
        JV3.DistillationV3Args(**ARGS))
    assert j_method.teacher.module.cfg.dtype == jnp.float32
    assert j_method.global_head.dtype == j_method.local_head.dtype == jnp.float32
    method = V3.DistillationV3(
        get_wrapped_model(STUDENT, dtype=torch.bfloat16),
        V3.DistillationV3Args(**ARGS))
    params, method_state = method.init(torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    assert method_state["teacher"].cfg.dtype == torch.float32
    assert not any(p.requires_grad
                   for p in method_state["teacher"].parameters())
    for head in ("global_head", "local_head"):
        assert params[head].proj.dtype == torch.float32
    images = torch.rand((2, SIZE, SIZE, 3)).to(torch.bfloat16)
    t_global, t_local, z_global, z_local = method.forward_pair(
        params, method_state, images)
    assert params["student"](images)["cls_token"].dtype == torch.bfloat16
    assert t_global.dtype == t_local.dtype == torch.float32
    assert z_global.dtype == z_local.dtype == torch.float32
    assert not t_global.requires_grad and z_global.requires_grad
    assert z_local.shape == t_local.shape == (2, 7, 7, 32)


def test_teacher_weights_from_an_exported_folder(tmp_path):
    teacher = get_wrapped_model(TEACHER).module
    teacher.reset_parameters(torch.Generator().manual_seed(7))
    export_model(tmp_path / "teacher", TEACHER, teacher.state_dict())
    method = V3.DistillationV3(
        get_wrapped_model(STUDENT),
        V3.DistillationV3Args(**ARGS, teacher_weights=str(tmp_path
                                                          / "teacher")))
    _, method_state = method.init(torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    for k, v in teacher.state_dict().items():
        assert torch.equal(method_state["teacher"].state_dict()[k], v), k
    with pytest.raises(ConfigError, match="exported for model"):
        V3.DistillationV3(get_wrapped_model(STUDENT), V3.DistillationV3Args(
            teacher="dinov3/vitt16",
            teacher_weights=str(tmp_path / "teacher")))


def test_a_pth_teacher_names_its_roadmap_item(tmp_path):
    """A torch checkpoint file as ``teacher_weights`` now converts (Meta's
    DINOv3 naming: ``storage_tokens``, fused qkv with its k bias masked);
    a ResNet's, for this ViT teacher, goes to the ResNet converter (ported
    with the ResNets, item 10), which the ViT's config cannot size: an
    AttributeError, as in the JAX package."""
    teacher = get_wrapped_model(TEACHER).module
    teacher.reset_parameters(torch.Generator().manual_seed(7))
    state = teacher.state_dict()
    meta = {"storage_tokens": state["register_tokens"],
            "mask_token": state["mask_token"][None]}
    for k, v in state.items():
        if ".attn.q." in k:
            d = v.shape[0]
            meta[k.replace(".q.", ".qkv.")] = torch.cat(
                [state[k.replace(".q.", f".{n}.")] if n != "k"
                 or k.endswith("weight") else torch.zeros(d)
                 for n in "qkv"])
            if k.endswith("bias"):
                meta[k.replace(".q.bias", ".qkv.bias_mask")] = torch.cat(
                    [torch.ones(d), torch.zeros(d), torch.ones(d)])
        elif not (".attn.k." in k or ".attn.v." in k
                  or k in ("register_tokens", "mask_token")):
            meta[k.replace("patch_embed.", "patch_embed.proj.")] = v
    path = tmp_path / "dinov3_vittest16.pth"
    torch.save(meta, path)
    method = V3.DistillationV3(get_wrapped_model(STUDENT),
                               V3.DistillationV3Args(
                                   **ARGS, teacher_weights=str(path)))
    _, method_state = method.init(torch.Generator().manual_seed(0),
                                  torch.device("cpu"))
    loaded = method_state["teacher"].state_dict()
    assert loaded.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(loaded[k], v), k
    torch.save({"conv1.weight": torch.zeros(8, 3, 7, 7)}, path)
    with pytest.raises(AttributeError, match="stage_sizes"):
        JV3.DistillationV3(jax_get_wrapped_model(STUDENT),
                           JV3.DistillationV3Args(
                               **ARGS, teacher_weights=str(path)))
    with pytest.raises(AttributeError, match="stage_sizes"):
        V3.DistillationV3(get_wrapped_model(STUDENT), V3.DistillationV3Args(
            **ARGS, teacher_weights=str(path)))


def test_the_default_method_is_distillation_v3_with_lars():
    assert get_method_cls("distillation") == (V3.DistillationV3,
                                              V3.DistillationV3Args)
    args = V3.DistillationV3Args()
    assert args.teacher == "dinov3/vitb16"
    method = V3.DistillationV3(get_wrapped_model(STUDENT),
                               V3.DistillationV3Args(**ARGS))
    opt = method.default_optimizer_args()
    assert (opt.type, opt.lr, opt.momentum, opt.weight_decay) == (
        "lars", 1.8, 0.9, 1e-6)
    assert method.learning_rate_for(64, 1.8) == pytest.approx(1.8 * 64 / 1536)


@pytest.mark.parametrize("size,queue", [(999, 16), (1_000, 128),
                                        (50_000, 1024), (10 ** 6, 8192)])
def test_queue_size_buckets_match_jax(size, queue):
    from lightly_train_tpu._scaling import ScalingInfo as JaxScalingInfo
    from lightly_train_tpu_torch._scaling import ScalingInfo

    args = V3.DistillationV3Args()
    args.resolve_auto(ScalingInfo(dataset_size=size, epochs=1))
    j_args = JV3.DistillationV3Args()
    j_args.resolve_auto(JaxScalingInfo(dataset_size=size, epochs=1))
    assert args.queue_size == j_args.queue_size == queue


@pytest.fixture
def data(tmp_path):
    """Ten 36 x 36 PPM images."""
    folder = tmp_path / "images"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        img = rng.integers(0, 256, (36, 36, 3), dtype=np.uint8)
        (folder / f"{i}.ppm").write_bytes(b"P6\n36 36\n255\n" + img.tobytes())
    return folder


def _pretrain(out, data, **kwargs):
    args = dict(out=str(out), data=str(data), model=STUDENT,
                accelerator="cpu", batch_size=4, steps=2, precision="fp32",
                canonical_size=36, num_workers=0, log_every=1,
                method_args={"teacher": TEACHER, "image_size": 32})
    args.update(kwargs)
    return lt.pretrain(**args)


@pytest.mark.parametrize("method", [None, "distillationv2", "distillationv1"])
def test_pretrain_distillation_on_cpu_end_to_end(tmp_path, data, method):
    """The default method (None: not passed) and v2 and v1: finite losses,
    the queue's integers, the checkpoint and a student-only export."""
    kwargs = {} if method is None else {"method": method}
    state = _pretrain(tmp_path / "out", data, **kwargs)
    out = tmp_path / "out"
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
             .splitlines()]
    hp = lines[0]["hyperparams"]
    steps = [r for r in lines if "step" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["grad_norm"])
               for r in steps)
    ms = state.method_state
    queued = 0 if method == "distillationv1" else 8
    assert (ms["queue_ptr"], ms["queue_filled"]) == (queued, queued)
    assert ms["queue"].shape == (16, 32)  # 10 images: the 16-slot bucket
    if method is None:
        assert hp["method"] == "distillation"
        assert hp["optim_args"]["type"] == "lars"
        assert hp["resolved_lr"] == pytest.approx(1.8 * 4 / 1536)
    ckpt = torch.load(out / "checkpoints" / "step_2.pt", weights_only=False)
    assert ckpt["method_state"]["queue_filled"] == queued
    assert "cls_token" in ckpt["method_state"]["teacher"]
    export = load_exported_model(out / "exported_models" / "exported_last")
    assert export["model_name"] == STUDENT
    assert set(export["state_dict"]) == set(
        state.params["student"].state_dict())


class _Interrupted(Exception):
    pass


def test_resume_gives_bitwise_the_uninterrupted_distillation_run(
        tmp_path, data, monkeypatch):
    full = _pretrain(tmp_path / "full", data, steps=4, checkpoint_every=2)

    class Loader(PretrainLoader):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 2:
                    raise _Interrupted
                yield batch

    monkeypatch.setattr(T, "PretrainLoader", Loader)
    with pytest.raises(_Interrupted):
        _pretrain(tmp_path / "cut", data, steps=4, checkpoint_every=2)
    monkeypatch.undo()
    resumed = _pretrain(tmp_path / "cut", data, steps=4, checkpoint_every=2,
                        resume_interrupted=True)
    assert resumed.step == full.step == 4
    assert resumed.updater.count == full.updater.count == 4

    def tensors(state):
        out = {f"params.{k}": v for k, v in state.params.state_dict().items()}
        out.update({f"teacher.{k}": v for k, v in
                    state.method_state["teacher"].state_dict().items()})
        out["queue"] = state.method_state["queue"]
        out.update({f"trace.{k}": v for k, v in
                    state.updater.moments["trace"].items()})
        return out

    a, b = tensors(full), tensors(resumed)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for key in ("queue_ptr", "queue_filled"):
        assert full.method_state[key] == resumed.method_state[key]
