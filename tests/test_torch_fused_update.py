"""The port's fused AdamW+EMA update against the JAX package's.

The plain version of the kernel is held against the Pallas kernel run by the
interpreter (a leaf of at least 64K elements, which the JAX package sends to
its kernel) and against the jnp expression (a small leaf, which it does
not); ``FusedAdamWEMA`` is held against the JAX class in ``jnp`` mode for 3
steps with grad clipping, lr scales, a wd mask, the prototype freeze and an
EMA momentum schedule, and with a leaf that gets no gradient against the JAX
class fed zeros. The kernel's chunk plan covers every element once, and the
vectorised scalar table is bitwise the per-leaf loop it replaced. Run with

    python -m pytest tests/test_torch_fused_update.py -q
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lightly_train_tpu._optim import AdamWArgs as JaxAdamWArgs
from lightly_train_tpu._optim.fused_update import (
    FusedAdamWEMA as JaxFusedAdamWEMA,
)
from lightly_train_tpu._optim.fused_update import _jnp_leaf, fused_adamw_ema_leaf
from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch._optim import AdamWArgs, cosine_warmup
from lightly_train_tpu_torch._optim import fused_update as F
from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model

HP = dict(b1=0.9, b2=0.999, eps=1e-8)
SCALARS = np.array([[0.7, 1.5, 1.1, 2e-3, 0.04, 0.995, 0.0, 0.0]], np.float32)


def _leaf_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    g, p, t = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    mu = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    nu = (rng.random(shape) * 0.01).astype(np.float32)
    return g, p, mu, nu, t


@pytest.mark.parametrize("shape,pallas", [((256, 512), True), ((10, 10), False)])
def test_plain_leaf_matches_jax(shape, pallas):
    arrays = _leaf_inputs(shape, seed=shape[0])
    jargs = [jnp.asarray(a) for a in arrays] + [jnp.asarray(SCALARS)]
    if pallas:
        ref = fused_adamw_ema_leaf(*jargs, interpret=True, **HP)
    else:
        ref = _jnp_leaf(*jargs, **HP)
    g, *state = [torch.tensor(a) for a in arrays]
    F.fused_adamw_ema(F.LeafSet(*([x] for x in state)), [g], SCALARS, **HP)
    tensors = [g, *state]
    # Same fp32 arithmetic in the same order; only XLA's fusion may contract
    # a multiply-add.
    for got, r in zip(tensors[1:], ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "student": {"w": rng.standard_normal((64, 32)).astype(np.float32),
                    "b": rng.standard_normal((32,)).astype(np.float32)},
        "prototypes": {"v": rng.standard_normal((16, 8)).astype(np.float32)},
        "cls_token": rng.standard_normal((1, 5, 8)).astype(np.float32),
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


LR_SCALES = {"student.w": 0.5, "student.b": 0.5, "prototypes.v": 1.0,
             "cls_token": 0.25}
WD_MASK = {"student.w": True, "student.b": False, "prototypes.v": True,
           "cls_token": False}
FREEZE_STEPS = 2


def _nest(flat):
    out = {}
    for name, v in flat.items():
        *head, leaf = name.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = v
    return out


def test_fused_updater_matches_jax_for_three_steps():
    params_np = _tree(0)
    names = list(_flat(params_np))

    lr = lambda c: 1e-3 * (1.0 + 0.1 * c)  # noqa: E731
    wd = lambda c: 0.04 + 0.001 * c  # noqa: E731
    momentum = lambda s: 0.99 + 0.001 * s  # noqa: E731

    def jax_scales(step):
        live = (jnp.asarray(step) >= FREEZE_STEPS).astype(jnp.float32)
        return _nest({n: live if n.startswith("prototypes") else 1.0
                      for n in names})

    args_j = JaxAdamWArgs(lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=0.04)
    j_params = jax.tree_util.tree_map(jnp.asarray, params_np)
    j_teacher = jax.tree_util.tree_map(jnp.copy, j_params)
    j_opt = (optax.scale_by_adam(0.9, 0.999, 1e-8).init(j_params),)
    j_upd = JaxFusedAdamWEMA(
        args_j, lr, j_params, grad_clip_norm=3.0,
        lr_scales=_nest(LR_SCALES), weight_decay_schedule=wd,
        momentum_fn=momentum, update_scales_fn=jax_scales,
        wd_mask=_nest(WD_MASK), mode="jnp",
    )

    t_params = {n: torch.tensor(v) for n, v in _flat(params_np).items()}
    t_teacher = {n: v.clone() for n, v in t_params.items()}
    t_upd = F.FusedAdamWEMA(
        AdamWArgs(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.04),
        lr, t_params, grad_clip_norm=3.0, lr_scales=LR_SCALES,
        weight_decay_schedule=wd, momentum_fn=momentum,
        update_scales_fn=lambda s: {
            n: float(s >= FREEZE_STEPS) if n.startswith("prototypes") else 1.0
            for n in names},
        wd_mask=WD_MASK,
    )

    rng = np.random.default_rng(1)
    for step in range(3):
        # Step 1 has huge gradients, so the global-norm clip triggers.
        grads_np = {n: (rng.standard_normal(v.shape)
                        * (100.0 if step == 1 else 0.1)).astype(np.float32)
                    for n, v in _flat(params_np).items()}
        j_params, j_teacher, j_opt, j_norm = j_upd.update_and_apply(
            jax.tree_util.tree_map(jnp.asarray, _nest(grads_np)), j_opt,
            j_params, j_teacher, jnp.asarray(step))
        t_norm = t_upd.update_and_apply(
            {n: torch.tensor(g) for n, g in grads_np.items()}, t_params,
            t_teacher, step)
        np.testing.assert_allclose(float(t_norm), float(j_norm), rtol=1e-5)
        for name, ref in _flat(j_params).items():
            np.testing.assert_allclose(t_params[name].numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-7, err_msg=name)
        for name, ref in _flat(j_teacher).items():
            np.testing.assert_allclose(t_teacher[name].numpy(),
                                       np.asarray(ref), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    adam = j_opt[0]
    assert int(adam.count) == t_upd.count == 3
    for name, ref in _flat(adam.mu).items():
        np.testing.assert_allclose(t_upd.mu[name].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-8)
    for name, ref in _flat(adam.nu).items():
        np.testing.assert_allclose(t_upd.nu[name].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-9)
    # The prototypes were frozen for the first FREEZE_STEPS steps only.
    assert not np.allclose(t_params["prototypes.v"].numpy(),
                           params_np["prototypes"]["v"])


def test_leaf_wrapper_runs_plain_in_place_on_cpu(monkeypatch):
    """On the CPU the wrapper runs the plain version in place, leaf by leaf,
    and never touches the kernel library (no nvcc here)."""
    monkeypatch.setattr(_native, "function", None)
    before = F.fused_adamw_ema.launches
    leaves = [[torch.tensor(a) for a in _leaf_inputs(shape, 2)]
              for shape in ((3, 5), (7,))]
    p0 = [leaf[1].clone() for leaf in leaves]
    F.fused_adamw_ema(F.LeafSet(*([leaf[k] for leaf in leaves]
                                  for k in range(1, 5))),
                      [leaf[0] for leaf in leaves],
                      np.repeat(SCALARS, 2, axis=0), **HP)
    for leaf, before_p in zip(leaves, p0):
        assert not torch.equal(leaf[1], before_p)
    assert F.fused_adamw_ema.launches == before


# Leaf sizes for the plan: 1, ragged tails, exact multiples of the chunk,
# a chunk plus 3, empty leaves, and the ViT-B/14 mix of large and small.
PLAN_CASES = [
    ([1], 4),
    ([3, 5, 4097, 65537], 4096),
    ([4096, 8192, 12288], 4096),
    ([4099, 1, 0, 7], 4096),
    ([0, 0, 5], 8),
    ([768] * 10 + [589824, 2304, 2359296], 32768),
    ([65536 * 2048 + 3], 65536),
    ([32768 + 3, 32768, 32767], 32768),
]


@pytest.mark.parametrize("sizes,chunk", PLAN_CASES)
def test_plan_chunks_covers_every_element_once(sizes, chunk):
    plan = F.plan_chunks(sizes, chunk)
    assert plan.dtype == F.CHUNK and F.CHUNK.itemsize == 16
    assert (plan["count"] > 0).all() and (plan["count"] <= chunk).all()
    assert (plan["start"] % chunk == 0).all()
    for leaf, n in enumerate(sizes):
        mine = plan[plan["leaf"] == leaf]
        if n == 0:
            assert len(mine) == 0
            continue
        # In order, back to back from 0 to n: every element exactly once.
        ends = mine["start"] + mine["count"]
        assert list(mine["start"]) == [0, *ends[:-1]] and ends[-1] == n
    assert list(plan["leaf"]) == sorted(plan["leaf"])


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.integers(0, 3 * 4096 + 5), max_size=12),
       st.integers(1, 1024).map(lambda k: 4 * k))
def test_plan_chunks_covers_every_element_once_for_any_sizes(sizes, chunk):
    plan = F.plan_chunks(sizes, chunk)
    covered = [np.zeros(n, np.int64) for n in sizes]
    for c in plan:
        covered[c["leaf"]][c["start"]:c["start"] + c["count"]] += 1
        assert 0 < c["count"] <= chunk and c["start"] % 4 == 0
    assert all((c == 1).all() for c in covered)


@pytest.mark.parametrize("sizes,chunk", [([4], 6), ([4], 0), ([-1], 4),
                                         ([4], 2 ** 31)])
def test_plan_chunks_refuses_what_the_kernel_cannot_take(sizes, chunk):
    with pytest.raises(ValueError):
        F.plan_chunks(sizes, chunk)


def _per_leaf_scalars(upd, lr_scales, update_scales_fn, wd_mask, step):
    """The scalar table as it was built before it was vectorised: a loop
    over the leaves of numpy float32 scalar arithmetic (column 0 left to
    the device)."""
    a = upd.args
    f32 = np.float32
    count = upd.count
    lr = f32(upd.learning_rate(count) if callable(upd.learning_rate)
             else upd.learning_rate)
    wd = f32(upd.weight_decay_schedule(count)
             if upd.weight_decay_schedule is not None else a.weight_decay)
    m = f32(upd.momentum_fn(step) if upd.momentum_fn is not None else 1.0)
    cif = f32(count + 1)
    bc1 = f32(1.0) / (f32(1.0) - np.power(f32(a.betas[0]), cif))
    bc2 = f32(1.0) / (f32(1.0) - np.power(f32(a.betas[1]), cif))
    us = update_scales_fn(step) if update_scales_fn is not None else None
    out = np.zeros((len(upd.names), 8), np.float32)
    for i, name in enumerate(upd.names):
        s = f32(lr_scales[name]) if lr_scales is not None else 1
        u = f32(us[name]) if us is not None else 1
        out[i, 1:6] = (bc1, bc2, lr * f32(s) * f32(u),
                       wd if wd_mask[name] else f32(0.0), m)
    return out


def _dinov2_updater():
    method = DINOv2(get_wrapped_model("dinov2/vittest14"), DINOv2Args(
        output_dim=64, hidden_dim=32, bottleneck_dim=16, local_view_count=2,
        freeze_last_layer_steps=4))
    params, _ = method.init(torch.Generator().manual_seed(0),
                            torch.device("cpu"))
    named = dict(params.named_parameters())
    upd = F.build_fused_updater(method, method.default_optimizer_args(),
                                cosine_warmup(5e-3, 10, 3), named, 10)
    return upd, (method.lr_scales(named),
                 lambda step: method.update_scales(named, step),
                 method.wd_mask(named))


def _plain_updater():
    names = list(_flat(_tree(0)))
    params = {n: torch.tensor(v) for n, v in _flat(_tree(0)).items()}
    upd = F.FusedAdamWEMA(AdamWArgs(lr=1e-3, weight_decay=0.04), 1e-3,
                          params)
    return upd, (None, None, F.no_weight_decay_mask(params))


@pytest.mark.parametrize("make", [_dinov2_updater, _plain_updater],
                         ids=["dinov2", "constant"])
def test_scalar_table_is_bitwise_the_per_leaf_loop(make):
    """Over steps that span the lr warmup and cosine, the wd cosine, the
    momentum schedule and the prototype freeze (DINOv2), and without any
    schedule or per-leaf scale (constant)."""
    upd, ingredients = make()
    for step in range(10):
        upd.count = step
        got = upd.scalar_table(step)
        ref = _per_leaf_scalars(upd, *ingredients, step)
        assert got.dtype == np.float32 and got.shape == ref.shape
        assert (got[:, 0] == 1.0).all()  # cs, without a clip
        assert got[:, 1:].tobytes() == ref[:, 1:].tobytes(), step
    if make is _dinov2_updater:
        # The freeze shows in the table: prototypes frozen, then live.
        proto = ["prototypes" in n.split(".") for n in upd.names]
        assert any(proto)
        upd.count = 5  # past the lr warmup
        frozen, live = upd.scalar_table(3)[:, 3], upd.scalar_table(4)[:, 3]
        assert (frozen[proto] == 0).all() and (live[proto] > 0).all()
        assert (frozen[~np.array(proto)] > 0).all()


def test_a_leaf_without_gradient_matches_jax_fed_zeros():
    """A ``None`` gradient is a gradient of zeros (the kernel reads no g
    there): the moments decay, weight decay and the EMA still apply."""
    params_np = _tree(3)
    args_j = JaxAdamWArgs(lr=1e-2, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=0.04)
    j_params = jax.tree_util.tree_map(jnp.asarray, params_np)
    j_teacher = jax.tree_util.tree_map(jnp.copy, j_params)
    j_opt = (optax.scale_by_adam(0.9, 0.999, 1e-8).init(j_params),)
    j_upd = JaxFusedAdamWEMA(args_j, 1e-2, j_params, grad_clip_norm=3.0,
                             momentum_fn=lambda s: 0.9,
                             wd_mask=_nest(WD_MASK), mode="jnp")
    t_params = {n: torch.tensor(v) for n, v in _flat(params_np).items()}
    t_teacher = {n: v.clone() for n, v in t_params.items()}
    t_upd = F.FusedAdamWEMA(
        AdamWArgs(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.04),
        1e-2, t_params, grad_clip_norm=3.0, momentum_fn=lambda s: 0.9,
        wd_mask=WD_MASK)
    rng = np.random.default_rng(4)
    for step in range(2):
        grads_np = {n: rng.standard_normal(v.shape).astype(np.float32)
                    for n, v in _flat(params_np).items()}
        grads_np["student.w"] = np.zeros_like(grads_np["student.w"])
        j_params, j_teacher, j_opt, j_norm = j_upd.update_and_apply(
            jax.tree_util.tree_map(jnp.asarray, _nest(grads_np)), j_opt,
            j_params, j_teacher, jnp.asarray(step))
        t_grads = {n: torch.tensor(g) for n, g in grads_np.items()}
        t_grads["student.w"] = None
        t_norm = t_upd.update_and_apply(t_grads, t_params, t_teacher, step)
        np.testing.assert_allclose(float(t_norm), float(j_norm), rtol=1e-6)
        for mine, ref in ((t_params, j_params), (t_teacher, j_teacher)):
            for name, r in _flat(ref).items():
                np.testing.assert_allclose(mine[name].numpy(), np.asarray(r),
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=name)
    np.testing.assert_allclose(t_upd.mu["student.w"].numpy(),
                               np.asarray(j_opt[0].mu["student"]["w"]),
                               rtol=1e-5, atol=1e-8)
    # Weight decay moved the leaf with no gradient.
    assert not np.allclose(t_params["student.w"].numpy(),
                           params_np["student"]["w"])


def test_leaf_set_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((4, 4))
    for bad in ([x.double()], [x.t()[:, :3]], [torch.zeros(15)], []):
        with pytest.raises(ValueError):
            F.LeafSet([x][:len(bad)], bad, [x][:len(bad)], [x][:len(bad)])
    with pytest.raises(ValueError):
        F.LeafSet([x], [x], [x], [x, x])
