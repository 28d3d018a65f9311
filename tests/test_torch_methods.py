"""DINO, SimCLR, DenseCL, DetCon-B/S and DINOv31 of the port against the JAX
package.

``dinov2/vittest14`` at 112^2 (an 8 x 8 patch grid; DINO's and DINOv31's
local views at 56^2), batch 4, float32 with TF32 off, small heads. Both
packages start from the same checkpoint-scale weights (``params_from_jax``)
and the same method state (``method_state_from_jax``; every EMA teacher
drawn apart from its student, so a mix-up of the two shows), and take the
same explicit views. Draws the JAX loss makes from its own key are handed to
the port: DINOv31's iBOT masks and DenseCL's dense match. Each step runs the
loss, its gradient and the method's default update in both (the fused
AdamW+EMA update for DINO and DINOv31, LARS for SimCLR and DetCon, SGD and
the EMA for DenseCL); the loss, every parameter and every method-state
tensor are compared after each of three steps.

Also: ``ntxent_loss``, ``grid_masks``, ``paka_overlap_validity``, the PaKA
loss and DenseCL's match against their JAX counterparts, and the method
registry (``list_methods``, ``get_method_cls``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import lightly_train_tpu_torch as lt
from lightly_train_tpu._optim import build_optimizer
from lightly_train_tpu._optim import cosine_warmup as jax_cw
from lightly_train_tpu._optim.fused_update import build_fused_updater as jbfu
from lightly_train_tpu.errors import UnknownMethodError as JaxUnknownMethod
from lightly_train_tpu.methods import densecl as JDC
from lightly_train_tpu.methods import detcon as JDT
from lightly_train_tpu.methods import dino as JDINO
from lightly_train_tpu.methods import dinov31 as JD31
from lightly_train_tpu.methods import method_helpers as JMH
from lightly_train_tpu.methods import simclr as JSC
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops import losses as JL
from lightly_train_tpu.ops.masking import random_block_masks
from lightly_train_tpu_torch._commands.train_loop import make_train_step
from lightly_train_tpu_torch._optim import cosine_warmup
from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
from lightly_train_tpu_torch._optim.update import build_update
from lightly_train_tpu_torch.errors import UnknownMethodError
from lightly_train_tpu_torch.methods import densecl as DC
from lightly_train_tpu_torch.methods import detcon as DT
from lightly_train_tpu_torch.methods import dino as DINO
from lightly_train_tpu_torch.methods import dinov31 as D31
from lightly_train_tpu_torch.methods import method_helpers as MH
from lightly_train_tpu_torch.methods import simclr as SC
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.models.from_jax import (
    method_state_from_jax,
    params_from_jax,
)
from lightly_train_tpu_torch.models.package_registry import get_wrapped_model
from lightly_train_tpu_torch.ops import losses as L
from torch_fixtures.threads import one_torch_thread  # noqa: F401

STUDENT = "dinov2/vittest14"
SIZE, LOCAL, B, TOTAL, GRID = 112, 56, 4, 10, 8
MULTI_CROP = dict(output_dim=64, hidden_dim=32, bottleneck_dim=16,
                  local_view_count=2, global_image_size=SIZE,
                  local_image_size=LOCAL, freeze_last_layer_steps=1)
TWO_VIEWS = dict(image_size=SIZE, hidden_dim=32, output_dim=16)
# name -> (JAX method, JAX args, port method, port args, method_args,
# base learning rate). LARS scales each leaf's step to lr * 0.001 * ||p||,
# so lr 20 moves the weights by about 2% a step; AdamW's first steps move
# them by about lr; SGD's by lr times the gradient.
CASES = {
    "dino": (JDINO.DINO, JDINO.DINOArgs, DINO.DINO, DINO.DINOArgs,
             MULTI_CROP, 5e-3),
    "dinov31": (JD31.DINOv31, JD31.DINOv31Args, D31.DINOv31, D31.DINOv31Args,
                {**MULTI_CROP, "paka_hidden_dim": 32,
                 "paka_bottleneck_dim": 16}, 5e-3),
    "simclr": (JSC.SimCLR, JSC.SimCLRArgs, SC.SimCLR, SC.SimCLRArgs,
               TWO_VIEWS, 20.0),
    "densecl": (JDC.DenseCL, JDC.DenseCLArgs, DC.DenseCL, DC.DenseCLArgs,
                {**TWO_VIEWS, "queue_size": 16}, 2.0),
    "detconb": (JDT.DetConB, JDT.DetConBArgs, DT.DetConB, DT.DetConBArgs,
                TWO_VIEWS, 20.0),
    "detcons": (JDT.DetConS, JDT.DetConBArgs, DT.DetConS, DT.DetConBArgs,
                TWO_VIEWS, 20.0),
    # Dataset region ids (any count in this mode; ids past num_masks - 1
    # clip to it, and some regions are absent from some crops).
    "detconb_masks": (JDT.DetConB, JDT.DetConBArgs, DT.DetConB,
                      DT.DetConBArgs, {**TWO_VIEWS, "num_masks": 5,
                                       "use_dataset_masks": True}, 20.0),
}
# The key projection's bias has an exactly zero gradient (a shift shared by
# all keys leaves the softmax as it is), so what each package computes for
# it is rounding noise, which Adam and LARS scale up to a full step.
DEGENERATE = "attn.k.bias"


@pytest.fixture(autouse=True)
def _ieee_fp32():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = tf32


def checkpoint_scale(tree, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        if name == "kernel":
            return rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        if name in ("scale", "g"):
            return 1.0 + 0.2 * rng.standard_normal(x.shape)
        if name == "gamma":
            return 0.5 + 0.2 * rng.standard_normal(x.shape)
        if name == "v":
            return 0.3 * rng.standard_normal(x.shape)
        return 0.5 * rng.standard_normal(x.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(leaf(p, x), jnp.float32), tree)


def _jax_setup(name):
    j_cls, j_args_cls, _, _, args, _ = CASES[name]
    method = j_cls(jax_get_wrapped_model(STUDENT), j_args_cls(**args))
    params, model_state, method_state = method.init(
        jax.random.key(0), jnp.zeros((2, SIZE, SIZE, 3), jnp.float32))
    params = checkpoint_scale(params, 0)
    if "teacher" in method_state:
        # The teacher drawn apart from the student.
        method_state = {**method_state, "teacher": checkpoint_scale(
            method_state["teacher"], 1)}
    return method, params, model_state, method_state


def _port_setup(name, j_params, j_method_state, fused):
    _, _, cls, args_cls, args, lr = CASES[name]
    method = cls(get_wrapped_model(STUDENT), args_cls(**args))
    params, method_state = method.init(torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    carried = method_state_from_jax(jax.device_get(j_method_state))
    if "teacher" in carried:
        method_state["teacher"].load_state_dict(carried["teacher"])
    method_state.update({k: v for k, v in carried.items() if k != "teacher"})
    named = dict(params.named_parameters())
    build = build_fused_updater if fused else build_update
    updater = build(method, method.default_optimizer_args(),
                    cosine_warmup(lr, TOTAL, 2), named, TOTAL)
    assert updater is not None
    return method, TrainState(0, params, method_state, updater)


def _geometry(rng, src=128.0, clean=False):
    """(B, 5) crop boxes [y0, x0, h, w, hflipped] inside a src^2 image;
    ``clean``: large boxes, never flipped (DINOv31's clean view)."""
    lo = 0.6 if clean else 0.3
    h = rng.uniform(lo, 1.0, B) * src
    w = rng.uniform(lo, 1.0, B) * src
    y0 = rng.uniform(0, 1, B) * (src - h)
    x0 = rng.uniform(0, 1, B) * (src - w)
    flip = np.zeros(B) if clean else (rng.uniform(0, 1, B) < 0.5)
    return np.stack([y0, x0, h, w, flip], axis=1).astype(np.float32)


def _views(name, step):
    rng = np.random.default_rng(100 + step)

    def image(size):
        return rng.standard_normal((B, size, size, 3)).astype(np.float32)

    if name in ("dino", "dinov31"):
        views = [image(SIZE), image(SIZE)]
        if name == "dinov31":
            views.append(image(SIZE))  # the clean view
        views += [image(LOCAL), image(LOCAL)]
        if name == "dinov31":
            views += [_geometry(rng), _geometry(rng),
                      _geometry(rng, clean=True), _geometry(rng),
                      _geometry(rng)]
        return views
    views = [image(SIZE), image(SIZE)]
    if name == "detconb_masks":
        # Blocks of region ids 0-6 at the crop resolution.
        for _ in range(2):
            blocks = rng.integers(0, 7, (B, 4, 4))
            views.append(np.repeat(np.repeat(blocks, 28, 1), 28, 2)
                         .astype(np.int32))
    return views


def _jax_match(j_method, params, method_state, views):
    """DenseCL's dense match as the JAX loss forms it, and each row's
    top-2 margin of the correlation."""
    _, _, f_s, _ = j_method._encode(params, {}, jnp.asarray(views[0]), True,
                                    jax.random.key(0))
    _, _, f_t, _ = j_method._encode(method_state["teacher"], {},
                                    jnp.asarray(views[1]), False,
                                    jax.random.key(0))
    corr = np.asarray(jnp.einsum("bnd,bmd->bnm", JL.l2_normalize(f_s),
                                 JL.l2_normalize(f_t)))
    top2 = np.sort(corr, axis=-1)[..., -2:]
    return corr.argmax(-1), top2[..., 1] - top2[..., 0]


def _assert_tree_close(state_dict, jax_tree, what):
    ref = params_from_jax(jax.device_get(jax_tree))
    assert set(ref) == set(state_dict), what
    for name, r in ref.items():
        if name.endswith(DEGENERATE):
            continue
        np.testing.assert_allclose(state_dict[name].detach().numpy(),
                                   r.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")


def _assert_state_close(port_state, j_state, step):
    carried = method_state_from_jax(jax.device_get(j_state))
    assert set(carried) == set(port_state), step
    for key, ref in carried.items():
        got = port_state[key]
        if key == "teacher":
            _assert_tree_close(dict(got.named_parameters()), j_state[key],
                               f"step {step} teacher")
        elif isinstance(ref, int):
            assert got == ref, (step, key)
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {step} {key}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_steps_match_jax(name):
    j_method, j_params, j_model_state, j_ms = _jax_setup(name)
    fused = name in ("dino", "dinov31")
    method, state = _port_setup(name, j_params, j_ms, fused)
    start = {k: v.detach().clone()
             for k, v in state.params.state_dict().items()}
    lr = CASES[name][5]
    j_args = j_method.default_optimizer_args()
    assert type(j_args).__name__ == type(
        method.default_optimizer_args()).__name__
    j_lr = jax_cw(lr, TOTAL, 2)
    j_opt = build_optimizer(
        j_args, j_lr, j_params, grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params))
    j_opt_state = j_opt.init(j_params)
    j_fused = (jbfu(j_method, j_args, j_lr, j_params, TOTAL, mode="jnp")
               if fused else None)
    step_fn = make_train_step(method, TOTAL)

    @jax.jit
    def j_grad(p, method_state, views, rng, step):
        return jax.value_and_grad(
            lambda p: j_method.loss_fn(p, j_model_state, method_state, views,
                                       rng, step, TOTAL),
            has_aux=True)(p)

    skipped = 0
    for step in range(3):
        views = _views(name, step)
        rng = jax.random.key(1000 + step)
        pinned = None
        if name == "dinov31":
            mask, _ = random_block_masks(jax.random.split(rng, 3)[0], 2 * B,
                                         (GRID, GRID), 0.5, (0.1, 0.5))
            pinned = torch.tensor(np.asarray(mask))
        if name == "densecl":
            match, margin = _jax_match(j_method, j_params, j_ms, views)
            with torch.no_grad():
                _, _, f_s = method.encode(state.params,
                                          torch.tensor(views[0]), True)
                _, _, f_t = method.encode(state.method_state["teacher"],
                                          torch.tensor(views[1]), False)
                got = DC.dense_match(f_s, f_t).numpy()
            clear = margin > 1e-5
            skipped += int((~clear).sum())
            np.testing.assert_array_equal(got[clear], match[clear])
            pinned = torch.tensor(match)
        (j_loss, (_, j_ms, _)), grads = j_grad(
            j_params, j_ms, [jnp.asarray(v) for v in views], rng,
            jnp.asarray(step))
        if fused:
            j_params, teacher, j_opt_state, _ = j_fused.update_and_apply(
                grads, j_opt_state, j_params, j_ms["teacher"],
                jnp.asarray(step))
            j_ms = {**j_ms, "teacher": teacher}
        else:
            updates, j_opt_state = j_opt.update(grads, j_opt_state, j_params)
            updates = j_method.mask_updates(updates, step)
            j_params = optax.apply_updates(j_params, updates)
            j_ms = j_method.post_update(j_params, j_ms, step, TOTAL)

        metrics = step_fn(state, None, None,
                          views=[[torch.tensor(v) for v in views]],
                          masks=None if pinned is None else [pinned])
        np.testing.assert_allclose(float(metrics["train_loss"]),
                                   float(j_loss), rtol=1e-4)
        _assert_tree_close(dict(state.params.named_parameters()), j_params,
                           f"step {step} params")
        _assert_state_close(state.method_state, j_ms, step)
    assert state.step == 3
    if name == "densecl":
        print(f"DenseCL match: {skipped} of {3 * B * GRID * GRID} rows "
              "within 1e-5 of a tie, not compared")
        # Steps 1 and 2 ran against the queue (4 and 8 of 16 rows filled).
        assert state.method_state["queue_filled"] == 12
    # The steps moved the weights well beyond the tolerance.
    moved = max((v - start[k]).abs().max().item()
                for k, v in state.params.state_dict().items())
    assert moved > 1e-3, moved


@pytest.mark.parametrize("b,d,temp", [(4, 16, 0.5), (7, 3, 0.1)])
def test_ntxent_loss_matches_jax(b, d, temp):
    rng = np.random.default_rng(b)
    z0, z1 = (rng.standard_normal((b, d)).astype(np.float32)
              for _ in range(2))
    ref = JL.ntxent_loss(jnp.asarray(z0), jnp.asarray(z1), temp)
    t0, t1 = torch.tensor(z0, requires_grad=True), torch.tensor(z1)
    got = L.ntxent_loss(t0, t1, temp)
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    got.backward()
    ref_grad = jax.grad(lambda z: JL.ntxent_loss(z, jnp.asarray(z1), temp))(
        jnp.asarray(z0))
    np.testing.assert_allclose(t0.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw,m", [((8, 8), 16), ((7, 5), 4), ((16, 16), 9)])
def test_grid_masks_match_jax(hw, m):
    np.testing.assert_array_equal(DT.grid_masks(hw, m).numpy(),
                                  np.asarray(JDT._grid_masks(hw, m)))


def test_grid_masks_need_a_square_count():
    for fn in (DT.grid_masks, JDT._grid_masks):
        with pytest.raises(ValueError, match="perfect square"):
            fn((8, 8), 5)


def _paka_inputs(seed, gs=(6, 5), gt=(7, 7)):
    rng = np.random.default_rng(seed)
    y0, x0 = rng.uniform(-3, 4, (2, 6)).astype(np.float32)
    hh, ww = rng.uniform(2, 9, (2, 6)).astype(np.float32)
    flip = (rng.uniform(0, 1, 6) < 0.5).astype(np.float32)
    return (y0, x0, hh, ww, flip), gs, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_paka_overlap_validity_matches_jax(seed):
    arrays, gs, gt = _paka_inputs(seed)
    ref = np.asarray(JD31.paka_overlap_validity(
        *(jnp.asarray(a) for a in arrays), gs, gt))
    got = D31.paka_overlap_validity(*(torch.tensor(a) for a in arrays), gs,
                                    gt).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < ref.size  # some patches in, some out


def test_paka_loss_matches_jax():
    """The CE of the JAX ``_paka_loss`` on given patch embeddings and
    validity, value and gradient (the embeddings' head and resampling are
    held in ``test_three_steps_match_jax``)."""
    rng = np.random.default_rng(3)
    zs = rng.standard_normal((3, 12, 8)).astype(np.float32)
    zt = rng.standard_normal((3, 12, 8)).astype(np.float32)
    valid = rng.uniform(0, 1, (3, 12)) < 0.7
    valid[2] = False  # an image with no overlap contributes nothing

    def j_loss(zs):
        zs_n, zt_n = JL.l2_normalize(zs), JL.l2_normalize(jnp.asarray(zt))
        ks = jnp.einsum("bnd,bmd->bnm", zs_n, zs_n) / 0.25
        kt = jnp.einsum("bnd,bmd->bnm", zt_n, zt_n) / 0.25
        v = jnp.asarray(valid)
        w = v[:, :, None] & v[:, None, :]
        neg = -1e9 * (1.0 - w.astype(jnp.float32))
        ce = -jnp.sum(jax.nn.softmax(kt + neg, -1)
                      * jax.nn.log_softmax(ks + neg, -1) * w, -1)
        rv = v.astype(jnp.float32)
        return jnp.sum(ce * rv) / jnp.maximum(jnp.sum(rv), 1.0)

    t = torch.tensor(zs, requires_grad=True)
    got = D31.paka_loss(L.l2_normalize(t), L.l2_normalize(torch.tensor(zt)),
                        torch.tensor(valid), 0.25)
    got.backward()
    np.testing.assert_allclose(got.item(), float(j_loss(jnp.asarray(zs))),
                               rtol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(
        jax.grad(j_loss)(jnp.asarray(zs))), rtol=1e-4, atol=1e-6)


def test_densecl_match_matches_jax():
    """The argmax correspondence on random features, compared where the
    top-2 margin is above 1e-5."""
    rng = np.random.default_rng(5)
    f_s = rng.standard_normal((2, 30, 8)).astype(np.float32)
    f_t = rng.standard_normal((2, 30, 8)).astype(np.float32)
    corr = np.asarray(jnp.einsum("bnd,bmd->bnm",
                                 JL.l2_normalize(jnp.asarray(f_s)),
                                 JL.l2_normalize(jnp.asarray(f_t))))
    top2 = np.sort(corr, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-5
    got = DC.dense_match(torch.tensor(f_s), torch.tensor(f_t)).numpy()
    np.testing.assert_array_equal(got[clear], corr.argmax(-1)[clear])
    assert clear.mean() > 0.9


def test_list_methods_matches_jax():
    assert lt.list_methods() == JMH.list_methods()
    assert MH.list_methods() == JMH.list_methods()


@pytest.mark.parametrize("name", sorted(set(JMH._METHODS) | {"distillation"}))
def test_get_method_cls_resolves_every_jax_name(name):
    cls, args_cls = MH.get_method_cls(name)
    j_cls, j_args_cls = JMH.get_method_cls(name)
    assert (cls.__name__, args_cls.__name__) == (j_cls.__name__,
                                                 j_args_cls.__name__)
    assert cls.name == j_cls.name
    assert cls.default_steps == j_cls.default_steps
    assert cls.default_batch_size == j_cls.default_batch_size


def test_unknown_method_error_matches_jax():
    with pytest.raises(JaxUnknownMethod) as j_err:
        JMH.get_method_cls("dinov4")
    with pytest.raises(UnknownMethodError) as err:
        MH.get_method_cls("dinov4")
    assert str(err.value) == str(j_err.value)
    assert "Options: [" in str(err.value)


def test_port_messages_name_no_item_9():
    """The methods are ported: no message of the port names ROADMAP item
    9 any more."""
    from pathlib import Path

    root = Path(lt.__file__).resolve().parent
    for path in sorted(root.rglob("*.py")):
        text = path.read_text()
        for needle in ("item 9)", "item 9.", "item 9 ", "item 9\"",
                       "item 9'", "item 9,"):
            assert needle not in text, f"{path} names ROADMAP item 9"
