"""Head dim 128 (the 7B ViTs: width 4096, 32 heads) in the port, against the
JAX package on the CPU.

- the plain forward and backward at hd 128 (what the card's hd-128 forward
  is held to, and the backward's oracle) against the JAX Pallas kernels in
  interpret mode and their custom VJP;
- the routes: both directions take hd 128, and ``pretrain`` refuses a
  model only where its fp32 training state exceeds the card
  (``refuse_pretraining``, counted on the meta device at 80 GiB);
- narrow ViTs of both 7B flavours (width 256, 2 heads, depth 2) against the
  JAX ViT in fp32 and bf16, their weights carried by ``params_from_jax``;
- the full 7B parameter trees, built on the meta device against
  ``jax.eval_shape`` of the JAX init (nothing of 7B size is allocated);
- a distillation step whose frozen teacher is the narrow DINOv3 hd-128 ViT,
  and one whose student is a narrow hd-128 ViT of either flavour, every
  block recomputed, with LARS at momentum 0 (the 7B student's path);
- the leaf-by-leaf teacher init: the values of an init on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_distillation import B, LR, Q, SIZE, TOTAL, jax_mixup_draw
from test_torch_distillation import _assert_close as assert_params_close
from test_torch_distillation import checkpoint_scale as distill_scale
from test_torch_vit import checkpoint_scale

from lightly_train_tpu._optim import build_optimizer
from lightly_train_tpu._optim.optimizers import LARSArgs as JaxLARSArgs
from lightly_train_tpu._optim import cosine_warmup as jax_cw
from lightly_train_tpu.methods import distillationv3 as JV3
from lightly_train_tpu.models import vit as JV
from lightly_train_tpu.models import wrapper as JW
from lightly_train_tpu.models.package_registry import (
    get_wrapped_model as jax_get_wrapped_model,
)
from lightly_train_tpu.ops import pallas as jax_pallas
from lightly_train_tpu.ops.pallas.attention import (
    flat_attention as jax_flat_attention,
)
from lightly_train_tpu_torch._commands.train_loop import make_train_step
from lightly_train_tpu_torch._optim import AdamWArgs, LARSArgs, cosine_warmup
from lightly_train_tpu_torch._optim.update import build_update
from lightly_train_tpu_torch.methods import distillationv3 as V3
from lightly_train_tpu_torch.methods.base import TrainState
from lightly_train_tpu_torch.models import from_jax
from lightly_train_tpu_torch.models import vit as TV
from lightly_train_tpu_torch.models import wrapper as TW
from lightly_train_tpu_torch.models.from_jax import (
    method_state_from_jax,
    params_from_jax,
)
from lightly_train_tpu_torch.methods.method_helpers import get_method_cls
from lightly_train_tpu_torch.models.package_registry import (
    HEADROOM,
    get_wrapped_model,
    refuse_pretraining,
)
from lightly_train_tpu_torch.ops.kernels import attention as A
from torch_fixtures.threads import one_torch_thread  # noqa: F401

HD, H = 128, 2
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# The 7B/16 teacher at 224^2 (196 patches, CLS, 4 registers), the 7B/14 at
# 224^2 (256 patches, CLS), a local view's count, and the edges of the
# bf16 backward's kernels: one token, one whole tile, one row past it.
TOKENS = (1, 37, 64, 65, 201, 257)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", TOKENS)
def test_flat_plain_matches_pallas_interpret_hd128(N, dtype):
    """K1/K2's plain versions (the flat forward, and the backward through
    autograd) against the JAX ``flat_attention`` in interpret mode and its
    ``jax.vjp`` at (2, N, 2, 128). Both round p (and ds) to bf16 at the
    same places and take the fp32 sums in other orders, so a value near a
    bf16 rounding boundary can round the other way: within 1e-2 (forward)
    and 2e-2 (gradients), a few bf16 ulps, as at hd 64 and 16."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, co = _inputs((2, N, H * HD), N)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_flat_attention(a, b, c, H, interpret=True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(co, jdt))
    qt, kt, vt = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    out_t = A.flat_attention(qt, kt, vt, H)
    out_t.backward(torch.tensor(co).to(tdt))
    assert out_t.dtype == tdt
    np.testing.assert_allclose(out_t.detach().float().numpy(),
                               np.asarray(out_j, np.float32), rtol=1e-2,
                               atol=1e-2)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_j):
        assert got.dtype == tdt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", TOKENS)
def test_vmem_plain_matches_pallas_interpret_hd128(N, dtype):
    """K4/K5's plain versions through the (B, N, H, hd) API
    (``vmem_attention_fwd_plain`` and ``vmem_attention_bwd_plain`` under
    autograd) against the JAX ``vmem_attention`` in interpret mode and its
    custom VJP at (2, N, 2, 128), with the tolerances above."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, co = _inputs((2, N, H, HD), N + 1)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_pallas.vmem_attention(a, b, c, interpret=True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(co, jdt))
    qt, kt, vt = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    out_t = A.vmem_attention(qt, kt, vt)
    out_t.backward(torch.tensor(co).to(tdt))
    np.testing.assert_allclose(out_t.detach().float().numpy(),
                               np.asarray(out_j, np.float32), rtol=1e-2,
                               atol=1e-2)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=2e-2,
                                   atol=2e-2)


def test_lse_at_hd128_matches_pallas():
    """lse (fp32 throughout, from the same bf16-rounded p) at the teacher's
    N."""
    from lightly_train_tpu.ops.pallas.attention import _flat_fwd_impl

    q, k, v, _ = _inputs((2, 201, H * HD), 3)
    _, lse_j = _flat_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              H, HD ** -0.5, True)
    _, lse_t = A.flat_attention_fwd_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), H, HD ** -0.5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# The routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hd128_routes_both_directions(dtype):
    """hd 128 runs each dtype's forward and backward libraries, as hd 64
    does: nothing is forward-only."""
    assert A.HEAD_DIMS["fwd"] == A.HEAD_DIMS["bwd"] == (16, 64, 128)
    for direction in ("fwd", "bwd"):
        library = getattr(A, f"{direction}_library")
        assert library(dtype, 128) == library(dtype, 64)
        assert A.kernel_supports(201, 128, direction)
        assert not A.kernel_supports(769, 128, direction)
    with pytest.raises(ValueError, match="head dim"):
        A.bwd_library(dtype, 96)


# (model, method, optimizer args, refused at 80 GiB, frozen teacher): the
# fp32 state is the parameters, the gradients, the optimizer's moments, an
# EMA teacher, and a distillation teacher once at its own size; with
# HEADROOM beside it, it must fit the card. The H100 80GB's own capacity,
# 79.18 GiB, where a case names it (CAPACITY).
GIB80 = 80 * 2 ** 30
H100_80GB = 85_017_493_504
REFUSALS = {
    # 5 copies of 6.72 B parameters: 134.3 GB (125.1 GiB).
    "dinov2_7b": ("dinov3/vit7b16", "dinov2", AdamWArgs(), True, None),
    # DINO's EMA teacher with AdamW: 5 copies, as DINOv2.
    "dino_adamw_7b": ("dinov3/vit7b16", "dino", AdamWArgs(), True, None),
    # SimCLR (no teacher) with LARS at momentum 0: p and g, 53.7 GB.
    "simclr_lars_momentum0_7b": ("dinov3/vit7b16", "simclr",
                                 LARSArgs(momentum=0.0), False, None),
    # 4 copies and the ViT-B/16 teacher: 107.8 GB (100.4 GiB).
    "distillation_adamw_7b": ("dinov3/vit7b16", "distillationv3",
                              AdamWArgs(), True, "dinov3/vitb16"),
    # p, g, the trace and the ViT-B/16 teacher: 81.0 GB (75.4 GiB), with
    # the 4 GiB headroom under 80 GiB;
    "distillation_lars_7b": ("dinov3/vit7b16", "distillationv3",
                             LARSArgs(), False, "dinov3/vitb16"),
    # but not under the H100's 79.18 GiB, of which the run ran out on the
    # card (74.8 GiB allocated, 3.5 reserved unused): refused, with
    # adamw8bit offered (63.1 GiB, which ran).
    "distillation_lars_7b_h100": ("dinov3/vit7b16", "distillationv3",
                                  LARSArgs(), True, "dinov3/vitb16"),
    # The same from a 7B teacher: 4 copies, 107.5 GB (100.1 GiB).
    "distillation_lars_7b_teacher_7b": ("dinov3/vit7b16", "distillationv3",
                                        LARSArgs(), True, "dinov3/vit7b16"),
    # p, g and the ViT-B/16 teacher: 54.1 GB, the path chip_smoke.py's
    # phase 3l runs.
    "distillation_lars_momentum0_7b": ("dinov3/vit7b16", "distillationv3",
                                       LARSArgs(momentum=0.0), False,
                                       "dinov3/vitb16"),
    "dinov2_vitb": ("dinov2/vitb14", "dinov2", AdamWArgs(), False, None),
}
CAPACITY = {"distillation_lars_7b_h100": H100_80GB}


def _meta_params(model):
    with torch.device("meta"):
        return sum(p.numel()
                   for p in get_wrapped_model(model).module.parameters())


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refuse_pretraining_counts_the_training_state(case):
    """``refuse_pretraining`` on the meta device at 80 GiB, with 4 GiB of
    headroom beside the state: DINOv2 and DINO (AdamW and an EMA teacher),
    AdamW with a 7B student and a 7B student from a 7B teacher are
    refused, naming the byte count, the headroom and FSDP (item 7.6), and
    offering adamw8bit (two int8 bytes a parameter and two fp32 scales a
    block of 256) only where the run would fit with it: the 7B student
    from a ViT-B teacher; distillation with LARS from a ViT-B teacher is
    not refused at 80 GiB, with or without momentum, nor SimCLR at
    momentum 0; at the H100 80GB's 79.18 GiB, LARS with momentum is
    (the card ran out of memory there); ViT-B never is. Without a
    capacity (the CPU) nothing is refused. The message says what it
    counted and nothing more."""
    model, method, optim_args, refused, teacher = REFUSALS[case]
    capacity = CAPACITY.get(case, GIB80)
    ema = get_method_cls(method)[0].ema_teacher
    n = _meta_params(model)
    moments = 2 if isinstance(optim_args, AdamWArgs) else int(
        optim_args.momentum > 0)
    n_teacher = 0 if teacher is None else _meta_params(teacher)
    need = 4 * (n * (2 + moments + int(ema)) + n_teacher)
    assert (need + HEADROOM > capacity) == refused
    with torch.device("meta"):
        leaves = [p.numel() for p in
                  get_wrapped_model(model).module.parameters()]
    need8 = (4 * (n * (2 + int(ema)) + n_teacher)
             + sum(2 * 260 * -(-k // 256) for k in leaves))
    refuse_pretraining(model, optim_args, ema, None, teacher)
    if not refused:
        refuse_pretraining(model, optim_args, ema, capacity, teacher)
        return
    with pytest.raises(NotImplementedError) as err:
        refuse_pretraining(model, optim_args, ema, capacity, teacher)
    said = str(err.value)
    for part in (str(need), "ROADMAP item 7.6", f"{n / 1e9:.2f} B",
                 "4.0 GiB for activations"):
        assert part in said
    assert ("adamw8bit" in said) == (need8 + HEADROOM <= capacity)
    assert "ROADMAP item 10" not in said
    if teacher is not None:
        assert f"frozen teacher '{teacher}'" in said
    assert "momentum 0" not in said


@pytest.mark.parametrize("method,teacher", [
    ("distillationv3", "dinov3/vitb16"), ("distillationv1", "dinov3/vits16"),
    ("dinov2", None), ("dino", None), ("simclr", None)])
def test_pretrain_counts_the_distillation_teacher(monkeypatch, tmp_path,
                                                  method, teacher):
    """``pretrain`` hands ``refuse_pretraining`` the frozen teacher of a
    distillation method (its ``teacher`` argument, else the default) and
    each method's EMA-teacher flag."""
    from lightly_train_tpu_torch._commands import train as T

    seen = []

    def refuse(*args):
        seen.append(args)
        raise RuntimeError("counted")

    monkeypatch.setattr(T, "refuse_pretraining", refuse)
    args = {} if teacher in (None, "dinov3/vitb16") else {"teacher": teacher}
    with pytest.raises(RuntimeError, match="counted"):
        T.pretrain(out=str(tmp_path), model="dinov2/vittest14",
                   method=method, method_args=args, accelerator="cpu")
    (_, _, ema, capacity, got_teacher), = seen
    assert got_teacher == teacher and capacity is None
    assert ema == (method in ("dinov2", "dino"))


def test_cpu_attention_at_hd128_keeps_its_plain_backward():
    """On the CPU the plain versions stand in for the kernels in both
    directions, so autograd through hd-128 attention works there."""
    q, k, v = (torch.randn((1, 9, H * HD), requires_grad=True)
               for _ in range(3))
    A.flat_attention(q, k, v, H).sum().backward()
    assert all(torch.isfinite(x.grad).all() for x in (q, k, v))


# ---------------------------------------------------------------------------
# The ViTs at hd 128
# ---------------------------------------------------------------------------

# (flavour, patch): DINOv2's plain MLP, and DINOv3's SwiGLU of ratio 3.0 and
# align 64 without q/k/v bias, with the masked k bias, 4 registers and RoPE.
FLAVOURS = [("dinov2", 14), ("dinov3", 16)]


def _narrow(pkg, flavour, patch, **kw):
    """The 7B flavour's config at width 256, 2 heads (hd 128), depth 2."""
    cfg = pkg.vit_config("vit7b", patch, flavor=flavour, **kw)
    return dataclasses.replace(cfg, embed_dim=256, num_heads=2, depth=2)


def _narrow_pair(flavour, patch, seed=0, dtype="fp32"):
    jdt, tdt = DTYPES[dtype]
    cfg_j = _narrow(JV, flavour, patch, dtype=jdt)
    cfg_t = _narrow(TV, flavour, patch, dtype=tdt)
    wrapped_j = JW.WrappedModel(f"{flavour}/hd128", JV.VisionTransformer(cfg_j),
                                256, patch)
    wrapped_t = TW.WrappedModel(f"{flavour}/hd128", TV.VisionTransformer(cfg_t),
                                256, patch)
    variables = wrapped_j.init(jax.random.key(seed),
                               jnp.zeros((1, 224, 224, 3)))
    params = checkpoint_scale(jax.device_get(variables["params"]), seed)
    wrapped_t.module.load_state_dict(params_from_jax(params))
    return wrapped_j, params, wrapped_t


def test_narrow_configs_keep_the_7b_flavours():
    dinov2, dinov3 = (_narrow(TV, f, p) for f, p in FLAVOURS)
    assert dinov2.embed_dim // dinov2.num_heads == HD
    assert not dinov2.use_swiglu and dinov2.qkv_bias and dinov2.use_pos_embed
    assert (dinov3.mlp_ratio, dinov3.use_swiglu, dinov3.swiglu_align) == (
        3.0, True, 64)
    assert (dinov3.qkv_bias, dinov3.mask_k_bias, dinov3.num_register_tokens,
            dinov3.use_rope) == (False, True, 4, True)
    block = TV.VisionTransformer(dinov3).blocks[0]
    assert block.attn.q.bias is None and block.attn.k.bias is None
    assert block.mlp.w1.weight.shape == (512, 256)  # 2/3 of 768, align 64


@pytest.mark.parametrize("flavour,patch", FLAVOURS)
def test_narrow_hd128_vit_matches_jax_fp32(flavour, patch):
    """fp32 at batch 2 and 224^2 (N = 257 and 201, the 7B models' token
    counts) on checkpoint-scale weights: within 1e-4, as the other ViT
    sizes are held (``test_torch_vit.py``)."""
    wrapped_j, params, wrapped_t = _narrow_pair(flavour, patch)
    images = np.random.default_rng(5).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    out_j = jax.jit(lambda p, x: wrapped_j.forward_features(
        {"params": p}, x))(params, jnp.asarray(images))
    with torch.no_grad():
        out_t = wrapped_t.forward_features(torch.tensor(images), None)
    for key in ("cls_token", "patch_tokens", "register_tokens"):
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("flavour,patch", FLAVOURS)
def test_narrow_hd128_vit_matches_jax_bf16(flavour, patch):
    """bf16 compute against fp32 parameters in both packages: the two round
    in different orders, held as the bf16 vittest cases are, to 2e-2
    relative L2 and 2^-5 of the largest magnitude (eight bf16 ulps)."""
    _, params, _ = _narrow_pair(flavour, patch)
    wrapped_j, _, wrapped_t = _narrow_pair(flavour, patch, dtype="bf16")
    wrapped_t.module.load_state_dict(params_from_jax(params))
    images = np.random.default_rng(6).standard_normal(
        (2, 224, 224, 3)).astype(np.float32)
    out_j = wrapped_j.forward_features({"params": params},
                                       jnp.asarray(images))
    with torch.no_grad():
        out_t = wrapped_t.forward_features(torch.tensor(images), None)
    for key in ("cls_token", "patch_tokens"):
        assert out_t[key].dtype == torch.bfloat16
        got = out_t[key].float().numpy()
        ref = np.asarray(out_j[key].astype(jnp.float32))
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel < 2e-2, (key, rel)
        assert np.abs(got - ref).max() <= 2 ** -5 * np.abs(ref).max(), key


@pytest.mark.parametrize("model,count", [("dinov2/vit7b14", 8_058_998_784),
                                         ("dinov3/vit7b16", 6_716_035_072)])
def test_7b_trees_match_jax(model, count):
    """The registered 7B models: the JAX init's tree at 224^2
    (``jax.eval_shape``), mapped by ``params_from_jax``'s leaf conversion
    onto zero-stride views (no value is allocated), has the names and
    shapes of the port's module built on the meta device, and both count
    ``count`` parameters."""
    wrapped_j = jax_get_wrapped_model(model)
    shapes = jax.eval_shape(lambda: wrapped_j.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))["params"]
    views = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    mapped = dict(from_jax._convert_leaf(name, value)
                  for name, value in from_jax._flatten(views).items())
    with torch.device("meta"):
        module = get_wrapped_model(model).module
    ours = {name: tuple(p.shape) for name, p in module.named_parameters()}
    assert {name: tuple(v.shape) for name, v in mapped.items()} == ours
    assert sum(int(np.prod(s)) for s in ours.values()) == count
    assert sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes)) == count
    # The 7B/16's SwiGLU (hidden 8192) and its q/k/v without bias.
    if model == "dinov3/vit7b16":
        assert ours["blocks.0.mlp.w1.weight"] == (8192, 4096)
        assert not any(name.startswith("blocks.0.attn.") and
                       name.endswith(("q.bias", "k.bias", "v.bias"))
                       for name in ours)


# ---------------------------------------------------------------------------
# A distillation step from an hd-128 teacher
# ---------------------------------------------------------------------------

STUDENT, TEACHER = "dinov2/vittest14", "dinov3/hd128"


def _teacher_pair():
    cfg_j = _narrow(JV, "dinov3", 16)
    cfg_t = _narrow(TV, "dinov3", 16)
    return (JW.WrappedModel(TEACHER, JV.VisionTransformer(cfg_j), 256, 16),
            TW.WrappedModel(TEACHER, TV.VisionTransformer(cfg_t), 256, 16))


def _jax_distill_init(j_method):
    """The JAX method's (params, model_state, method_state) from the
    shapes of its init (``jax.eval_shape``: no init runs), with the values
    the init's would be replaced by: the student and heads, and the
    teacher, drawn at checkpoint scale (seeds 0 and 1); the queue and its
    counters at the init's zeros."""
    params, model_state, ms = jax.eval_shape(
        j_method.init, jax.random.key(0),
        jnp.zeros((2, SIZE, SIZE, 3), jnp.float32))
    zeros = functools.partial(jax.tree_util.tree_map,
                              lambda x: jnp.zeros(x.shape, x.dtype))
    ms = {**{k: zeros(v) for k, v in ms.items() if k != "teacher"},
          "teacher": {"params": distill_scale(ms["teacher"]["params"], 1)}}
    return distill_scale(params, 0), zeros(model_state), ms


def _jax_distill_step(j_method, j_opt, params, model_state, ms, view, rng):
    """One JAX distillation step at state step 0, compiled as one program
    (the loss, its gradient and the masked update): (loss, params, method
    state)."""
    @jax.jit
    def step(p, opt_state, ms, view):
        (loss, (_, ms, _)), grads = jax.value_and_grad(
            lambda p: j_method.loss_fn(p, model_state, ms, [view], rng,
                                       jnp.asarray(0), TOTAL),
            has_aux=True)(p)
        updates, _ = j_opt.update(grads, opt_state, p)
        p = optax.apply_updates(p, j_method.mask_updates(updates, 0))
        return loss, p, ms

    return step(params, jax.jit(j_opt.init)(params), ms, jnp.asarray(view))


def test_distillation_step_from_an_hd128_teacher_matches_jax(monkeypatch):
    """One distillation v3 step (LARS) of a vittest14 student from the
    frozen narrow DINOv3 hd-128 teacher at 112^2 (N = 54 with the
    registers), batch 4, queue 16, fp32, held to the JAX step as
    ``test_torch_distillation.py`` holds the default teacher's: the loss
    within 1e-4 relative, the student and heads within 1e-4 / 1e-5, the
    queue likewise. The JAX method takes the teacher as
    ``teacher_wrapped``; the port's takes it from its registry lookup."""
    teacher_j, teacher_t = _teacher_pair()
    args = dict(teacher=TEACHER, image_size=SIZE, queue_size=Q)
    j_method = JV3.DistillationV3(jax_get_wrapped_model(STUDENT),
                                  JV3.DistillationV3Args(**args),
                                  teacher_wrapped=teacher_j)
    j_params, j_model_state, j_ms = _jax_distill_init(j_method)

    monkeypatch.setattr(V3, "get_wrapped_model", lambda name: (
        teacher_t if name == TEACHER else get_wrapped_model(name)))
    method = V3.DistillationV3(get_wrapped_model(STUDENT),
                               V3.DistillationV3Args(**args))
    params, method_state = method.init(torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    carried = method_state_from_jax(jax.device_get(j_ms))
    method_state["teacher"].load_state_dict(carried["teacher"])
    method_state.update({k: v for k, v in carried.items() if k != "teacher"})
    assert method_state["teacher"].cfg.embed_dim // 2 == HD
    lr = LR["distillationv3"]
    updater = build_update(method, method.default_optimizer_args(),
                           cosine_warmup(lr, TOTAL, 2),
                           dict(params.named_parameters()), TOTAL)
    state = TrainState(0, params, method_state, updater)

    j_opt = build_optimizer(
        j_method.default_optimizer_args(), jax_cw(lr, TOTAL, 2), j_params,
        grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params))
    view = np.random.default_rng(100).standard_normal(
        (B, SIZE, SIZE, 3)).astype(np.float32)
    rng = jax.random.key(1000)
    j_loss, j_params, j_ms = _jax_distill_step(
        j_method, j_opt, j_params, j_model_state, j_ms, view, rng)

    lam, apply = jax_mixup_draw(rng, method.args.mixup_prob)
    masks = [(torch.tensor(np.asarray(lam)), torch.tensor(np.asarray(apply)))]
    metrics = make_train_step(method, TOTAL)(
        state, None, None, views=[[torch.tensor(view)]], masks=masks)
    np.testing.assert_allclose(float(metrics["train_loss"]), float(j_loss),
                               rtol=1e-4)
    assert_params_close(dict(state.params.named_parameters()), j_params,
                        "step 0 params")
    np.testing.assert_allclose(state.method_state["queue"].numpy(),
                               np.asarray(j_ms["queue"]), rtol=1e-4,
                               atol=1e-5)
    assert not any(p.requires_grad
                   for p in state.method_state["teacher"].parameters())


@pytest.mark.parametrize("flavour,patch", FLAVOURS)
def test_distillation_step_of_an_hd128_student_matches_jax(flavour, patch):
    """One distillation v3 step of a narrow hd-128 student of either 7B
    flavour (width 256, 2 heads, depth 2) with every block recomputed in
    the backward (``remat_every`` 1) and LARS at momentum 0, from the
    frozen vittest16 teacher at 112^2, batch 4, queue 16, fp32: the path of
    a 7B student on one card. Held to the JAX step with the same batch and
    parameters as ``test_torch_distillation.py`` holds the default
    student's: the loss within 1e-4 relative, the student and heads within
    1e-4 / 1e-5, the queue likewise."""
    name = f"{flavour}/hd128"
    cfg_j = _narrow(JV, flavour, patch, remat_every=1)
    cfg_t = _narrow(TV, flavour, patch, remat_every=1)
    args = dict(teacher="dinov3/vittest16", image_size=SIZE, queue_size=Q)
    j_method = JV3.DistillationV3(
        JW.WrappedModel(name, JV.VisionTransformer(cfg_j), 256, patch),
        JV3.DistillationV3Args(**args))
    j_params, j_model_state, j_ms = _jax_distill_init(j_method)

    method = V3.DistillationV3(
        TW.WrappedModel(name, TV.VisionTransformer(cfg_t), 256, patch),
        V3.DistillationV3Args(**args))
    params, method_state = method.init(torch.Generator().manual_seed(0),
                                       torch.device("cpu"))
    params.load_state_dict(params_from_jax(jax.device_get(j_params)))
    carried = method_state_from_jax(jax.device_get(j_ms))
    method_state["teacher"].load_state_dict(carried["teacher"])
    method_state.update({k: v for k, v in carried.items() if k != "teacher"})
    student = params["student"].cfg
    assert (student.embed_dim // student.num_heads, student.remat_every) == (
        HD, 1)
    lr = LR["distillationv3"]
    updater = build_update(method, LARSArgs(lr=lr, momentum=0.0,
                                            weight_decay=1e-6),
                           cosine_warmup(lr, TOTAL, 2),
                           dict(params.named_parameters()), TOTAL)
    assert "trace" not in updater.state_dict()
    state = TrainState(0, params, method_state, updater)

    j_opt = build_optimizer(
        JaxLARSArgs(lr=lr, momentum=0.0, weight_decay=1e-6),
        jax_cw(lr, TOTAL, 2), j_params,
        grad_clip_norm=j_method.grad_clip_norm(),
        lr_scales=j_method.lr_scales(j_params),
        weight_decay_schedule=j_method.weight_decay_schedule(TOTAL),
        wd_mask=j_method.wd_mask(j_params))
    view = np.random.default_rng(101).standard_normal(
        (B, SIZE, SIZE, 3)).astype(np.float32)
    rng = jax.random.key(1001)
    j_loss, j_params, j_ms = _jax_distill_step(
        j_method, j_opt, j_params, j_model_state, j_ms, view, rng)

    lam, apply = jax_mixup_draw(rng, method.args.mixup_prob)
    masks = [(torch.tensor(np.asarray(lam)), torch.tensor(np.asarray(apply)))]
    metrics = make_train_step(method, TOTAL)(
        state, None, None, views=[[torch.tensor(view)]], masks=masks)
    np.testing.assert_allclose(float(metrics["train_loss"]), float(j_loss),
                               rtol=1e-4)
    assert_params_close(dict(state.params.named_parameters()), j_params,
                        "step 0 params")
    np.testing.assert_allclose(state.method_state["queue"].numpy(),
                               np.asarray(j_ms["queue"]), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The teacher's init, leaf by leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["dinov3/vittest16", "dinov2/vittest14"])
def test_teacher_init_on_its_device_keeps_the_cpu_values(model):
    """``DistillationV3.init`` allocates a random teacher on the run's
    device with ``to_empty`` (uninitialised memory) and draws it leaf by
    leaf from the CPU generator. Every value must equal the init of the
    module as constructed (LayerNorm and LayerScale from their
    constructors) from the same seed: with every parameter of the empty
    module set to NaN first, ``reset_parameters`` gives the same state
    dict bitwise, so it sets every parameter the constructor did."""
    built = get_wrapped_model(model).module
    built.reset_parameters(torch.Generator().manual_seed(3))
    empty = get_wrapped_model(model).module.to_empty(device="cpu")
    for p in empty.parameters():
        p.data.fill_(float("nan"))
    empty.reset_parameters(torch.Generator().manual_seed(3))
    want = built.state_dict()
    for name, value in empty.state_dict().items():
        assert torch.equal(value, want[name]), name
