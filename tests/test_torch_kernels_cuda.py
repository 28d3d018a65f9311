"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where there is no NVIDIA card (the kernels have
no CPU mode). This file imports neither JAX nor the JAX package, so it also
runs on the GPU machines, which have no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import re

import numpy as np
import pytest
import torch

from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch._optim import fused_update as F
from lightly_train_tpu_torch.ops.kernels import attention as A

pytestmark = pytest.mark.cuda
HD = 64
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    # The plain versions' fp32 products in full fp32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _floor(scale, hd, do, v, other):
    """One 2^-16 rounding of dp = do . v (the fp32 kernels' hi/lo products
    keep about 16 bits) carried through ds into dq (``other`` = k) or dk
    (``other`` = q), per element. It matters only where dp - delta cancels
    (N = 1: the exact dq and dk are 0, and what both sides give is the
    rounding of do)."""
    rms = [x.float().pow(2).mean().sqrt().item() for x in (do, v, other)]
    return 2.0 ** -16 * scale * hd ** 0.5 * float(np.prod(rms))


def _within(got, ref, dtype, floor=0.0):
    """bf16: within 2^-7 of the reference's largest magnitude (a few bf16
    ulps, where a probability near a rounding boundary rounds the other
    way) and within 1e-2 relative L2, which a systematic error on a few
    rows exceeds. fp32: the outputs are not rounded to bf16, but p and ds
    still are, on both sides, and the kernel's hi/lo products are about
    2^-16 off the plain fp32 ones, so some roundings go the other way:
    max-abs as for bf16, relative L2 1e-3, which a kernel computing in bf16
    alone exceeds (test_fp32_tolerance_rejects_bf16_inputs). ``floor`` is
    added per element (8 of it to the max-abs bound)."""
    max_rel, l2 = (2.0 ** -7, 1e-2) if dtype == torch.bfloat16 else (
        2.0 ** -7, 1e-3)
    diff = got.float() - ref.float()
    return (diff.abs().max().item()
            <= max_rel * ref.float().abs().max().item() + 8 * floor
            and diff.norm().item() <= (l2 * ref.float().norm().item()
                                       + floor * diff.numel() ** 0.5))


def _close_grads(o, grads, o_ref, refs, dtype, scale, hd, q, k, v, do):
    """o, dq, dk, dv against their plain versions, with the floor on dq and
    dk."""
    floors = (0.0, _floor(scale, hd, do, v, k), _floor(scale, hd, do, v, q),
              0.0)
    for got, ref, floor in zip((o, *grads), (o_ref, *refs), floors):
        assert got.dtype == ref.dtype == dtype
        assert _within(got, ref, dtype, floor)


def _randn(shape, gen, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# (B, N, H, hd): the ViT-B/14 shapes, N = 1, the top of the range (730 =
# ViT-B/14 at 378^2, 768) and hd 16. Every forward and backward runs the
# wgmma kernels of its dtype (flat_attention_{fwd,bwd}_sm90.cu in bf16,
# *_f32_sm90.cu in fp32), at hd 16 those of csrc/attention_fwd_hd16.cuh
# and csrc/attention_bwd_hd16.cuh, whose one-tile form (N <= 64) and first
# two-tile shape (65) are here too, beside N = 1 and N = 768.
SHAPES = [
    (48, 257, 12, 64), (48, 37, 12, 64), (40, 257, 2, 16), (6, 640, 12, 64),
    (6, 300, 12, 64), (6, 730, 12, 64),
    (2, 257, 12, 64), (3, 37, 12, 64), (1, 1, 2, 64), (2, 512, 4, 64),
    (2, 730, 4, 64), (1, 768, 4, 64), (2, 257, 2, 16), (1, 768, 2, 16),
    (2, 100, 2, 16), (1, 37, 2, 64), (3, 37, 2, 16), (1, 1, 2, 16),
    (2, 64, 2, 16), (2, 65, 2, 16),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,N,H,hd", SHAPES)
def test_attention_kernels_match_plain(cuda, dtype, B, N, H, hd):
    """K1/K2 (flat layout) against their plain versions."""
    dt = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(N + hd)
    q, k, v, do = (_randn((B, N, H * hd), gen, dt) for _ in range(4))
    scale = hd ** -0.5
    o, lse = A.flat_attention_fwd(q, k, v, H, scale)
    o_ref, lse_ref = A.flat_attention_fwd_plain(q, k, v, H, scale)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)
    grads = A.flat_attention_bwd(q, k, v, o, do, lse, H, scale)
    refs = A.flat_attention_bwd_plain(q, k, v, o, do, lse, H, scale)
    _close_grads(o, grads, o_ref, refs, dt, scale, hd, q, k, v, do)


@pytest.mark.parametrize("B", [64, 3])
def test_teacher_forward_matches_plain(cuda, B):
    """K1 in fp32 at the frozen DINOv3 ViT-B/16 teacher's shape (14 x 14
    patches + CLS + 4 registers: N = 201 = 3 * 64 + 9, a ragged last row
    tile), forward only, as distillation runs it in every precision."""
    N, H, hd = 201, 12, 64
    gen = torch.Generator(device=cuda).manual_seed(N)
    q, k, v = (_randn((B, N, H * hd), gen, torch.float32) for _ in range(3))
    scale = hd ** -0.5
    before = A.fwd_launches["flat_attention_fwd_f32_sm90"]
    with torch.no_grad():
        o, lse = A.flat_attention_fwd(q, k, v, H, scale)
    assert A.fwd_launches["flat_attention_fwd_f32_sm90"] == before + 1
    o_ref, lse_ref = A.flat_attention_fwd_plain(q, k, v, H, scale)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)
    assert o.dtype == torch.float32 and _within(o, o_ref, torch.float32)


@pytest.fixture
def deterministic_cudnn():
    """cuDNN's default fp32 weight-gradient algorithm for the 32-wide
    vittest14 patch embed accumulates in no fixed order (two calls'
    gradients differ in their last bits); at ViT-B/14's width it picks a
    deterministic one (chip_smoke.py's resumed runs are bitwise). Pinned
    here, so that the test holds the distillation path's own ops."""
    prior = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prior


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_distillation_gradients_are_deterministic(cuda, deterministic_cudnn,
                                                  precision):
    """Two backward passes of the distillation loss (vittest14 student,
    dinov3/vittest16 teacher, the patch grid resampled 8 x 8 -> 7 x 7) on
    the same inputs give bitwise the same gradients and queue: a resumed
    run on the card repeats the uninterrupted one."""
    from lightly_train_tpu_torch.methods.distillationv3 import (
        DistillationV3,
        DistillationV3Args,
    )
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    method = DistillationV3(
        get_wrapped_model("dinov2/vittest14", dtype=DTYPES[precision]),
        DistillationV3Args(teacher="dinov3/vittest16", image_size=112,
                           queue_size=16))
    params, state = method.init(torch.Generator().manual_seed(0), cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    images = torch.randn((32, 112, 112, 3), generator=gen, device=cuda)
    runs = []
    for _ in range(2):
        for p in params.parameters():
            p.grad = None
        gen.manual_seed(2)
        loss, (new_state, _) = method.loss_fn(params, state, [images], 0, 10,
                                              generator=gen)
        loss.backward()
        runs.append((loss.detach(), new_state["queue"],
                     [p.grad.clone() for p in params.parameters()
                      if p.grad is not None]))
    (l0, q0, g0), (l1, q1, g1) = runs
    assert torch.equal(l0, l1) and torch.equal(q0, q1) and len(g0) == len(g1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("B,N,H,hd", [(48, 257, 12, 64), (2, 257, 12, 64),
                                      (16, 37, 12, 64)])
def test_fp32_tolerance_rejects_bf16_inputs(cuda, B, N, H, hd):
    """Control for the fp32 tolerance: the kernels fed fp32 inputs rounded
    to bf16 (what a kernel computing in bf16 alone would see) fall outside
    it against the plain version on the unrounded inputs."""
    gen = torch.Generator(device=cuda).manual_seed(N + hd)
    q, k, v, do = (_randn((B, N, H * hd), gen, torch.float32)
                   for _ in range(4))
    scale = hd ** -0.5
    r = [x.to(torch.bfloat16).float() for x in (q, k, v, do)]
    o_c, lse_c = A.flat_attention_fwd(*r[:3], H, scale)
    before = A.bwd_launches["flat_attention_bwd_f32_sm90"]
    got = (o_c, *A.flat_attention_bwd(*r[:3], o_c, r[3], lse_c, H, scale))
    # The fp32 backward at hd 64 is the wgmma one.
    assert A.bwd_launches["flat_attention_bwd_f32_sm90"] == before + 1
    o_ref, lse_ref = A.flat_attention_fwd_plain(q, k, v, H, scale)
    refs = (o_ref,
            *A.flat_attention_bwd_plain(q, k, v, o_ref, do, lse_ref, H, scale))
    floors = (0.0, _floor(scale, hd, do, v, k), _floor(scale, hd, do, v, q),
              0.0)
    assert not all(_within(a, b, torch.float32, f)
                   for a, b, f in zip(got, refs, floors))


def _per_head(shape, layout, gen, dtype):
    """A (B, H, N, hd) tensor: real ("bhnd"), or the transposed view of a
    (B, N, H, hd) one ("bnhd", what vmem_attention hands the kernels)."""
    B, N, H, hd = shape
    if layout == "bhnd":
        return _randn((B, H, N, hd), gen, dtype)
    return _randn((B, N, H, hd), gen, dtype).transpose(1, 2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["bhnd", "bnhd"])
@pytest.mark.parametrize("B,N,H,hd", [
    (4, 257, 12, 64), (48, 257, 12, 64), (8, 37, 12, 64), (2, 730, 2, 64),
    (2, 257, 2, 16), (2, 257, 2, 64),
])
def test_vmem_attention_kernels_match_plain(cuda, dtype, layout, B, N, H, hd):
    """K4/K5 against their plain versions, in both layouts; the outputs
    keep the inputs' layout."""
    dt = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(N + hd + B)
    q, k, v, do = (_per_head((B, N, H, hd), layout, gen, dt)
                   for _ in range(4))
    scale = hd ** -0.5
    o, lse = A.vmem_attention_fwd(q, k, v, scale)
    assert o.stride() == q.stride()
    o_ref, lse_ref = A.vmem_attention_fwd_plain(q, k, v, scale)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)
    grads = A.vmem_attention_bwd(q, k, v, o, do, lse, scale)
    refs = A.vmem_attention_bwd_plain(q, k, v, o, do, lse, scale)
    _close_grads(o, grads, o_ref, refs, dt, scale, hd, q, k, v, do)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N,H,hd", [(257, 12, HD), (201, 4, 128),
                                    (257, 4, 128), (304, 3, 128)])
def test_attention_kernels_read_strided_qkv(cuda, dtype, N, H, hd):
    """q/k/v as column slices of one fused (B, N, 3D) projection output: the
    same bits as on contiguous copies, forward and backward (at hd 128 the
    tensor maps of the forward's resident kernel and of the bf16
    backward's kernels over the strided views)."""
    B, D = 2, H * hd
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = _randn((B, N, 3 * D), gen, DTYPES[dtype])
    do = _randn((B, N, D), gen, DTYPES[dtype])
    q, k, v = qkv.split(D, dim=-1)
    dense = [x.contiguous() for x in (q, k, v)]
    o, lse = A.flat_attention_fwd(q, k, v, H, hd ** -0.5)
    o_ref, lse_ref = A.flat_attention_fwd(*dense, H, hd ** -0.5)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=0)
    got = A.flat_attention_bwd(q, k, v, o, do, lse, H, hd ** -0.5)
    ref = A.flat_attention_bwd(*dense, o, do, lse, H, hd ** -0.5)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vmem_attention_kernels_read_non_contiguous_views(cuda, dtype):
    """K4/K5 on views: q/k/v/do as slices of a fused (B, N, 4, H, hd) tensor
    and of a (B, H, N, 2 hd) one give what their dense copies give."""
    B, N, H, hd = 2, 257, 4, 64
    gen = torch.Generator(device=cuda).manual_seed(11)
    fused = _randn((B, N, 4, H, hd), gen, DTYPES[dtype])
    wide = _randn((B, H, N, 2 * hd), gen, DTYPES[dtype])
    for views in ([fused[:, :, i].transpose(1, 2) for i in range(4)],
                  [wide[..., :hd], wide[..., hd:], fused[:, :, 0].transpose(
                      1, 2), fused[:, :, 1].transpose(1, 2)]):
        q, k, v, do = views
        dense = [x.contiguous() for x in views]
        o, lse = A.vmem_attention_fwd(q, k, v, hd ** -0.5)
        o_ref, lse_ref = A.vmem_attention_fwd(*dense[:3], hd ** -0.5)
        torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
        torch.testing.assert_close(lse, lse_ref, rtol=0, atol=0)
        got = A.vmem_attention_bwd(q, k, v, o, do, lse, hd ** -0.5)
        ref = A.vmem_attention_bwd(*dense[:3], o_ref, dense[3], lse_ref,
                                   hd ** -0.5)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_autograd_through_kernels_matches_plain_attention(cuda):
    """flat_attention's gradients against plain softmax attention."""
    B, N, D = 4, 257, 12 * HD
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((B, N, D), generator=gen, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    co = torch.randn((B, N, D), generator=gen, device=cuda).to(torch.bfloat16)
    before = A.flat_attention_fwd.launches, A.flat_attention_bwd.launches
    grads = torch.autograd.grad((A.attention(q, k, v, 12) * co).sum(),
                                (q, k, v))
    assert (A.flat_attention_fwd.launches, A.flat_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    refs = torch.autograd.grad(
        (A.dot_product_attention(qf, kf, vf, 12) * co.float()).sum(),
        (qf, kf, vf))
    for got, ref in zip(grads, refs):
        # bf16 probabilities against fp32 ones: 2% of the largest gradient.
        tol = 2e-2 * ref.abs().max().item()
        assert (got.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vmem_attention_autograd_runs_the_kernels(cuda, dtype):
    """vmem_attention (B, N, H, hd) forward and backward through K4/K5,
    against plain fp32 softmax attention; the incoming gradient of
    ``.sum()``, an expanded tensor, is made dense for the kernels."""
    B, N, H, hd = 4, 257, 12, 64
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_randn((B, N, H, hd), gen, DTYPES[dtype]).requires_grad_()
               for _ in range(3))
    co = _randn((B, N, H, hd), gen, DTYPES[dtype])
    counters = (A.vmem_attention_fwd, A.vmem_attention_bwd,
                A.flat_attention_fwd, A.flat_attention_bwd)
    before = [c.launches for c in counters]
    out = A.vmem_attention(q, k, v)
    grads = torch.autograd.grad((out * co).sum(), (q, k, v))
    torch.autograd.grad(A.vmem_attention(q, k, v).sum(), (q, k, v))
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 0, 0]
    assert out.shape == (B, N, H, hd) and out.is_contiguous()
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    ref_out = torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in (qf, kf, vf))).transpose(1, 2)
    refs = torch.autograd.grad((ref_out * co.float()).sum(), (qf, kf, vf))
    for got, ref in zip((out, *grads), (ref_out, *refs)):
        # bf16 probabilities against fp32 ones: 2% of the largest value.
        tol = 2e-2 * ref.abs().max().item()
        assert (got.float() - ref).abs().max().item() <= tol


# K3 cases, each one launch over all its leaves: shapes of ViT-B/14 leaves;
# the plan's edges (n = 1, 3, 5, a chunk's + 1, + 3, a leaf of no gradient);
# the clip scale formed from a grad norm on the card; lr 0, which must keep
# the weights bitwise (a ``checkpoint=`` warm start: p' = p - 0 * u is p,
# weight decay included); two steps with every gradient reallocated in
# between (a stale address table would read the old ones).
K3_SHAPES = {
    "vit_shapes": [(768, 768), (257, 768), (7,), (65536, 256)],
    "ragged_and_no_grad": [(1,), (3,), (5,), (4097,), (65537,),
                           (F.CHUNK_ELEMS + 3,), (768,)],
}


@pytest.mark.parametrize("case", ["vit_shapes", "ragged_and_no_grad",
                                  "clip_from_norm", "lr_0_bitwise",
                                  "two_steps_new_grads"])
def test_fused_update_kernel_matches_plain(cuda, case):
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    shapes = K3_SHAPES.get(case, K3_SHAPES["ragged_and_no_grad"])

    def randn(shape):
        return torch.randn(shape, generator=gen, device=cuda)

    leaves = [[randn(shape), randn(shape), 0.1 * randn(shape),
               0.01 * torch.rand(shape, generator=gen, device=cuda),
               randn(shape)] for shape in shapes]
    if case == "ragged_and_no_grad":
        leaves[-1][0] = None
    n = len(leaves)
    scalars = np.tile(np.float32([0.7, 1.5, 1.1, 2e-3, 0.04, 0.995, 0, 0]),
                      (n, 1))
    scalars[:, 3] *= 1 + np.arange(n) % 3
    scalars[:, 4] *= np.arange(n) % 2
    if case == "lr_0_bitwise":
        scalars[:, 1:4] = (10.0, 1000.0, 0.0)
    clip = ((torch.tensor(5.0, device=cuda), 2.0)
            if case == "clip_from_norm" else None)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    ref = [[x if x is None else x.clone() for x in leaf] for leaf in leaves]
    p0 = [leaf[1].clone() for leaf in leaves]
    state = F.LeafSet(*([leaf[k] for leaf in leaves] for k in range(1, 5)))
    steps = 2 if case == "two_steps_new_grads" else 1
    before = F.fused_adamw_ema.launches
    for step in range(steps):
        grads = [leaf[0] for leaf in leaves]
        if step:
            # New gradients while the old ones live: new addresses.
            grads = [randn(g.shape) for g in grads]
            assert not {g.data_ptr() for g in grads} & {
                leaf[0].data_ptr() for leaf in leaves}
        F.fused_adamw_ema(state, grads, scalars, clip, **hp)
        table = torch.tensor(scalars, device=cuda)
        if clip is not None:
            table[:, 0] = F.clip_scale_plain(*clip)
        for r, g, s in zip(ref, grads, table):
            r[1:] = F.fused_adamw_ema_leaf_plain(
                torch.zeros_like(r[1]) if g is None else g, *r[1:], s, **hp)
    torch.cuda.synchronize()
    assert F.fused_adamw_ema.launches == before + steps
    for leaf, r, p_start in zip(leaves, ref, p0):
        if case == "lr_0_bitwise":
            assert torch.equal(leaf[1], p_start)
        for got, want in zip(leaf[1:], r[1:]):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    def flat(N, D, dtype):
        return torch.zeros((1, N, D), dtype=dtype, device=cuda)

    x = flat(769, 12 * HD, torch.bfloat16)
    with pytest.raises(ValueError, match="N <= 768"):
        A.flat_attention_fwd(x, x, x, 12, 0.125)
    x = flat(8, 12 * 32, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        A.flat_attention_fwd(x, x, x, 12, 0.125)  # hd 32
    for dtype in (torch.float16, torch.float64):
        x = flat(8, 12 * HD, dtype)
        with pytest.raises(ValueError, match="bf16 or fp32"):
            A.flat_attention_fwd(x, x, x, 12, 0.125)
        y = x.view(1, 8, 12, HD).transpose(1, 2)
        with pytest.raises(ValueError, match="bf16 or fp32"):
            A.vmem_attention_fwd(y, y, y, 0.125)
    x, y = flat(8, 12 * HD, torch.float32), flat(8, 12 * HD, torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):
        A.flat_attention_fwd(x, y, y, 12, 0.125)
    wide = flat(8, 12 * HD + 1, torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        A.flat_attention_fwd(wide[..., 1:], wide[..., 1:], wide[..., 1:], 12,
                             0.125)
    # K3: leaves checked once (16-byte aligned), gradients every step.
    x = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        F.LeafSet([torch.zeros(65, device=cuda)[1:]], [x], [x], [x])
    leaves = F.LeafSet([x], [x.clone()], [x.clone()], [x.clone()])
    scalars = np.zeros((1, 8), np.float32)
    for g in (x.double(), x[:63], torch.zeros(65, device=cuda)[1:], x.cpu(),
              torch.zeros(128, device=cuda)[::2]):
        with pytest.raises(ValueError, match="gradients"):
            F.fused_adamw_ema(leaves, [g], scalars, b1=0.9, b2=0.999,
                              eps=1e-8)


@pytest.mark.parametrize("hd", [16, 64, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N", [37, 730])
def test_vit_attention_on_the_card_never_runs_the_plain_path(cuda, dtype, N,
                                                             hd, monkeypatch):
    """Unmasked attention on CUDA tensors with N <= 768 launches the kernels,
    in bf16 and fp32, at every head dim (these inputs do not require
    grad: the forward alone); fp16 raises instead of running plain, and so does
    LIGHTLY_TRAIN_VMEM_ATTENTION=0. Only a mask sends it to the plain
    path."""
    y = torch.zeros((2, N, 12 * hd), dtype=DTYPES[dtype], device=cuda)
    before = A.flat_attention_fwd.launches
    out = A.attention(y, y, y, 12)
    assert A.flat_attention_fwd.launches == before + 1
    assert out.dtype == y.dtype and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="bf16 or fp32"):
        A.attention(y.half(), y.half(), y.half(), 12)
    monkeypatch.setenv("LIGHTLY_TRAIN_VMEM_ATTENTION", "0")
    with pytest.raises(ValueError, match="no plain path"):
        A.attention(y, y, y, 12)
    assert A.flat_attention_fwd.launches == before + 1


# (N, B, H) for the Hopper bf16 hd-64 forward: a single key tile (N <= 64,
# S kept in registers), one past a tile, ragged tails of every wgmma width
# (16, 32, 48, 64), the ViT-B/14 shapes (37, 257, 730) and the top of the
# range; B * H from 2 to 768. 170 and 182 give the ring's last tile 48 and
# 64 keys, after an odd number of query tiles (the last block's second
# warpgroup has none).
SM90_SHAPES = [
    (1, 1, 2), (37, 64, 12), (63, 2, 3), (64, 4, 4), (65, 3, 5), (129, 2, 6),
    (170, 2, 5), (182, 3, 2), (257, 64, 12), (577, 2, 4), (730, 16, 12),
    (768, 1, 2),
]


def _bf16_inputs(layout, B, N, H, gen, dtype=torch.bfloat16, hd=HD):
    """q, k, v (``dtype``, bf16 unless given; hd 64 unless given) and the
    plain forward for ``layout``: "flat" (column slices of one fused (B, N,
    3 H hd) qkv output), "bnhd" (the transposed views of (B, N, H, hd)
    tensors, as vmem_attention hands them over) or "bhnd"."""
    scale = hd ** -0.5
    if layout == "flat":
        qkv = _randn((B, N, 3 * H * hd), gen, dtype)
        q, k, v = qkv.split(H * hd, dim=-1)
        return (q, k, v), (lambda *x: A.flat_attention_fwd(*x, H, scale),
                           lambda *x: A.flat_attention_fwd_plain(
                               *x, H, scale))
    q, k, v = (_per_head((B, N, H, hd), layout, gen, dtype)
               for _ in range(3))
    return (q, k, v), (lambda *x: A.vmem_attention_fwd(*x, scale),
                       lambda *x: A.vmem_attention_fwd_plain(*x, scale))


@pytest.mark.parametrize("layout", ["flat", "bnhd", "bhnd"])
@pytest.mark.parametrize("N,B,H", SM90_SHAPES)
def test_sm90_forward_matches_plain(cuda, monkeypatch, layout, N, B, H):
    """bf16 at hd 64 runs flat_attention_fwd_sm90 (K1 and K4), within the
    bf16 tolerances of the plain forward."""
    asked = []
    function = _native.function
    monkeypatch.setattr(_native, "function",
                        lambda name: asked.append(name) or function(name))
    gen = torch.Generator(device=cuda).manual_seed(N + B + H)
    qkv, (fwd, plain) = _bf16_inputs(layout, B, N, H, gen)
    o, lse = fwd(*qkv)
    o_ref, lse_ref = plain(*qkv)
    assert asked == ["flat_attention_fwd_sm90"]
    assert o.dtype == torch.bfloat16 and torch.isfinite(o).all()
    assert _within(o, o_ref, torch.bfloat16)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)


# (N, B, H) for the Hopper forward at hd 16 (csrc/attention_fwd_hd16.cuh):
# N = 1 and the one-tile form at other last-tile widths (16, 37, 63, 64),
# one past a tile (65), ragged tails of every wgmma width after an odd and
# an even number of whole tiles (129, 170, 182, 257), the vittest14 shapes
# of pretrain at batch 32 (257 at B 64, 37 at B 256) and the top of the
# range (730, 768: twelve key tiles staged at once).
HD16_SHAPES = [
    (1, 1, 2), (16, 3, 2), (37, 256, 2), (63, 2, 3), (64, 4, 2), (65, 3, 2),
    (129, 2, 2), (170, 2, 5), (182, 3, 2), (257, 8, 2), (257, 64, 2),
    (730, 2, 2), (768, 1, 2),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["flat", "bnhd", "bhnd"])
@pytest.mark.parametrize("N,B,H", HD16_SHAPES)
def test_sm90_forward_hd16_matches_plain(cuda, monkeypatch, dtype, layout, N,
                                         B, H):
    """At hd 16 both dtypes run their wgmma library (K1 and K4): the one
    launch goes to flat_attention_fwd_sm90 (bf16) or
    flat_attention_fwd_f32_sm90 (fp32) and no other, within the dtype's
    tolerances of the plain forward; o keeps q's layout."""
    dt = DTYPES[dtype]
    library = A.fwd_library(dt, 16)
    asked = []
    function = _native.function
    monkeypatch.setattr(_native, "function",
                        lambda name: asked.append(name) or function(name))
    gen = torch.Generator(device=cuda).manual_seed(N + B + H + 4)
    qkv, (fwd, plain) = _bf16_inputs(layout, B, N, H, gen, dt, hd=16)
    before = dict(A.fwd_launches)
    o, lse = fwd(*qkv)
    o_ref, lse_ref = plain(*qkv)
    assert asked == [library]
    assert A.fwd_launches == {**before, library: before[library] + 1}
    assert o.dtype == dt and torch.isfinite(o).all()
    if layout != "flat":
        assert o.stride() == qkv[0].stride()
    assert _within(o, o_ref, dt)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)


# (N, B, H) for the Hopper forward at hd 128: N = 1 and the one-tile form
# (37, 64) of csrc/attention_fwd_hd128.cuh; one past a tile (65), two whole
# tiles (128), ragged tails of every wgmma width after an odd and an even
# number of whole tiles (129, 170, 182, 193), a whole last tile (192, 256),
# the 7B/16 teacher's and the 7B/14 embed's token counts (201, 257; last
# tiles of 9 and 1 keys), 257 again over 384 heads (about three a block of
# the persistent grid, so the rings wrap), 288 and 304 (the top of the
# form) on csrc/attention_fwd_hd128_resident.cuh in both dtypes; 305 (the
# first N past the resident form), 320, 321 and the top of the range (730,
# 768) on attention_fwd_hd128.cuh in both.
HD128_SHAPES = [
    (1, 1, 2), (37, 4, 2), (64, 2, 2), (65, 3, 2), (128, 2, 3), (129, 2, 3),
    (170, 2, 5), (182, 3, 2), (192, 2, 3), (193, 3, 2), (201, 4, 8),
    (256, 2, 4), (257, 4, 8), (257, 12, 32), (288, 2, 3), (304, 3, 2),
    (305, 2, 3), (320, 3, 2), (321, 2, 2), (730, 2, 2), (768, 1, 2),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["flat", "bnhd", "bhnd"])
@pytest.mark.parametrize("N,B,H", HD128_SHAPES)
def test_sm90_forward_hd128_matches_plain(cuda, monkeypatch, dtype, layout,
                                          N, B, H):
    """At hd 128 both dtypes run their wgmma library (K1 and K4): the one
    launch goes to flat_attention_fwd_sm90 (bf16) or
    flat_attention_fwd_f32_sm90 (fp32) and no other, within the dtype's
    tolerances of the plain forward; o keeps q's layout."""
    dt = DTYPES[dtype]
    library = A.fwd_library(dt, 128)
    asked = []
    function = _native.function
    monkeypatch.setattr(_native, "function",
                        lambda name: asked.append(name) or function(name))
    gen = torch.Generator(device=cuda).manual_seed(N + B + H + 8)
    qkv, (fwd, plain) = _bf16_inputs(layout, B, N, H, gen, dt, hd=128)
    before = dict(A.fwd_launches)
    o, lse = fwd(*qkv)
    o_ref, lse_ref = plain(*qkv)
    assert asked == [library]
    assert A.fwd_launches == {**before, library: before[library] + 1}
    assert o.dtype == dt and torch.isfinite(o).all()
    if layout != "flat":
        assert o.stride() == qkv[0].stride()
    assert _within(o, o_ref, dt)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N,B", [(37, 8), (201, 4), (257, 4), (257, 40),
                                 (304, 8), (768, 1)])
def test_forward_hd128_is_bitwise_repeatable(cuda, dtype, N, B):
    """Each warpgroup sums its rows in one fixed order, whichever block of
    the persistent grid takes the head (B = 40: 160 heads, more than the
    card's SMs): two launches on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(N + 128)
    q, k, v = (_randn((B, N, 4 * 128), gen, DTYPES[dtype]) for _ in range(3))
    first = A.flat_attention_fwd(q, k, v, 4, 128 ** -0.5)
    again = A.flat_attention_fwd(q, k, v, 4, 128 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_forward_hd128_addresses_past_2_31_bytes(cuda):
    """bf16 at (1024, 257, 32, 128), on the resident kernel: each of q, k, v
    and o is 2.16 GB, past 2^31 bytes, so the tensor maps' strides and every
    address the kernel forms must be 64-bit. The first and the last batch
    rows (the latter wholly past 2^31 bytes) are held to the plain forward
    of those rows."""
    B, N, H, hd = 1024, 257, 32, 128
    gen = torch.Generator(device=cuda).manual_seed(31)
    q, k, v = (torch.randn((B, N, H * hd), generator=gen, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    assert q.numel() * q.element_size() > 2 ** 31
    o, lse = A.flat_attention_fwd(q, k, v, H, hd ** -0.5)
    for rows in (slice(0, 2), slice(B - 2, B)):
        o_ref, lse_ref = A.flat_attention_fwd_plain(
            q[rows], k[rows], v[rows], H, hd ** -0.5)
        assert _within(o[rows], o_ref, torch.bfloat16)
        torch.testing.assert_close(lse[rows], lse_ref, rtol=0, atol=5e-3)


@pytest.mark.parametrize("dtype,N,resident", [
    ("bf16", 37, False), ("bf16", 64, False), ("bf16", 65, True),
    ("bf16", 201, True), ("bf16", 257, True), ("bf16", 304, True),
    ("bf16", 305, False), ("bf16", 730, False), ("fp32", 37, False),
    ("fp32", 64, False), ("fp32", 65, True), ("fp32", 201, True),
    ("fp32", 257, True), ("fp32", 304, True), ("fp32", 305, False),
    ("fp32", 730, False)])
@pytest.mark.parametrize("sign", [1, -1])
def test_forward_hd128_route_by_tokens(cuda, dtype, N, resident, sign):
    """The kernel the card ran, by name (torch.profiler): the forward at hd
    128 takes attention_fwd_hd128_resident.cuh's kernel for 64 < N <= 304
    and scale > 0 in both dtypes, and attention_fwd_hd128.cuh's otherwise
    (scale <= 0 too)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=cuda).manual_seed(N)
    q, k, v = (_randn((2, N, 2 * 128), gen, DTYPES[dtype]) for _ in range(3))
    scale = sign * 128 ** -0.5
    A.flat_attention_fwd(q, k, v, 2, scale)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o, lse = A.flat_attention_fwd(q, k, v, 2, scale)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1, names
    assert "attention_fwd_hd128" in names[0]
    assert ("attention_fwd_hd128_resident_kernel" in names[0]) == (
        resident and sign > 0)
    o_ref, lse_ref = A.flat_attention_fwd_plain(q, k, v, 2, scale)
    assert _within(o, o_ref, DTYPES[dtype])
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)


@pytest.mark.parametrize("name", ["flat_attention_fwd_sm90",
                                  "flat_attention_fwd_f32_sm90"])
def test_forward_hd128_library_spills_nothing(cuda, name):
    """ptxas reports no spill and no serialized wgmma (C751x) in either
    forward library, whose resident hd-128 kernels (one per key-tile count
    and last-tile width, 15 a dtype) hold S in registers."""
    _native.function(name)
    log = (_native.BUILD_DIR / f"{name}.log").read_text()
    assert log.count("attention_fwd_hd128_resident_kernel") >= 15
    assert not any(f"C751{i}" in log for i in range(10)), log
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
    assert spills and all(n == "0" for n in spills), log


def _sass_functions(sass: str) -> dict:
    """{function name: its SASS} of a cuobjdump --dump-sass listing."""
    parts = re.split(r"\s*Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


@pytest.mark.parametrize("library", ["flat_attention_fwd_sm90",
                                     "flat_attention_fwd_f32_sm90"])
def test_forward_hd128_resident_runs_hgmma_and_tma(cuda, library):
    """Every resident hd-128 kernel of each forward library is built on
    wgmma (HGMMA), loads its tiles by TMA (UTMALDG) and holds no warp-level
    mma.sync (HMMA)."""
    kernels = {name: body for name, body in _sass_functions(
        _native.sass(library)).items()
        if "attention_fwd_hd128_resident_kernel" in name}
    assert len(kernels) == 15
    for name, body in kernels.items():
        assert "HGMMA" in body and "UTMALDG" in body, name
        assert not re.search(r"\bHMMA\b", body), name


# N for the Hopper backward at hd 128 (bf16: the two kernels of
# csrc/attention_bwd_hd128_tma.cuh; fp32: the three role kernels of
# csrc/attention_bwd_hd128.cuh): N = 1, one tile at the last tile's widths
# (16, 37, 63, 64), one past a tile (65), two whole tiles (128) and one row
# past them (129), a ragged odd tile count (193), the 7B/16 student's and
# the 7B/14 embed's token counts (201, 257: last tiles of 9 and 1 rows, the
# second an odd tile count), 304 and 305, and N = 730 (378^2 images) and
# the top of the range (768).
HD128_BWD_TOKENS = [1, 16, 37, 63, 64, 65, 128, 129, 193, 201, 257, 304, 305,
                    730, 768]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["flat", "bnhd", "bhnd"])
@pytest.mark.parametrize("N", HD128_BWD_TOKENS)
def test_sm90_backward_hd128_matches_plain(cuda, monkeypatch, dtype, layout,
                                           N):
    """At hd 128 both dtypes run their wgmma backward (K2 and K5; bf16 the
    kernels of csrc/attention_bwd_hd128_tma.cuh, fp32 those of
    csrc/attention_bwd_hd128.cuh): the one launch goes to
    flat_attention_bwd_sm90 (bf16) or flat_attention_bwd_f32_sm90 (fp32)
    and no other, within the dtype's tolerances of the plain backward (with
    the dq/dk floor); the gradients keep the inputs' layout. Autograd
    through ``flat_attention`` at hd 128 runs the same kernel."""
    dt = DTYPES[dtype]
    B, H = (3, 2) if N < 200 else (2, 3)
    library = A.bwd_library(dt, 128)
    gen = torch.Generator(device=cuda).manual_seed(N + 128)
    (q, k, v, do), (fwd, bwd, plain) = _bf16_backward(layout, B, N, H, gen,
                                                      dt, hd=128)
    o, lse = fwd(q, k, v)
    asked = []
    function = _native.function
    monkeypatch.setattr(_native, "function",
                        lambda name: asked.append(name) or function(name))
    before = dict(A.bwd_launches)
    grads = bwd(q, k, v, o, do, lse)
    refs = plain(q, k, v, o, do, lse)
    assert asked == [library]
    assert A.bwd_launches == {**before, library: before[library] + 1}
    scale = 128 ** -0.5
    floors = (_floor(scale, 128, do, v, k), _floor(scale, 128, do, v, q),
              0.0)
    for got, ref, x, floor in zip(grads, refs, (q, k, v), floors):
        assert got.dtype == dt and got.shape == x.shape
        if layout != "flat":
            assert got.stride() == x.stride()
        assert torch.isfinite(got).all()
        assert _within(got, ref, dt, floor)
    if layout == "flat":
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        A.flat_attention(*leaves, H).backward(do)
        assert A.bwd_launches[library] == before[library] + 2
        for leaf, got in zip(leaves, grads):
            assert torch.equal(leaf.grad, got)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N,B", [(37, 8), (201, 4), (257, 4), (201, 40),
                                 (257, 40), (768, 1)])
def test_backward_hd128_is_bitwise_repeatable(cuda, dtype, N, B):
    """Every dq, dk and dv element is written by one warpgroup, with no
    atomics, whichever block of the bf16 kernels' persistent grid takes its
    item (B = 40: 160 heads, 320 or 480 items, more than the card's SMs):
    two calls on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(N + B + 128)
    (q, k, v, do), (fwd, bwd, _) = _bf16_backward("flat", B, N, 4, gen,
                                                  DTYPES[dtype], hd=128)
    o, lse = fwd(q, k, v)
    first, second = bwd(q, k, v, o, do, lse), bwd(q, k, v, o, do, lse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("N", [193, 257])
def test_backward_hd128_repeats_on_small_grids(cuda, N):
    """bf16 at hd 128 on grids of a few blocks, each one item: 40 inputs,
    three calls each, bitwise equal and within the bf16 tolerances of the
    plain backward. The dq kernel reads each item's O tiles from a ring
    slot that TMA refills; without a proxy fence before its release, a
    refill could land before the reads and corrupt delta, hence dq and dk,
    now and then."""
    B, H, hd = 2, 3, 128
    scale = hd ** -0.5
    for trial in range(40):
        gen = torch.Generator(device=cuda).manual_seed(N * 1000 + trial)
        q, k, v, do = (_randn((B, N, H * hd), gen, torch.bfloat16)
                       for _ in range(4))
        o, lse = A.flat_attention_fwd(q, k, v, H, scale)
        runs = [A.flat_attention_bwd(q, k, v, o, do, lse, H, scale)
                for _ in range(3)]
        refs = A.flat_attention_bwd_plain(q, k, v, o, do, lse, H, scale)
        floors = (_floor(scale, hd, do, v, k), _floor(scale, hd, do, v, q),
                  0.0)
        for got in runs:
            assert all(torch.equal(a, b) for a, b in zip(got, runs[0]))
        for got, ref, floor in zip(runs[0], refs, floors):
            assert _within(got, ref, torch.bfloat16, floor)


def test_backward_hd128_addresses_past_2_31_bytes(cuda):
    """bf16 at (1024, 257, 32, 128): each of q, k, v, o, do, dq, dk and dv
    is 2.16 GB, past 2^31 bytes, so the tensor maps' strides and every
    address the bf16 kernels form must be 64-bit. The first and the last
    batch rows (the latter
    wholly past 2^31 bytes) are held to the plain backward of those
    rows."""
    B, N, H, hd = 1024, 257, 32, 128
    scale = hd ** -0.5
    gen = torch.Generator(device=cuda).manual_seed(32)
    q, k, v, do = (torch.randn((B, N, H * hd), generator=gen, device=cuda,
                               dtype=torch.bfloat16) for _ in range(4))
    assert q.numel() * q.element_size() > 2 ** 31
    o, lse = A.flat_attention_fwd(q, k, v, H, scale)
    grads = A.flat_attention_bwd(q, k, v, o, do, lse, H, scale)
    for rows in (slice(0, 2), slice(B - 2, B)):
        refs = A.flat_attention_bwd_plain(q[rows], k[rows], v[rows],
                                          o[rows], do[rows], lse[rows], H,
                                          scale)
        floors = (_floor(scale, hd, do[rows], v[rows], k[rows]),
                  _floor(scale, hd, do[rows], v[rows], q[rows]), 0.0)
        for got, ref, floor in zip(grads, refs, floors):
            assert _within(got[rows], ref, torch.bfloat16, floor)


def test_backward_hd128_library_spills_nothing(cuda):
    """ptxas reports no spill and no serialized wgmma (C751x) in either
    backward library, whose hd-128 kernels are its largest (bf16: the two
    TMA-fed kernels, fp32: the three role kernels)."""
    for name, kernel in (("flat_attention_bwd_sm90",
                          "attention_bwd_hd128_tma_kernel"),
                         ("flat_attention_bwd_f32_sm90",
                          "attention_bwd_hd128_kernel")):
        _native.function(name)
        log = (_native.BUILD_DIR / f"{name}.log").read_text()
        assert kernel in log
        assert not any(f"C751{i}" in log for i in range(10)), log
        spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
        assert spills and all(n == "0" for n in spills), log


def test_backward_hd128_tma_runs_hgmma_and_tma(cuda):
    """The bf16 backward's hd-128 kernels (a dq and a dk/dv kernel for each
    last-tile width, 8 in all) are built on wgmma (HGMMA), load their tiles
    by TMA (UTMALDG), hold no warp-level mma.sync (HMMA), and ptxas reports
    no spill for any of them."""
    name = "flat_attention_bwd_sm90"
    kernels = {fn: body for fn, body in _sass_functions(
        _native.sass(name)).items() if "attention_bwd_hd128_tma_kernel" in fn}
    assert len(kernels) == 8
    for fn, body in kernels.items():
        assert "HGMMA" in body and "UTMALDG" in body, fn
        assert not re.search(r"\bHMMA\b", body), fn
    log = (_native.BUILD_DIR / f"{name}.log").read_text()
    entries = re.split(r"Compiling entry function '", log)[1:]
    reports = [e for e in entries if "attention_bwd_hd128_tma_kernel" in
               e.split("'")[0]]
    assert len(reports) == 8
    for report in reports:
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          report)
        assert spill and spill.groups() == ("0", "0"), report


def test_unfused_update_holds_a_few_leaves_beyond_p_and_g(cuda):
    """The leaf-by-leaf update (LARS at momentum 0 with clipping, weight
    decay and lr scales, as a 7B student runs it) holds, beyond the
    parameters and the gradients it is given, less than 3 of the largest
    leaf at its peak; the chain over whole trees held several copies of
    the gradients."""
    from lightly_train_tpu_torch._optim import LARSArgs
    from lightly_train_tpu_torch._optim.update import UnfusedUpdate

    gen = torch.Generator(device=cuda).manual_seed(7)
    shapes = [(4096, 4096), (8192, 4096), (4096, 8192), (4096,), (1, 4096),
              (3, 4096, 16, 16)] * 4
    params = {f"p{i}": torch.randn(s, generator=gen, device=cuda)
              for i, s in enumerate(shapes)}
    update = UnfusedUpdate(LARSArgs(lr=0.1, momentum=0.0, weight_decay=1e-4),
                           0.1, params, grad_clip_norm=1.0,
                           lr_scales={n: 0.5 for n in params})
    largest = max(p.numel() * 4 for p in params.values())
    grads = {n: torch.randn(p.shape, generator=gen, device=cuda)
             for n, p in params.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    norm = update.update_and_apply(grads, params)
    torch.cuda.synchronize()
    beyond = torch.cuda.max_memory_allocated() - base
    assert torch.isfinite(norm) and grads == {}
    assert beyond < 3 * largest, (beyond, largest)


def test_sm90_forward_library_runs_hgmma(cuda):
    """The bf16 hd-64 forward is built on wgmma (HGMMA in its SASS) and
    fills its K/V ring with asynchronous copies (LDGSTS, cp.async)."""
    sass = _native.sass("flat_attention_fwd_sm90")
    assert "HGMMA" in sass and "LDGSTS" in sass


# (N, B, H) for the Hopper fp32 hd-64 forward: N = 1, a single key tile
# (37, 64: one warpgroup, S kept for both passes), one past a tile (65),
# the ViT-B/14 shapes (37, 257, 730), the resident form's edges (320, 384)
# and the streamed ring's first (385) and last (768) N; B * H from 4 to
# 192, several blocks each. 65, 257 and 385 give an odd number of query
# tiles (the last block's second warpgroup has none).
SM90_F32_SHAPES = [
    (1, 2, 2), (37, 16, 12), (64, 4, 4), (65, 3, 5), (257, 16, 12),
    (320, 2, 6), (384, 2, 3), (385, 2, 3), (730, 16, 12), (768, 2, 4),
]


@pytest.mark.parametrize("layout", ["flat", "bnhd", "bhnd"])
@pytest.mark.parametrize("N,B,H", SM90_F32_SHAPES)
def test_sm90_f32_forward_matches_plain(cuda, monkeypatch, layout, N, B, H):
    """fp32 at hd 64 runs flat_attention_fwd_f32_sm90 (K1 and K4), within
    the fp32 tolerances of the plain forward, and counts its launch."""
    asked = []
    function = _native.function
    monkeypatch.setattr(_native, "function",
                        lambda name: asked.append(name) or function(name))
    gen = torch.Generator(device=cuda).manual_seed(N + B + H + 2)
    qkv, (fwd, plain) = _bf16_inputs(layout, B, N, H, gen, torch.float32)
    before = A.fwd_launches["flat_attention_fwd_f32_sm90"]
    o, lse = fwd(*qkv)
    o_ref, lse_ref = plain(*qkv)
    assert asked == ["flat_attention_fwd_f32_sm90"]
    assert A.fwd_launches["flat_attention_fwd_f32_sm90"] == before + 1
    assert o.dtype == torch.float32 and torch.isfinite(o).all()
    if layout != "flat":
        assert o.stride() == qkv[0].stride()
    assert _within(o, o_ref, torch.float32)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)


def test_sm90_f32_forward_library_runs_hgmma(cuda):
    """The fp32 hd-64 forward is built on wgmma (HGMMA in its SASS), and
    ptxas serialized none of its products (no C751x warning)."""
    sass = _native.sass("flat_attention_fwd_f32_sm90")
    assert "HGMMA" in sass
    log = (_native.BUILD_DIR / "flat_attention_fwd_f32_sm90.log").read_text()
    assert not any(f"C751{i}" in log for i in range(10)), log


# (N, B, H) for the Hopper bf16 hd-64 backward: one tile (N <= 64, the
# one-kernel form) at every last-tile width (15, 16, 37, 63, 64), one past a
# tile, ragged and whole tiles of the streamed form (65, 127, 128, 257, 512,
# 730, 768), the ViT-B/14 shapes (37, 257, 730) and the top of the range;
# B * H from 2 to 768. 65, 257 and 768 give an odd number of tiles (the
# last block's second warpgroup has none).
SM90_BWD_SHAPES = [
    (1, 1, 2), (15, 4, 3), (16, 2, 4), (37, 64, 12), (63, 2, 3), (64, 4, 4),
    (65, 3, 5), (127, 2, 6), (128, 5, 2), (257, 64, 12), (512, 2, 4),
    (730, 16, 12), (768, 1, 2),
]


def _bf16_backward(layout, B, N, H, gen, dtype=torch.bfloat16, hd=HD):
    """q, k, v, do (``dtype``, bf16 unless given; hd 64 unless given) in
    ``layout`` (as _bf16_inputs; do a tensor of q's layout), and the
    forward, backward and plain backward."""
    (q, k, v), (fwd, _) = _bf16_inputs(layout, B, N, H, gen, dtype, hd)
    scale = hd ** -0.5
    if layout == "flat":
        do = _randn((B, N, H * hd), gen, dtype)
        return (q, k, v, do), (
            fwd, lambda *x: A.flat_attention_bwd(*x, H, scale),
            lambda *x: A.flat_attention_bwd_plain(*x, H, scale))
    do = _per_head((B, N, H, hd), layout, gen, dtype)
    return (q, k, v, do), (
        fwd, lambda *x: A.vmem_attention_bwd(*x, scale),
        lambda *x: A.vmem_attention_bwd_plain(*x, scale))


@pytest.mark.parametrize("layout", ["flat", "bnhd", "bhnd"])
@pytest.mark.parametrize("N,B,H", SM90_BWD_SHAPES)
def test_sm90_backward_matches_plain(cuda, monkeypatch, layout, N, B, H):
    """bf16 at hd 64 runs flat_attention_bwd_sm90 (K2 and K5), within the
    bf16 tolerances of the plain backward; the gradients keep the inputs'
    layout."""
    gen = torch.Generator(device=cuda).manual_seed(N + B + H + 1)
    (q, k, v, do), (fwd, bwd, plain) = _bf16_backward(layout, B, N, H, gen)
    o, lse = fwd(q, k, v)
    asked = []
    function = _native.function
    monkeypatch.setattr(_native, "function",
                        lambda name: asked.append(name) or function(name))
    before = A.bwd_launches["flat_attention_bwd_sm90"]
    grads = bwd(q, k, v, o, do, lse)
    refs = plain(q, k, v, o, do, lse)
    assert asked == ["flat_attention_bwd_sm90"]
    assert A.bwd_launches["flat_attention_bwd_sm90"] == before + 1
    scale = HD ** -0.5
    floors = (_floor(scale, HD, do, v, k), _floor(scale, HD, do, v, q), 0.0)
    for got, ref, x, floor in zip(grads, refs, (q, k, v), floors):
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        if layout != "flat":
            assert got.stride() == x.stride()
        assert torch.isfinite(got).all()
        assert _within(got, ref, torch.bfloat16, floor)


def test_sm90_backward_library_runs_hgmma(cuda):
    """The bf16 hd-64 backward is built on wgmma (HGMMA in its SASS) and
    fills its rings with asynchronous copies (LDGSTS, cp.async)."""
    sass = _native.sass("flat_attention_bwd_sm90")
    assert "HGMMA" in sass and "LDGSTS" in sass


# (N, B, H) for the Hopper fp32 hd-64 backward: N = 1 and the one-tile
# kernel at every last-tile width (16, 37, 63, 64); one past a tile (65);
# whole and ragged tiles of the two-kernel form (128, 320, 321, 384, 385,
# 768), where 321 and 385 leave one row in the last tile and an odd tile
# count (the last block's second warpgroup has none); the ViT-B/14 shapes
# (37, 257, 730). B * H from 4 to 192.
SM90_F32_BWD_SHAPES = [
    (1, 2, 2), (16, 2, 4), (37, 16, 12), (63, 2, 3), (64, 4, 4), (65, 3, 5),
    (128, 5, 2), (257, 16, 12), (320, 2, 6), (321, 2, 3), (384, 2, 3),
    (385, 2, 3), (730, 16, 12), (768, 2, 4),
]


@pytest.mark.parametrize("layout", ["flat", "bnhd", "bhnd"])
@pytest.mark.parametrize("N,B,H", SM90_F32_BWD_SHAPES)
def test_sm90_f32_backward_matches_plain(cuda, monkeypatch, layout, N, B, H):
    """fp32 at hd 64 runs flat_attention_bwd_f32_sm90 (K2 and K5), within
    the fp32 tolerances of the plain backward (with the dq/dk floor), and
    counts its launch; the gradients keep the inputs' layout."""
    gen = torch.Generator(device=cuda).manual_seed(N + B + H + 3)
    (q, k, v, do), (fwd, bwd, plain) = _bf16_backward(layout, B, N, H, gen,
                                                      torch.float32)
    o, lse = fwd(q, k, v)
    asked = []
    function = _native.function
    monkeypatch.setattr(_native, "function",
                        lambda name: asked.append(name) or function(name))
    before = A.bwd_launches["flat_attention_bwd_f32_sm90"]
    grads = bwd(q, k, v, o, do, lse)
    refs = plain(q, k, v, o, do, lse)
    assert asked == ["flat_attention_bwd_f32_sm90"]
    assert A.bwd_launches["flat_attention_bwd_f32_sm90"] == before + 1
    scale = HD ** -0.5
    floors = (_floor(scale, HD, do, v, k), _floor(scale, HD, do, v, q), 0.0)
    for got, ref, x, floor in zip(grads, refs, (q, k, v), floors):
        assert got.dtype == torch.float32 and got.shape == x.shape
        if layout != "flat":
            assert got.stride() == x.stride()
        assert torch.isfinite(got).all()
        assert _within(got, ref, torch.float32, floor)


def test_sm90_f32_backward_library_runs_hgmma(cuda):
    """The fp32 hd-64 backward is built on wgmma (HGMMA in its SASS), and
    ptxas serialized none of its products (no C751x warning) and spilled no
    register."""
    sass = _native.sass("flat_attention_bwd_f32_sm90")
    assert "HGMMA" in sass
    log = (_native.BUILD_DIR / "flat_attention_bwd_f32_sm90.log").read_text()
    assert not any(f"C751{i}" in log for i in range(10)), log
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
    assert spills and all(n == "0" for n in spills), log


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", ["flat", "bnhd", "bhnd"])
@pytest.mark.parametrize("N,B,H", HD16_SHAPES)
def test_sm90_backward_hd16_matches_plain(cuda, monkeypatch, dtype, layout,
                                          N, B, H):
    """At hd 16 both dtypes run their wgmma backward (K2 and K5, the kernel
    of csrc/attention_bwd_hd16.cuh): the one launch goes to
    flat_attention_bwd_sm90 (bf16) or flat_attention_bwd_f32_sm90 (fp32)
    and no other, within the dtype's tolerances of the plain backward (with
    the dq/dk floor); the gradients keep the inputs' layout."""
    dt = DTYPES[dtype]
    library = A.bwd_library(dt, 16)
    gen = torch.Generator(device=cuda).manual_seed(N + B + H + 5)
    (q, k, v, do), (fwd, bwd, plain) = _bf16_backward(layout, B, N, H, gen,
                                                      dt, hd=16)
    o, lse = fwd(q, k, v)
    asked = []
    function = _native.function
    monkeypatch.setattr(_native, "function",
                        lambda name: asked.append(name) or function(name))
    before = dict(A.bwd_launches)
    grads = bwd(q, k, v, o, do, lse)
    refs = plain(q, k, v, o, do, lse)
    assert asked == [library]
    assert A.bwd_launches == {**before, library: before[library] + 1}
    scale = 16 ** -0.5
    floors = (_floor(scale, 16, do, v, k), _floor(scale, 16, do, v, q), 0.0)
    for got, ref, x, floor in zip(grads, refs, (q, k, v), floors):
        assert got.dtype == dt and got.shape == x.shape
        if layout != "flat":
            assert got.stride() == x.stride()
        assert torch.isfinite(got).all()
        assert _within(got, ref, dt, floor)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("N,B", [(37, 16), (257, 8), (768, 1)])
def test_backward_hd16_is_deterministic(cuda, dtype, N, B):
    """Every dq, dk and dv element is written by one block, with no
    atomics: two calls on the same inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(N + B)
    (q, k, v, do), (fwd, bwd, _) = _bf16_backward("flat", B, N, 2, gen,
                                                  DTYPES[dtype], hd=16)
    o, lse = fwd(q, k, v)
    first, second = bwd(q, k, v, o, do, lse), bwd(q, k, v, o, do, lse)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(
    n for n in _native.LIBRARIES if n.startswith("flat_attention")))
def test_attention_libraries_run_wgmma_only(cuda, name):
    """Every attention library is built on wgmma (HGMMA in its SASS) and
    holds no warp-level mma.sync (HMMA)."""
    sass = _native.sass(name)
    assert "HGMMA" in sass and "HMMA" not in sass


@pytest.mark.parametrize("model", ["dinov3/vittest16", "dinov2/vittest14"])
def test_a_teacher_drawn_on_the_card_has_the_cpu_init(cuda, model):
    """A random distillation teacher is allocated on the card with
    ``to_empty`` and drawn leaf by leaf from the CPU generator: the same
    values, bitwise, as the module built and initialised on the CPU from
    the same seed."""
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    on_cpu = get_wrapped_model(model).module
    on_cpu.reset_parameters(torch.Generator().manual_seed(5))
    on_card = get_wrapped_model(model).module.to_empty(device=cuda)
    on_card.reset_parameters(torch.Generator().manual_seed(5))
    want = on_cpu.state_dict()
    for name, value in on_card.state_dict().items():
        assert value.is_cuda and torch.equal(value.cpu(), want[name]), name


def test_embed_on_the_card_runs_k1_and_matches_the_cpu(cuda, tmp_path):
    """``embed`` in fp32 under no grad: one K1 launch a block on the fp32
    wgmma forward, no K2, and the CPU path's embeddings (plain attention)
    within the fp32 path's 1e-2 relative L2 (a ViT-T/14, hd 64, on 4
    images at 224^2, padded to a batch of 8)."""
    import lightly_train_tpu_torch as lt
    from lightly_train_tpu_torch._checkpoint.checkpoint import export_model
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    model = get_wrapped_model("dinov2/vitt14").module
    model.reset_parameters(torch.Generator().manual_seed(0))
    export_model(tmp_path / "art", "dinov2/vitt14", model.state_dict())
    data = tmp_path / "images"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        img = rng.integers(0, 256, (240, 240, 3), dtype=np.uint8)
        (data / f"{i}.ppm").write_bytes(b"P6\n240 240\n255\n" + img.tobytes())
    kwargs = dict(data=str(data), checkpoint=str(tmp_path / "art"),
                  image_size=224, batch_size=8, precision="fp32")
    fwd, bwd = A.flat_attention_fwd.launches, A.flat_attention_bwd.launches
    by_lib = A.fwd_launches["flat_attention_fwd_f32_sm90"]
    got = np.load(lt.embed(out=str(tmp_path / "card.npz"), **kwargs))
    assert A.flat_attention_fwd.launches - fwd == 12
    assert A.fwd_launches["flat_attention_fwd_f32_sm90"] - by_lib == 12
    assert A.flat_attention_bwd.launches == bwd
    ref = np.load(lt.embed(out=str(tmp_path / "cpu.npz"), accelerator="cpu",
                           **kwargs))
    g, r = got["embeddings"], ref["embeddings"]
    assert g.shape == r.shape == (4, 192) and np.isfinite(g).all()
    assert np.linalg.norm(g - r) <= 1e-2 * np.linalg.norm(r)


@pytest.mark.parametrize("policy", [None, "dots_saveable"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_checkpointed_block_recomputes_k1(cuda, dtype, policy):
    """A ViT block (width 128, 2 heads of 64, drop path 0.2) under
    activation checkpointing: K1 runs again in the backward pass (no policy
    keeps the attention kernels' outputs, which are no matrix product), K2
    once, and the gradients and the generator's next draw are bitwise those
    of the block without checkpointing."""
    from lightly_train_tpu_torch.models import vit as TV

    cfg = TV.ViTConfig(embed_dim=128, depth=1, num_heads=2,
                       drop_path_rate=0.2, dtype=DTYPES[dtype])
    block = TV.Block(cfg, drop_path=0.2)
    init = torch.Generator().manual_seed(0)
    for p in block.parameters():
        p.data.normal_(0.0, 0.1, generator=init)
    block = block.to(cuda)
    x0 = torch.randn((16, 257, 128), generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda)
    runs = []
    for remat in (False, True):
        gen = torch.Generator(device=cuda).manual_seed(11)
        x = x0.to(DTYPES[dtype]).requires_grad_()
        for p in block.parameters():
            p.grad = None
        before = A.flat_attention_fwd.launches, A.flat_attention_bwd.launches
        if remat:
            out = TV.checkpointed_block(block, x, True, gen, None,
                                        TV.REMAT_POLICIES[policy])
        else:
            out = block(x, True, gen)
        after_fwd = A.flat_attention_fwd.launches
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        runs.append({
            "fwd": (after_fwd - before[0],
                    A.flat_attention_fwd.launches - before[0]),
            "bwd": A.flat_attention_bwd.launches - before[1],
            "grads": [x.grad] + [p.grad for p in block.parameters()],
            "next": torch.rand(4, generator=gen, device=cuda)})
    plain, remat = runs
    assert plain["fwd"] == (1, 1) and remat["fwd"] == (1, 2)
    assert plain["bwd"] == remat["bwd"] == 1
    assert all(torch.equal(a, b) for a, b in zip(plain["grads"],
                                                 remat["grads"]))
    assert torch.equal(plain["next"], remat["next"])
