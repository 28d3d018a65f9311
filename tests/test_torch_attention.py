"""The port's attention against the JAX package's Pallas kernels.

The same numpy inputs go through the JAX functions with ``interpret=True``
(the Pallas kernels run by the interpreter on the CPU) and their
``jax.vjp``, and through the port's functions on CPU tensors, which run the
plain PyTorch versions of the CUDA kernels, forward and autograd backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.ops import pallas as jax_pallas
from lightly_train_tpu.ops.pallas import attention as JA
from lightly_train_tpu.ops.pallas.attention import (
    flat_attention as jax_flat_attention,
)
from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch.ops import kernels as port_kernels
from lightly_train_tpu_torch.ops.kernels import attention as A
from torch_fixtures.threads import one_torch_thread  # noqa: F401

H, HD = 2, 64
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, N, seed, hd=HD):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, H * hd)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("B,N,dtype", [
    *(pytest.param(B, N, "fp32", id=f"{B}-{N}") for B, N in
      [(1, 37), (1, 50), (1, 257), (2, 17), (1, 730), (1, 768)]),
    # bf16: what the Hopper wgmma kernels serve at hd 64, and what the card
    # tests hold them against (the ViT-B/14 shapes and N = 730).
    *(pytest.param(1, N, "bf16", id=f"bf16-1-{N}") for N in (37, 257, 730)),
])
def test_plain_matches_pallas_interpret(B, N, dtype):
    _check_against_pallas(B, N, dtype, HD, seed=N)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,N", [(2, 257), (4, 37), (1, 64), (1, 65)])
def test_plain_matches_pallas_interpret_hd16(B, N, dtype):
    """Head dim 16 (the vittest ViTs: width 32, 2 heads), which the Hopper
    forward of each dtype takes since it left mma.sync: the vittest14
    global (257) and local (37) token counts, and 64 / 65, the one-tile /
    two-tile edge of that kernel, which the card tests hold it to."""
    _check_against_pallas(B, N, dtype, 16, seed=N + 16)


def _check_against_pallas(B, N, dtype, hd, seed):
    """flat_attention forward and autograd backward against the JAX
    ``flat_attention`` in interpret mode and its ``jax.vjp``, H heads of
    ``hd``."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, co = _inputs(B, N, seed, hd)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_flat_attention(a, b, c, H, interpret=True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
    )
    grads_j = vjp(jnp.asarray(co, jdt))

    qt, kt, vt = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    out_t = A.flat_attention(qt, kt, vt, H)
    out_t.backward(torch.tensor(co).to(tdt))

    # Both round p (and ds) to bf16 at the same places; the fp32 sums are
    # taken in other orders, so a value near a bf16 rounding boundary can
    # round the other way: a few bf16 ulps (2^-8 relative) of slack. bf16
    # outputs are rounded to bf16 on both sides as well, which the same
    # bounds cover (one bf16 ulp is 2^-8 of the value).
    assert out_t.dtype == tdt and all(
        x.grad.dtype == tdt for x in (qt, kt, vt))
    np.testing.assert_allclose(out_t.detach().float().numpy(),
                               np.asarray(out_j, np.float32),
                               rtol=1e-2, atol=1e-2)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=2e-2)


def test_lse_matches_pallas_forward():
    from lightly_train_tpu.ops.pallas.attention import _flat_fwd_impl

    q, k, v, _ = _inputs(2, 37, seed=1)
    o_j, lse_j = _flat_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), H, HD ** -0.5, True)
    o_t, lse_t = A.flat_attention_fwd_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), H, HD ** -0.5)
    # lse is fp32 throughout, taken from the same bf16-rounded p.
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-2,
                               atol=1e-2)


def _assert_close(got: torch.Tensor, ref, dtype: str, what: str):
    """fp32 outputs within 2e-3: the two sides round p and ds to bf16 at
    the same places, but take the fp32 sums in other orders, so a value
    near a rounding boundary may round the other way (one bf16 ulp of one
    p moves an O(1) output by ~2^-8 / N). bf16 outputs add their own
    rounding: within 1e-2, about two bf16 ulps of an O(1) output."""
    tol = {"fp32": 2e-3, "bf16": 1e-2}[dtype]
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 17, 3, 8), (4, 33, 2, 16),
                                   (1, 257, 2, 64)])
def test_vmem_attention_matches_pallas_interpret(shape, dtype):
    """K4/K5 through the (B, N, H, hd) API, fp32 and bf16 inputs."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    q, k, v, co = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_pallas.vmem_attention(a, b, c, interpret=True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
    )
    grads_j = vjp(jnp.asarray(co, jdt))

    qt, kt, vt = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    out_t = port_kernels.vmem_attention(qt, kt, vt)
    out_t.backward(torch.tensor(co).to(tdt))

    assert out_t.dtype == tdt and out_t.shape == shape
    assert out_j.dtype == jdt and all(g.dtype == jdt for g in grads_j)
    _assert_close(out_t, out_j, dtype, "o")
    for name, got, ref in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad),
                              grads_j):
        assert got.dtype == tdt
        _assert_close(got, ref, dtype, name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vmem_attention_bhnd_matches_pallas_interpret(dtype):
    """K4/K5 over (B, H, N, hd) against the JAX custom VJP."""
    jdt, tdt = DTYPES[dtype]
    shape, scale = (2, 3, 17, 8), 8 ** -0.5
    rng = np.random.default_rng(5)
    q, k, v, co = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    out_j, vjp = jax.vjp(
        lambda a, b, c: JA._vmem_attention_bhnd(a, b, c, scale, True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
    )
    grads_j = vjp(jnp.asarray(co, jdt))
    qt, kt, vt = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    out_t = A.vmem_attention_bhnd(qt, kt, vt)
    out_t.backward(torch.tensor(co).to(tdt))
    _assert_close(out_t, out_j, dtype, "o")
    for name, got, ref in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad),
                              grads_j):
        _assert_close(got, ref, dtype, name)


def test_vmem_lse_matches_pallas_forward():
    q, k, v = (np.random.default_rng(i).standard_normal((2, 3, 17, 16))
               .astype(np.float32) for i in range(3))
    _, lse_j = JA._attn_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), 0.25, True)
    _, lse_t = A.vmem_attention_fwd_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), 0.25)
    # fp32 from the same bf16-rounded p.
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-4)


def test_layouts_agree():
    """vmem_attention on (B, N, H, hd) is flat_attention on the same
    tensor read as (B, N, H * hd), bit for bit (the JAX kernels agree the
    same way)."""
    rng = np.random.default_rng(3)
    q, k, v, co = (torch.tensor(rng.standard_normal((2, 37, 2, 16)),
                                dtype=torch.float32) for _ in range(4))
    qa, ka, va = (x.clone().requires_grad_() for x in (q, k, v))
    qb, kb, vb = (x.flatten(2).clone().requires_grad_() for x in (q, k, v))
    out_a = port_kernels.vmem_attention(qa, ka, va)
    out_b = port_kernels.flat_attention(qb, kb, vb, 2)
    (out_a * co).sum().backward()
    (out_b * co.flatten(2)).sum().backward()
    torch.testing.assert_close(out_a.flatten(2), out_b, rtol=0, atol=0)
    for a, b in zip((qa, ka, va), (qb, kb, vb)):
        torch.testing.assert_close(a.grad.flatten(2), b.grad, rtol=0, atol=0)


def test_fits_vmem_matches_jax():
    got = [A.fits_vmem(n) for n in range(1, 2049)]
    assert got == [JA.fits_vmem(n) for n in range(1, 2049)]
    assert got.index(False) == 768  # holds exactly for N <= 768


@pytest.mark.parametrize("value,expected", [
    (None, True), ("1", True), ("force", True), ("0", False),
    ("false", False), ("False", False),
])
def test_use_vmem_attention_follows_the_variable(monkeypatch, value,
                                                 expected):
    """On the card (here: PyTorch made to see one) the gate follows
    LIGHTLY_TRAIN_VMEM_ATTENTION with the JAX default "1"; a CPU tensor
    never takes the kernels."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    if value is None:
        monkeypatch.delenv("LIGHTLY_TRAIN_VMEM_ATTENTION", raising=False)
    else:
        monkeypatch.setenv("LIGHTLY_TRAIN_VMEM_ATTENTION", value)
    assert A.use_vmem_attention() is expected
    assert not A.use_vmem_attention(torch.zeros(1))


def test_exports_match_the_jax_package():
    assert port_kernels.__all__ == jax_pallas.__all__


def test_gate_runs_plain_attention_on_cpu_and_for_masks():
    """On CPU tensors and for masked attention the ViT's attention is the
    plain path, as the JAX ViT uses XLA attention off the TPU."""
    q, k, v, _ = _inputs(1, 17, seed=3)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    ref = A.dot_product_attention(qt, kt, vt, H)
    before = A.flat_attention_fwd.launches
    torch.testing.assert_close(A.attention(qt, kt, vt, H), ref)
    mask = torch.ones(1, 1, 17, 17, dtype=torch.bool)
    torch.testing.assert_close(A.attention(qt, kt, vt, H, mask), ref)
    assert A.flat_attention_fwd.launches == before
    out_j = jax.nn.dot_product_attention(
        jnp.asarray(q).reshape(1, 17, H, HD), jnp.asarray(k).reshape(1, 17, H, HD),
        jnp.asarray(v).reshape(1, 17, H, HD),
    ).reshape(1, 17, H * HD)
    np.testing.assert_allclose(ref.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)


def test_kernel_support_range():
    """The JAX gate's range (fits_vmem: N <= 768) and the head dims of the
    port's ViT sizes (64, 16 for vittest, and 128 for the 7B ViTs), in both
    directions."""
    for direction in ("fwd", "bwd"):
        for n in (1, 37, 201, 257, 512, 577, 730, 768):
            assert A.kernel_supports(n, 64, direction)
            assert A.kernel_supports(n, 16, direction)
            assert A.kernel_supports(n, 128, direction)
        assert not A.kernel_supports(769, 64, direction)
        assert not A.kernel_supports(769, 128, direction)
        assert not A.kernel_supports(0, 64, direction)
        assert not A.kernel_supports(257, 32, direction)


@pytest.mark.parametrize("dtype,head_dim,library", [
    (torch.bfloat16, 64, "flat_attention_fwd_sm90"),
    (torch.float32, 64, "flat_attention_fwd_f32_sm90"),
    (torch.bfloat16, 16, "flat_attention_fwd_sm90"),
    (torch.float32, 16, "flat_attention_fwd_f32_sm90"),
    (torch.bfloat16, 128, "flat_attention_fwd_sm90"),
    (torch.float32, 128, "flat_attention_fwd_f32_sm90"),
])
def test_forward_route(dtype, head_dim, library):
    """At every head dim each dtype runs its own wgmma forward (hd 16
    through the kernel of csrc/attention_fwd_hd16.cuh, hd 128 through that
    of csrc/attention_fwd_hd128_resident.cuh at 64 < N <= 304 and a
    positive scale, in both dtypes, else that of
    csrc/attention_fwd_hd128.cuh); each route's library is one the port
    builds."""
    assert A.fwd_library(dtype, head_dim) == library
    assert library in A.fwd_launches
    assert library in _native.LIBRARIES


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("n_tokens,source", [
    (1, "attention_fwd_hd128.cuh"), (37, "attention_fwd_hd128.cuh"),
    (64, "attention_fwd_hd128.cuh"),
    (65, "attention_fwd_hd128_resident.cuh"),
    (201, "attention_fwd_hd128_resident.cuh"),
    (257, "attention_fwd_hd128_resident.cuh"),
    (304, "attention_fwd_hd128_resident.cuh"),
    (305, "attention_fwd_hd128.cuh"), (730, "attention_fwd_hd128.cuh"),
    (768, "attention_fwd_hd128.cuh"),
])
def test_chip_smoke_names_the_hd128_forward_source(dtype, n_tokens, source):
    """chip_smoke.py's kernels line names, for the hd-128 forward, the
    source whose kernel the C entries launch at that N (the resident one
    for 64 < N <= 304 in both dtypes), and for the backward the header of
    the bf16 library's two TMA-fed kernels (every N) or of the fp32
    library's three role kernels."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_routes", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
    assert smoke.kernel_source("fwd", dtype, 128, n_tokens,
                               A.fwd_library(dt, 128)) == source
    assert smoke.kernel_source("bwd", dtype, 128, n_tokens,
                               A.bwd_library(dt, 128)) == (
        "attention_bwd_hd128_tma.cuh" if dtype == "bf16"
        else "attention_bwd_hd128.cuh")


def test_chip_smoke_exact_backward_matches_float64_autograd():
    """chip_smoke.py's ``exact_attention_bwd`` (phase 3l's "exact_backward":
    K2's function with p and ds left unrounded, in fp32, a head at a time)
    against autograd through float64 softmax attention at (2, 65, 2, 128),
    fed fp32 copies of the same inputs and of the float64 forward's o and
    lse: within 1e-5 relative L2, a few fp32 roundings of sums over 65 keys
    and 128 columns."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_exact", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    B, N, H, hd = 2, 65, 2, 128
    scale = hd ** -0.5
    rng = np.random.default_rng(65)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, N, H * hd)))
                   for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    qh, kh, vh = (x.view(B, N, H, hd).transpose(1, 2) for x in leaves)
    s = qh @ kh.transpose(-1, -2) * scale
    o = (torch.softmax(s, -1) @ vh).transpose(1, 2).reshape(B, N, H * hd)
    lse = torch.logsumexp(s, -1)
    refs = torch.autograd.grad(o, leaves, do)
    got = smoke.exact_attention_bwd(
        *(x.detach().float() for x in (q, k, v, o, do, lse)), H, scale)
    for g, r in zip(got, refs):
        assert g.dtype == torch.float32 and g.shape == r.shape
        assert ((g.double() - r).norm() / r.norm()).item() < 1e-5


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_forward_route_refuses_other_dtypes(dtype):
    for head_dim in (16, 64, 128):
        with pytest.raises(ValueError, match="bf16 or fp32"):
            A.fwd_library(dtype, head_dim)
    with pytest.raises(ValueError, match="head dim"):
        A.fwd_library(torch.bfloat16, 32)


@pytest.mark.parametrize("dtype,head_dim,library", [
    (torch.bfloat16, 64, "flat_attention_bwd_sm90"),
    (torch.float32, 64, "flat_attention_bwd_f32_sm90"),
    (torch.bfloat16, 16, "flat_attention_bwd_sm90"),
    (torch.float32, 16, "flat_attention_bwd_f32_sm90"),
    (torch.bfloat16, 128, "flat_attention_bwd_sm90"),
    (torch.float32, 128, "flat_attention_bwd_f32_sm90"),
])
def test_backward_route(dtype, head_dim, library):
    """At every head dim each dtype runs its own wgmma backward (hd 16
    through the kernel of csrc/attention_bwd_hd16.cuh, hd 128 through those
    of csrc/attention_bwd_hd128.cuh); each route's library is one the port
    builds."""
    assert A.bwd_library(dtype, head_dim) == library
    assert library in A.bwd_launches
    assert library in _native.LIBRARIES


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_backward_route_refuses_other_dtypes(dtype):
    """Other dtypes and head dims raise ValueError, as in the forward."""
    for head_dim in (16, 64, 128):
        with pytest.raises(ValueError, match="bf16 or fp32"):
            A.bwd_library(dtype, head_dim)
    for head_dim in (32, 96, 256):
        with pytest.raises(ValueError, match="head dim"):
            A.bwd_library(torch.bfloat16, head_dim)


def _planes(x: torch.Tensor):
    """hi = bf16_rn(x), lo = bf16_rn(x - hi), as fp32 tensors."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _hilo_backward(q, k, v, o, do, lse, scale, s_chains):
    """K5 in fp32 with exactly the chains of the Hopper fp32 backward
    (``csrc/flat_attention_bwd_f32_sm90.cu``): fp32 operands as bf16 hi/lo
    planes, every product of bf16 values summed in fp32. ``s_chains``: the
    products that form q . k^T, of "hh", "hl" (q_hi . k_lo^T) and "lh"."""
    (q_hi, q_lo), (k_hi, k_lo), (v_hi, v_lo) = (_planes(x) for x in (q, k, v))
    mm = torch.matmul
    pairs = {"hh": (q_hi, k_hi), "hl": (q_hi, k_lo), "lh": (q_lo, k_hi)}
    s = sum(mm(a, b.transpose(-1, -2)) for a, b in
            (pairs[c] for c in s_chains)) * scale
    p = torch.exp(s - lse[..., None])
    do16 = do.to(torch.bfloat16).float()
    dv = mm(p.to(torch.bfloat16).float().transpose(-1, -2), do16)
    dp = mm(do16, v_hi.transpose(-1, -2)) + mm(do16, v_lo.transpose(-1, -2))
    delta = (do * o).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(torch.bfloat16).float()
    dq = mm(ds, k_hi) + mm(ds, k_lo)
    dst = ds.transpose(-1, -2)
    dk = mm(dst, q_hi) + mm(dst, q_lo)
    return dq, dk, dv


def _within_fp32(got, ref, floor):
    """The card's fp32 tolerance (tests/test_torch_kernels_cuda.py, the
    kernels against their plain versions): within 2^-7 of the reference's
    largest magnitude plus 8 ``floor``, and 1e-3 relative L2 plus ``floor``
    per element."""
    diff = got - ref
    return (diff.abs().max().item()
            <= 2.0 ** -7 * ref.abs().max().item() + 8 * floor
            and diff.norm().item() <= (1e-3 * ref.norm().item()
                                       + floor * diff.numel() ** 0.5))


@pytest.mark.parametrize("N,s_chains", [
    (1, ("hh", "hl", "lh")), (37, ("hh", "hl", "lh")),
    (257, ("hh", "hl", "lh")),
    # Control: s from hi . hi alone must fail the tolerance, or it cannot
    # tell the kernel's three chains from fewer.
    (37, ("hh",)), (257, ("hh",)),
])
def test_fp32_hilo_chains_meet_the_fp32_tolerance(N, s_chains):
    """The chain set of the fp32 wgmma backward (3 chains for q . k, 2 for
    do . v, 1 for dv, 2 each for dq and dk), emulated on the CPU, gives dq,
    dk and dv within the card's fp32 tolerance of the plain backward, with
    the dq/dk floor of one 2^-16 rounding of dp; s from hi . hi alone does
    not."""
    B, H, hd = 2, 3, 64
    scale = hd ** -0.5
    rng = np.random.default_rng(N)
    q, k, v, do = (torch.tensor(rng.standard_normal((B, H, N, hd)),
                                dtype=torch.float32) for _ in range(4))
    o, lse = A.vmem_attention_fwd_plain(q, k, v, scale)
    refs = A.vmem_attention_bwd_plain(q, k, v, o, do, lse, scale)
    got = _hilo_backward(q, k, v, o, do, lse, scale, s_chains)
    rms = [x.pow(2).mean().sqrt().item() for x in (do, v, k, q)]
    dp_floor = 2.0 ** -16 * scale * hd ** 0.5 * rms[0] * rms[1]
    floors = (dp_floor * rms[2], dp_floor * rms[3], 0.0)
    within = [_within_fp32(a, b, f) for a, b, f in zip(got, refs, floors)]
    assert all(within) == (len(s_chains) == 3), within
