"""Multi-head self-attention kernels: flat and per-head layouts.

Port of ``lightly_train_tpu/ops/pallas/attention.py``. The CUDA forward
and backward serve all four TPU kernels (see :func:`fwd_library` and
:func:`bwd_library`), all on Hopper's ``wgmma`` at every head dim they
take, each dtype on its own sources (``csrc/flat_attention_fwd_sm90.cu``
and ``csrc/flat_attention_bwd_sm90.cu`` in bf16,
``csrc/flat_attention_fwd_f32_sm90.cu`` and
``csrc/flat_attention_bwd_f32_sm90.cu`` in fp32; at head dim 16 the
forwards launch the kernel of ``csrc/attention_fwd_hd16.cuh`` and the
backwards that of ``csrc/attention_bwd_hd16.cuh``, at head dim 128 the
forwards that of ``csrc/attention_fwd_hd128_resident.cuh`` for 64 < N <=
304 and a positive scale, that of ``csrc/attention_fwd_hd128.cuh``
otherwise (the C entries' choice, in both dtypes), and the backwards those
of ``csrc/attention_bwd_hd128.cuh``).
The four TPU kernels
do the same arithmetic and differ only in how a head is addressed:

- K1/K2 (``_flat_fwd_kernel`` / ``_flat_bwd_kernel``): :func:`flat_attention`
  over flat ``(B, N, H * hd)`` projections, autograd :class:`FlatAttention`;
- K4/K5 (``_fwd_kernel`` / ``_bwd_kernel``): :func:`vmem_attention` over
  ``(B, N, H, hd)`` and :func:`vmem_attention_bhnd` over ``(B, H, N, hd)``,
  autograd :class:`VmemAttention` (the custom VJP ``_vmem_attention_bhnd``).

Each forward saves ``(q, k, v, o, lse)`` and each backward recomputes the
probabilities from ``lse``, as the JAX custom VJPs do. The kernels read every
layout in place through strides (no transpose, no copy).

What the kernels take, as the TPU kernels do: bf16 or fp32 q/k/v of one
dtype (o, dq, dk, dv take it; lse stays fp32), N with :func:`fits_vmem`
(N <= 768) and the head dims of :data:`HEAD_DIMS`: 16, 64 and 128 in both
directions (every ViT size the port has). A CUDA tensor of any other dtype,
mixed dtypes, another head dim or N, or strides the kernels cannot read
raise; they never fall back to a plain version.

Which path the ViT's :func:`attention` runs is the JAX ViT's gate: the
kernels for unmasked attention on a CUDA tensor when :func:`fits_vmem`
holds; otherwise the plain :func:`dot_product_attention`, the counterpart
of ``jax.nn.dot_product_attention``: for masks, for N > 768, and for CPU
tensors. ``LIGHTLY_TRAIN_VMEM_ATTENTION=0`` (the JAX switch to its portable
path) has no plain counterpart on the card: there :func:`attention` raises.

For CPU tensors the kernel wrappers run their plain versions
(:func:`vmem_attention_fwd_plain`, :func:`vmem_attention_bwd_plain` and the
flat ones built on them), which repeat the kernels' arithmetic (p rounded to
bf16 before p . v, l summed in fp32 from the rounded p, fp32 lse, do and ds
rounded to bf16) and serve as their reference.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch._env import Env

# Head dims the kernels take, by direction.
HEAD_DIMS = {"fwd": (16, 64, 128), "bwd": (16, 64, 128)}
DTYPES = (torch.bfloat16, torch.float32)
# The JAX package's VMEM budget; fits_vmem(N) holds exactly for N <= 768.
_VMEM_BUDGET_BYTES = 10 * 1024 * 1024

Tensors3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fits_vmem(n_tokens: int) -> bool:
    """The JAX gate on N: whole-sequence fp32 scores within its budget."""
    scratch = 3 * n_tokens * ((n_tokens + 383) // 384) * 384 * 4
    return scratch <= _VMEM_BUDGET_BYTES


def kernel_supports(n_tokens: int, head_dim: int, direction: str) -> bool:
    """Whether the CUDA kernels of ``direction`` ("fwd" or "bwd") take this
    sequence length and head dim."""
    return (n_tokens >= 1 and fits_vmem(n_tokens)
            and head_dim in HEAD_DIMS[direction])


def use_vmem_attention(x: Optional[torch.Tensor] = None) -> bool:
    """Kernel gate: for a CUDA tensor ``x`` (without one: when PyTorch sees a
    card), unless LIGHTLY_TRAIN_VMEM_ATTENTION is ``0``/``false``/``False``.
    The port runs one card, so ``force`` means the same as ``1``."""
    if Env.LIGHTLY_TRAIN_VMEM_ATTENTION.value in ("0", "false", "False"):
        return False
    return x.is_cuda if x is not None else torch.cuda.is_available()


# ---------------------------------------------------------------------------
# Plain versions (CPU tensors, tests, and the card's reference)
# ---------------------------------------------------------------------------


def vmem_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 over (B, H, N, hd): (o, lse (B, H, N))."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(torch.bfloat16).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vf) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def vmem_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, scale: float,
) -> Tensors3:
    """Plain PyTorch version of K5 over (B, H, N, hd): (dq, dk, dv)."""
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    do16 = dof.to(torch.bfloat16).float()
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), do16)
    dp = torch.matmul(do16, vf.transpose(-1, -2))
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(torch.bfloat16).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return tuple(x.to(q.dtype) for x in (dq, dk, dv))


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H * hd) as a (B, H, N, hd) view."""
    return x.unflatten(-1, (num_heads, -1)).transpose(1, 2)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, hd) as (B, N, H * hd)."""
    return x.transpose(1, 2).flatten(2)


def flat_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: returns (o (B, N, D), lse (B, H, N))."""
    o, lse = vmem_attention_fwd_plain(
        *(_heads(x, num_heads) for x in (q, k, v)), scale)
    return _flat(o), lse


def flat_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, num_heads: int, scale: float,
) -> Tensors3:
    """Plain PyTorch version of K2: returns (dq, dk, dv), each (B, N, D)."""
    grads = vmem_attention_bwd_plain(
        *(_heads(x, num_heads) for x in (q, k, v, o, do)), lse, scale)
    return tuple(_flat(x) for x in grads)


# ---------------------------------------------------------------------------
# Kernel launches. The kernels see every tensor as (B, H, N, hd) through its
# strides: a per-head tensor as it is (num_heads None), a flat (B, N, H * hd)
# one through strides computed here (no view is built: the launch's host
# time is what a step bound by Python waits on).
# ---------------------------------------------------------------------------


def _per_head(x: torch.Tensor, num_heads: Optional[int]):
    """(B, H, N, hd) shape and strides of ``x``."""
    if num_heads is None:
        return tuple(x.shape), x.stride()
    B, N, D = x.shape
    s0, s1, s2 = x.stride()
    hd = D // num_heads
    return (B, num_heads, N, hd), (s0, hd * s2, s1, s2)


def _kernel_readable(x: torch.Tensor, strides) -> bool:
    """16-byte vector loads: unit column stride, the other strides in
    multiples of 16 bytes, and a 16-byte aligned base."""
    vec = 16 // x.element_size()
    return (strides[3] == 1 and x.data_ptr() % 16 == 0
            and strides[0] % vec == 0 and strides[1] % vec == 0
            and strides[2] % vec == 0)


def _check_kernel_inputs(name: str, tensors, num_heads: Optional[int],
                         direction: str):
    """The (B, H, N, hd) shape and each tensor's strides; raises on what
    the kernels do not take."""
    ref = tensors[0]
    if num_heads is not None and ref.shape[-1] % num_heads:
        raise ValueError(f"{name}: {num_heads} heads do not divide "
                         f"D={ref.shape[-1]}")
    strides = []
    for x in tensors:
        if not x.is_cuda or x.device != ref.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if x.dtype not in DTYPES or x.dtype != ref.dtype:
            raise ValueError(f"{name}: the kernels take bf16 or fp32 of one "
                             f"dtype, got {x.dtype} and {ref.dtype}")
        if x.shape != ref.shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                             f"{tuple(ref.shape)}")
        shape, st = _per_head(x, num_heads)
        if not _kernel_readable(x, st):
            raise ValueError(
                f"{name}: the kernels need unit column stride, strides in "
                f"multiples of 16 bytes and a 16-byte aligned base; got "
                f"strides {x.stride()}"
            )
        strides.append(st)
    B, H, N, hd = shape
    if not kernel_supports(N, hd, direction):
        raise ValueError(f"{name}: the kernels take head dim "
                         f"{HEAD_DIMS[direction]} and 1 <= N <= 768; got "
                         f"N={N}, hd={hd}")
    return shape, strides


def _c_strides(strides):
    """(batch, token, head) of each (B, H, N, hd) stride tuple, for C."""
    flat = [s for st in strides for s in (st[0], st[2], st[1])]
    return (ctypes.c_int64 * len(flat))(*flat)


def _check_lse(name: str, lse: torch.Tensor, shape, ref: torch.Tensor):
    B, H, N, _ = shape
    if (lse.shape != (B, H, N) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != ref.device):
        raise ValueError(f"{name}: lse must be contiguous fp32 (B, H, N) on "
                         "the inputs' device")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# Launches of each forward and backward library (K1 and K4, K2 and K5
# together), so that a run can show which kernels it went through, and of
# each library at each (B, N, H, hd) shape.
fwd_launches = {"flat_attention_fwd_sm90": 0,
                "flat_attention_fwd_f32_sm90": 0}
bwd_launches = {"flat_attention_bwd_sm90": 0,
                "flat_attention_bwd_f32_sm90": 0}
shape_launches: collections.Counter = collections.Counter()


def _check_route(dtype: torch.dtype, head_dim: int, direction: str) -> None:
    """Raises ValueError for a dtype or head dim that no library of
    ``direction`` takes."""
    if dtype not in DTYPES:
        raise ValueError(f"the kernels take bf16 or fp32, got {dtype}")
    if head_dim not in HEAD_DIMS[direction]:
        raise ValueError(f"the kernels take head dim {HEAD_DIMS[direction]}"
                         f", got {head_dim}")


def fwd_library(dtype: torch.dtype, head_dim: int) -> str:
    """The library whose forward kernel serves ``dtype`` at ``head_dim``:
    ``flat_attention_fwd_sm90`` (bf16) or ``flat_attention_fwd_f32_sm90``
    (fp32), both wgmma at every head dim the forward takes (16, 64, 128)."""
    _check_route(dtype, head_dim, "fwd")
    return ("flat_attention_fwd_sm90" if dtype == torch.bfloat16
            else "flat_attention_fwd_f32_sm90")


def bwd_library(dtype: torch.dtype, head_dim: int) -> str:
    """The library whose backward kernels serve ``dtype`` at ``head_dim``:
    ``flat_attention_bwd_sm90`` (bf16) or ``flat_attention_bwd_f32_sm90``
    (fp32), both wgmma at every head dim the backward takes (16, 64,
    128)."""
    _check_route(dtype, head_dim, "bwd")
    return ("flat_attention_bwd_sm90" if dtype == torch.bfloat16
            else "flat_attention_bwd_f32_sm90")


def _launch_fwd(name, q, k, v, o, lse, scale, num_heads=None):
    shape, strides = _check_kernel_inputs(name, (q, k, v, o), num_heads,
                                          "fwd")
    _check_lse(name, lse, shape, q)
    B, H, N, hd = shape
    library = fwd_library(q.dtype, hd)
    err = _native.function(library)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), int(q.dtype == torch.float32), B, N, H, hd,
        _c_strides(strides), float(scale), _stream(q),
    )
    _native.check(err, name)
    fwd_launches[library] += 1
    shape_launches[library, shape] += 1


def _launch_bwd(name, q, k, v, o, do, lse, dq, dk, dv, scale,
                num_heads=None):
    shape, strides = _check_kernel_inputs(
        name, (q, k, v, o, do, dq, dk, dv), num_heads, "bwd")
    _check_lse(name, lse, shape, q)
    B, H, N, hd = shape
    library = bwd_library(q.dtype, hd)
    # The scratch of the hd-64 and hd-128 kernels: delta, from the dq
    # kernel (hd 64) or role (hd 128) to the one that forms dk.
    delta = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    err = _native.function(library)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), int(q.dtype == torch.float32),
        B, N, H, hd, _c_strides(strides), float(scale), _stream(q),
    )
    _native.check(err, name)
    bwd_launches[library] += 1
    shape_launches[library, shape] += 1


def _readable_grad(do: torch.Tensor, num_heads: Optional[int]):
    """The incoming gradient as it is when the kernels can read it, else a
    dense copy (autograd may hand over an expanded or odd-strided one)."""
    if do.is_cuda and not _kernel_readable(do, _per_head(do, num_heads)[1]):
        return do.contiguous()
    return do


# ---------------------------------------------------------------------------
# K1/K2: flat (B, N, H * hd)
# ---------------------------------------------------------------------------


def flat_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (o, lse). Launches the CUDA kernel for CUDA tensors (or raises),
    runs the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flat_attention_fwd_plain(q, k, v, num_heads, scale)
    B, N, D = q.shape
    o = torch.empty((B, N, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, num_heads, N), dtype=torch.float32, device=q.device)
    _launch_fwd("flat_attention_fwd", q, k, v, o, lse, scale, num_heads)
    flat_attention_fwd.launches += 1
    return o, lse


flat_attention_fwd.launches = 0


def flat_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, num_heads: int, scale: float,
) -> Tensors3:
    """K2: (dq, dk, dv). Launches the CUDA kernels for CUDA tensors (or
    raises), runs the plain version for CPU tensors. One call counts as one
    launch of K2."""
    if q.device.type == "cpu":
        return flat_attention_bwd_plain(q, k, v, o, do, lse, num_heads, scale)
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device)
                  for _ in range(3))
    _launch_bwd("flat_attention_bwd", q, k, v, o, do, lse, *grads, scale,
                num_heads)
    flat_attention_bwd.launches += 1
    return grads


flat_attention_bwd.launches = 0


class FlatAttention(torch.autograd.Function):
    """Autograd around K1/K2, saving ``lse`` as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, scale: float):
        o, lse = flat_attention_fwd(q, k, v, num_heads, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads = num_heads
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _readable_grad(do, ctx.num_heads)
        dq, dk, dv = flat_attention_bwd(
            q, k, v, o, do, lse, ctx.num_heads, ctx.scale
        )
        return dq, dk, dv, None, None


def flat_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unmasked self-attention over flat (B, N, D) q/k/v, D = heads * hd."""
    if scale is None:
        scale = (q.shape[-1] // num_heads) ** -0.5
    return FlatAttention.apply(q, k, v, num_heads, float(scale))


# ---------------------------------------------------------------------------
# K4/K5: per head (B, H, N, hd), and the (B, N, H, hd) API over it
# ---------------------------------------------------------------------------


def vmem_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over (B, H, N, hd) tensors of any readable strides: (o, lse), o in
    q's layout. Launches the CUDA kernel for CUDA tensors (or raises), runs
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return vmem_attention_fwd_plain(q, k, v, scale)
    B, H, N, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    _launch_fwd("vmem_attention_fwd", q, k, v, o, lse, scale)
    vmem_attention_fwd.launches += 1
    return o, lse


vmem_attention_fwd.launches = 0


def vmem_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, scale: float,
) -> Tensors3:
    """K5 over (B, H, N, hd): (dq, dk, dv), each in its input's layout.
    Launches the CUDA kernels for CUDA tensors (or raises), runs the plain
    version for CPU tensors. One call counts as one launch of K5."""
    if q.device.type == "cpu":
        return vmem_attention_bwd_plain(q, k, v, o, do, lse, scale)
    grads = tuple(torch.empty_like(x) for x in (q, k, v))
    _launch_bwd("vmem_attention_bwd", q, k, v, o, do, lse, *grads, scale)
    vmem_attention_bwd.launches += 1
    return grads


vmem_attention_bwd.launches = 0


class VmemAttention(torch.autograd.Function):
    """Autograd around K4/K5 over (B, H, N, hd): the counterpart of the JAX
    custom VJP ``_vmem_attention_bhnd``, saving ``(q, k, v, o, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = vmem_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = _readable_grad(do, None)
        dq, dk, dv = vmem_attention_bwd(q, k, v, o, do, lse, ctx.scale)
        return dq, dk, dv, None


def vmem_attention_bhnd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unmasked self-attention over (B, H, N, hd) q/k/v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return VmemAttention.apply(q, k, v, float(scale))


def vmem_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention over (B, N, H, hd) inputs (the dot_product_attention
    API). Unmasked, dropout-free. The kernels read the (B, H, N, hd) views
    of the inputs in place, and the result is (B, N, H, hd)."""
    out = vmem_attention_bhnd(*(x.transpose(1, 2) for x in (q, k, v)),
                              scale=scale)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# The ViT's attention
# ---------------------------------------------------------------------------


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention for what the kernels do not take (the counterpart of
    ``jax.nn.dot_product_attention`` in the JAX ViT): logits in the input
    dtype, softmax in fp32. ``mask``: bool, broadcastable to (B, H, N, N),
    True where attention is allowed."""
    hd = q.shape[-1] // num_heads
    if scale is None:
        scale = hd ** -0.5
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    s = s.float()
    if mask is not None:
        s = s.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _flat(torch.matmul(p, vh))


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The ViT's attention, with the JAX ViT's gate (see the module
    docstring): the kernels, or the plain path."""
    if mask is None and q.is_cuda and fits_vmem(q.shape[1]):
        if not use_vmem_attention(q):
            raise ValueError(
                "LIGHTLY_TRAIN_VMEM_ATTENTION turns the attention kernels "
                "off, but unmasked attention on the card has no plain path "
                "in the port; unset it"
            )
        return flat_attention(q, k, v, num_heads)
    return dot_product_attention(q, k, v, num_heads, mask)
