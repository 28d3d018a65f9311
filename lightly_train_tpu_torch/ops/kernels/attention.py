"""Multi-head self-attention over flat (B, N, D) projections.

Port of ``lightly_train_tpu/ops/pallas/attention.py::flat_attention``. The
forward kernel (K1, ``csrc/flat_attention_fwd.cu``) replaces
``_flat_fwd_kernel``, the backward kernels (K2, ``csrc/flat_attention_bwd.cu``)
replace ``_flat_bwd_kernel``; :class:`FlatAttention` ties them together the
way the JAX custom VJP does: the forward saves ``(q, k, v, o, lse)`` and the
backward recomputes the probabilities from ``lse``.

Which path runs (the ViT's attention calls :func:`attention`):

- the kernels run on CUDA tensors, for unmasked attention, when
  :func:`kernel_supports` accepts the shape (head dim 64, 1 <= N <= 512).
  They take bf16 only: any other dtype on the card raises (``pretrain``
  refuses ``precision="fp32"`` on the card until an fp32 kernel exists);
- otherwise the plain path :func:`dot_product_attention` runs, and only for
  what the kernels do not take: masked attention, shapes past that range,
  and CPU tensors, where the JAX package likewise runs XLA attention
  instead of its kernel.

:func:`flat_attention` itself never falls back: for a CUDA tensor it launches
the kernels or raises; for a CPU tensor it runs the plain versions
(:func:`flat_attention_fwd_plain`, :func:`flat_attention_bwd_plain`), which
repeat the kernels' arithmetic (p rounded to bf16 before p . v, l summed in
fp32 from the rounded p, fp32 lse, bf16 ds) and serve as their reference.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lightly_train_tpu_torch import _native

MAX_N = 512
HEAD_DIMS = (64,)


def kernel_supports(n_tokens: int, head_dim: int) -> bool:
    """Whether the CUDA kernels take this sequence length and head dim."""
    return 1 <= n_tokens <= MAX_N and head_dim in HEAD_DIMS


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, num_heads, D // num_heads).transpose(1, 2).float()


def _flat(x: torch.Tensor) -> torch.Tensor:
    B, H, N, hd = x.shape
    return x.transpose(1, 2).reshape(B, N, H * hd)


def flat_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: returns (o (B, N, D), lse (B, H, N))."""
    qh, kh, vh = (_heads(x, num_heads) for x in (q, k, v))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).to(torch.bfloat16).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, vh) / l
    lse = (m + torch.log(l))[..., 0]
    return _flat(o).to(q.dtype), lse


def flat_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, num_heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: returns (dq, dk, dv), each (B, N, D)."""
    qh, kh, vh, oh, doh = (_heads(x, num_heads) for x in (q, k, v, o, do))
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    do16 = doh.to(torch.bfloat16).float()
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), do16)
    dp = torch.matmul(do16, vh.transpose(-1, -2))
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(torch.bfloat16).float()
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return tuple(_flat(x).to(q.dtype) for x in (dq, dk, dv))


def _check_kernel_inputs(name: str, *tensors: torch.Tensor) -> None:
    ref = tensors[0]
    for x in tensors:
        if not x.is_cuda or x.device != ref.device:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bf16, got {x.dtype}")
        if x.shape != ref.shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                             f"{tuple(ref.shape)}")
        # 16-byte vector loads: aligned base, unit column stride, row and
        # batch strides in multiples of 8 elements.
        if (x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8
                or x.data_ptr() % 16):
            raise ValueError(
                f"{name}: the kernel needs unit column stride, strides in "
                f"multiples of 8 and a 16-byte aligned base; got strides "
                f"{x.stride()}"
            )


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def flat_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (o, lse). Launches the CUDA kernel for CUDA tensors (or raises),
    runs the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flat_attention_fwd_plain(q, k, v, num_heads, scale)
    _check_kernel_inputs("flat_attention_fwd", q, k, v)
    B, N, D = q.shape
    hd = D // num_heads
    if num_heads * hd != D or not kernel_supports(N, hd):
        raise ValueError(
            f"flat_attention_fwd: the kernel takes head dim {HEAD_DIMS} and "
            f"N <= {MAX_N}; got N={N}, D={D}, heads={num_heads}"
        )
    o = torch.empty((B, N, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, num_heads, N), dtype=torch.float32, device=q.device)
    fn = _native.function("flat_attention_fwd")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, N, num_heads, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), o.stride(0), o.stride(1),
        float(scale), _stream(q),
    )
    _native.check(err, "flat_attention_fwd")
    flat_attention_fwd.launches += 1
    return o, lse


flat_attention_fwd.launches = 0


def flat_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    do: torch.Tensor, lse: torch.Tensor, num_heads: int, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (dq, dk, dv). Launches the two CUDA kernels for CUDA tensors (or
    raises), runs the plain version for CPU tensors. One call counts as one
    launch of K2."""
    if q.device.type == "cpu":
        return flat_attention_bwd_plain(q, k, v, o, do, lse, num_heads, scale)
    _check_kernel_inputs("flat_attention_bwd", q, k, v, o, do)
    B, N, D = q.shape
    hd = D // num_heads
    if num_heads * hd != D or not kernel_supports(N, hd):
        raise ValueError(
            f"flat_attention_bwd: unsupported N={N}, D={D}, heads={num_heads}"
        )
    if (lse.shape != (B, num_heads, N) or lse.dtype != torch.float32
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flat_attention_bwd: lse must be contiguous fp32 "
                         "(B, H, N) on the inputs' device")
    dq, dk, dv = (torch.empty((B, N, D), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((B, num_heads, N), dtype=torch.float32,
                        device=q.device)
    strides = (ctypes.c_int64 * 16)(*[
        s for x in (q, k, v, o, do, dq, dk, dv) for s in x.stride()[:2]
    ])
    fn = _native.function("flat_attention_bwd")
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, N, num_heads, hd, strides,
        float(scale), _stream(q),
    )
    _native.check(err, "flat_attention_bwd")
    flat_attention_bwd.launches += 1
    return dq, dk, dv


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
        if do.is_cuda:
            do = do.contiguous()
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


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
    mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain attention for what the kernels do not take (the counterpart of
    ``jax.nn.dot_product_attention`` in the JAX ViT): logits in the input
    dtype, softmax in fp32. ``mask``: bool, broadcastable to (B, H, N, N),
    True where attention is allowed."""
    B, N, D = q.shape
    hd = D // num_heads
    if scale is None:
        scale = hd ** -0.5
    qh, kh, vh = (
        x.reshape(B, N, num_heads, hd).transpose(1, 2) for x in (q, k, v)
    )
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
    """The ViT's attention: the kernels where they apply, else plain (see
    the module docstring for the rule)."""
    n_tokens, head_dim = q.shape[1], q.shape[2] // num_heads
    if mask is None and q.is_cuda and kernel_supports(n_tokens, head_dim):
        return flat_attention(q, k, v, num_heads)
    return dot_product_attention(q, k, v, num_heads, mask)
