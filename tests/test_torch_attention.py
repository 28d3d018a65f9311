"""The port's flat attention against the JAX package's Pallas kernel.

The same numpy inputs go through ``flat_attention(..., interpret=True)``
(the Pallas kernel run by the interpreter on the CPU) with its ``jax.vjp``,
and through the port's ``flat_attention`` on CPU tensors, which runs the
plain PyTorch versions of the CUDA kernels, forward and autograd backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightly_train_tpu.ops.pallas.attention import (
    flat_attention as jax_flat_attention,
)
from lightly_train_tpu_torch.ops.kernels import attention as A

H, HD = 2, 64


def _inputs(B, N, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, H * HD)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("B,N", [(1, 37), (1, 50), (1, 257), (2, 17)])
def test_plain_matches_pallas_interpret(B, N):
    q, k, v, co = _inputs(B, N, seed=N)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_flat_attention(a, b, c, H, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    grads_j = vjp(jnp.asarray(co))

    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out_t = A.flat_attention(qt, kt, vt, H)
    out_t.backward(torch.tensor(co))

    # Both round p (and ds) to bf16 at the same places; the fp32 sums are
    # taken in other orders, so a value near a bf16 rounding boundary can
    # round the other way: a few bf16 ulps (2^-8 relative) of slack.
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-2, atol=1e-2)
    for got, ref in zip((qt.grad, kt.grad, vt.grad), grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
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
    assert A.kernel_supports(257, 64) and A.kernel_supports(37, 64)
    assert A.kernel_supports(1, 64) and A.kernel_supports(A.MAX_N, 64)
    assert not A.kernel_supports(A.MAX_N + 1, 64)
    assert not A.kernel_supports(257, 16)
