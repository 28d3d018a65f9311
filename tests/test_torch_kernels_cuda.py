"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: they skip where there is no NVIDIA card (the kernels have
no CPU mode). This file imports neither JAX nor the JAX package, so it also
runs on the GPU machines, which have no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from lightly_train_tpu_torch._optim import fused_update as F
from lightly_train_tpu_torch.ops.kernels import attention as A

pytestmark = pytest.mark.cuda
HD = 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_close(got, ref):
    """Within 2^-7 of the reference's largest magnitude (a few bf16 ulps,
    where a probability near a rounding boundary rounds the other way), and
    within 1e-2 relative L2, which a systematic error on a few rows
    exceeds. The 1e-6 per element covers outputs whose exact value is 0
    (dq and dk at N=1, where the one key's probability is constant)."""
    diff = got.float() - ref.float()
    tol = 2.0 ** -7 * ref.float().abs().max().item() + 1e-6
    assert diff.abs().max().item() <= tol
    assert diff.norm().item() <= (1e-2 * ref.float().norm().item()
                                  + 1e-6 * diff.numel() ** 0.5)


@pytest.mark.parametrize("B,N", [(2, 257), (3, 37), (1, 1), (2, 512)])
def test_attention_kernels_match_plain(cuda, B, N):
    gen = torch.Generator(device=cuda).manual_seed(N)
    q, k, v, do = (torch.randn((B, N, 12 * HD), generator=gen, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    scale = HD ** -0.5
    o, lse = A.flat_attention_fwd(q, k, v, 12, scale)
    o_ref, lse_ref = A.flat_attention_fwd_plain(q, k, v, 12, scale)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=5e-3)
    grads = A.flat_attention_bwd(q, k, v, o, do, lse, 12, scale)
    refs = A.flat_attention_bwd_plain(q, k, v, o, do, lse, 12, scale)
    for got, ref in zip((o, *grads), (o_ref, *refs)):
        _bf16_close(got, ref)


def test_attention_kernels_read_strided_qkv(cuda):
    """q/k/v as column slices of one fused (B, N, 3D) projection output."""
    B, N, D = 2, 257, 12 * HD
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn((B, N, 3 * D), generator=gen, device=cuda).to(
        torch.bfloat16)
    q, k, v = qkv.split(D, dim=-1)
    o, lse = A.flat_attention_fwd(q, k, v, 12, HD ** -0.5)
    o_ref, _ = A.flat_attention_fwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), 12, HD ** -0.5)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)


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


@pytest.mark.parametrize("shape", [(768, 768), (257, 768), (7,), (65536, 256)])
def test_fused_update_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(len(shape))
    g, p, t = (torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda) for _ in range(3))
    mu = 0.1 * torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=cuda)
    nu = 0.01 * torch.tensor(rng.random(shape), dtype=torch.float32,
                             device=cuda)
    s = torch.tensor([0.7, 1.5, 1.1, 2e-3, 0.04, 0.995, 0.0, 0.0],
                     device=cuda)
    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    ref = F.fused_adamw_ema_leaf_plain(g, p, mu, nu, t, s, **hp)
    F.fused_adamw_ema_leaf(g, p, mu, nu, t, s, **hp)
    for got, r in zip((p, mu, nu, t), ref):
        torch.testing.assert_close(got, r, rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 600, 12 * HD), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        A.flat_attention_fwd(x, x, x, 12, 0.125)  # N > MAX_N
    y = torch.zeros((1, 8, 12 * HD), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        A.flat_attention_fwd(y, y, y, 12, 0.125)  # fp32


def test_vit_attention_on_the_card_never_runs_the_plain_path(cuda):
    """Unmasked attention on CUDA tensors of a shape the kernels take
    launches them or raises: fp32 raises instead of running plain."""
    y = torch.zeros((2, 37, 12 * HD), dtype=torch.float32, device=cuda)
    before = A.flat_attention_fwd.launches
    with pytest.raises(ValueError, match="bf16"):
        A.attention(y, y, y, 12)
    x = y.to(torch.bfloat16)
    A.attention(x, x, x, 12)
    assert A.flat_attention_fwd.launches == before + 1
