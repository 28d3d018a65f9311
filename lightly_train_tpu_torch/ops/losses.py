"""SSL loss ops of DINOv2 and DINO (DINO CE, iBOT patch CE, KoLeo, softmax
and Sinkhorn-Knopp centering), of SimCLR (NT-Xent) and of distillation
(queue similarity CE, feature MSE).

Port of ``lightly_train_tpu/ops/losses.py``. Loss math runs in float32 whatever the
compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Zero-safe l2 normalization: ``x * rsqrt(sum(x^2) + eps)``."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def softmax_center_teacher(teacher_logits: torch.Tensor, center: torch.Tensor,
                           temp: float) -> torch.Tensor:
    """Teacher softmax with EMA-center subtraction."""
    return torch.softmax((teacher_logits.float() - center) / temp, dim=-1)


def update_center(
    center: torch.Tensor,
    teacher_logits: torch.Tensor,
    momentum: float = 0.9,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """EMA update of the teacher center from the batch mean over all leading
    axes; ``sample_weights`` (0/1 over the leading axes) restricts the mean
    to the masked tokens (the iBOT center)."""
    t = teacher_logits.float()
    dims = tuple(range(t.ndim - 1))
    if sample_weights is not None:
        w = sample_weights.float()
        batch_center = (t * w[..., None]).sum(dim=dims) / torch.clamp(
            w.sum(), min=1.0)
    else:
        batch_center = t.mean(dim=dims)
    return center * momentum + batch_center * (1.0 - momentum)


def sinkhorn_knopp_teacher(
    teacher_logits: torch.Tensor,
    temp: float,
    n_iterations: int = 3,
    sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sinkhorn-Knopp centering of (B, K) teacher logits into (B, K) targets.

    As the JAX package computes it: ``exp(t / temp)`` with no maximum
    subtracted, ``n_iterations`` alternations of prototype (row) and sample
    (column) normalization. ``sample_weights``, an optional (B,) 0/1 mask
    of the rows that take part (the iBOT variant: the masked patches),
    zeroes the others and sets the sample count. One process, so no sums
    across devices."""
    Q = torch.exp(teacher_logits.float() / temp).T  # (K, B)
    if sample_weights is not None:
        w = sample_weights.float()
        Q = Q * w[None, :]
        n_samples = torch.clamp(w.sum(), min=1.0)
    else:
        n_samples = torch.tensor(float(Q.shape[1]), device=Q.device)
    K = Q.shape[0]
    Q = Q / Q.sum()
    for _ in range(n_iterations):
        # Each prototype's total weight 1 / K, then each sample's 1 / B.
        Q = Q / Q.sum(dim=1, keepdim=True)
        Q = Q / K
        Q = Q / torch.clamp(Q.sum(dim=0, keepdim=True), min=1e-12)
        Q = Q / n_samples
    return (Q * n_samples).T


def dino_cross_entropy(teacher_probs: torch.Tensor,
                       student_logits: torch.Tensor,
                       student_temp: float = 0.1) -> torch.Tensor:
    """Mean CE between teacher distributions and student logits (..., K)."""
    logp = torch.log_softmax(student_logits.float() / student_temp, dim=-1)
    return (-(teacher_probs.float() * logp).sum(dim=-1)).mean()


def ibot_patch_loss(
    teacher_probs: torch.Tensor,
    student_logits: torch.Tensor,
    mask: torch.Tensor,
    mask_weight: torch.Tensor,
    student_temp: float = 0.1,
) -> torch.Tensor:
    """Masked-patch CE with per-sample weights, normalized by ALL crops
    (masked or not), as the reference does. Shapes (B, M, K) and (B, M)."""
    logp = torch.log_softmax(student_logits.float() / student_temp, dim=-1)
    ce = -(teacher_probs.float() * logp).sum(dim=-1)
    weighted = ce * mask.float() * mask_weight.float()
    return weighted.sum() / mask.shape[0]


def koleo_loss(embeddings: torch.Tensor, eps: float = 1e-8,
               groups: int = 1) -> torch.Tensor:
    """Kozachenko-Leonenko entropy regularizer: ``-mean(log(d_nn))`` over
    l2-normalized embeddings, nearest neighbours searched within
    ``groups`` contiguous blocks of the batch (per-device semantics)."""
    x = l2_normalize(embeddings.float(), eps)
    B = x.shape[0]
    g = groups if groups > 1 and B % groups == 0 and B // groups >= 2 else 1
    n = B // g
    xg = x.reshape(g, n, -1)
    sim = torch.einsum("gid,gjd->gij", xg, xg)
    sim = sim - 2.0 * torch.eye(n, dtype=sim.dtype, device=sim.device)[None]
    nn_idx = sim.argmax(dim=2)
    nn = torch.gather(xg, 1, nn_idx[..., None].expand_as(xg))
    dist = torch.sqrt(torch.clamp(((xg - nn) ** 2).sum(dim=-1), min=eps))
    return -torch.log(dist + eps).mean()


def ntxent_loss(z0: torch.Tensor, z1: torch.Tensor, temperature: float = 0.5,
                eps: float = 1e-8) -> torch.Tensor:
    """NT-Xent over the (2B, 2B) similarity of two views' (B, D)
    projections in fp32; each row's own entry is pushed out of the softmax
    by subtracting 1e9, as the JAX package does."""
    z0 = l2_normalize(z0, eps)
    z1 = l2_normalize(z1, eps)
    B = z0.shape[0]
    z = torch.cat([z0, z1], dim=0).float()
    sim = (z @ z.T) / temperature
    sim = sim - 1e9 * torch.eye(2 * B, dtype=sim.dtype, device=sim.device)
    targets = torch.cat([torch.arange(B) + B, torch.arange(B)]).to(sim.device)
    logp = torch.log_softmax(sim, dim=-1)
    return -logp[torch.arange(2 * B, device=sim.device), targets].mean()


def similarity_queue_ce(student_emb: torch.Tensor, teacher_emb: torch.Tensor,
                        queue: torch.Tensor,
                        temperature: float = 0.07) -> torch.Tensor:
    """Distillation v3's similarity CE against a (Q, D) queue of teacher
    embeddings: the teacher's softmax over its (l2-normalized) similarities
    to the queue is the target of the student's. Embeddings are (B, D) or
    (B, N, D). An all-zero queue row normalizes to 0 and stays in both
    softmaxes with logit 0, as in the JAX package."""
    s = l2_normalize(student_emb.float())
    t = l2_normalize(teacher_emb.float())
    q = l2_normalize(queue.float())
    sim_s = torch.einsum("...d,qd->...q", s, q) / temperature
    sim_t = torch.einsum("...d,qd->...q", t, q) / temperature
    p_t = torch.softmax(sim_t, dim=-1)
    logp_s = torch.log_softmax(sim_s, dim=-1)
    return -(p_t * logp_s).sum(dim=-1).mean()


def mse_feature_loss(student_feat: torch.Tensor,
                     teacher_feat: torch.Tensor) -> torch.Tensor:
    """Plain feature MSE (distillation v1)."""
    return ((student_feat.float() - teacher_feat.float()) ** 2).mean()
