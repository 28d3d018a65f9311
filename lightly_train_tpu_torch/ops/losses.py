"""SSL loss ops of DINOv2 (DINO CE, iBOT patch CE, KoLeo, centering).

Port of the DINOv2 losses in ``lightly_train_tpu/ops/losses.py``. Loss math
runs in float32 whatever the compute dtype. Sinkhorn-Knopp centering waits
(ROADMAP item 4).
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
