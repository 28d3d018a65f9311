"""kNN classification of embeddings (the DINO eval protocol).

Port of ``lightly_train_tpu/utils/knn.py``: the same ops in the same order
on the device of the inputs. Queries and train features are normalised
(with a floor of 1e-8 on the norm), their cosine similarities taken as one
product, the top ``min(k, Nt)`` kept, each weighted by ``exp(sim / T)``,
their labels' one-hot votes summed and the largest taken. Ties go to the
first index in both ``topk`` and ``argmax``, as in ``jax.lax.top_k`` and
``jnp.argmax``.
"""

from __future__ import annotations

import torch


def knn_predict(
    query: torch.Tensor,  # (Nq, D)
    train_features: torch.Tensor,  # (Nt, D)
    train_labels: torch.Tensor,  # (Nt,)
    num_classes: int,
    k: int = 20,
    temperature: float = 0.07,
) -> torch.Tensor:
    """Weighted-kNN class predictions, (Nq,) int64."""
    q = query / torch.clamp(
        torch.linalg.vector_norm(query, dim=1, keepdim=True), min=1e-8)
    t = train_features / torch.clamp(
        torch.linalg.vector_norm(train_features, dim=1, keepdim=True),
        min=1e-8)
    sim = q @ t.T  # (Nq, Nt)
    k = min(k, t.shape[0])
    top_sim, top_idx = _top_k(sim, k)
    weights = torch.exp(top_sim / temperature)  # (Nq, k)
    votes = torch.nn.functional.one_hot(
        train_labels[top_idx].long(), num_classes).to(weights.dtype)
    scores = torch.sum(weights[..., None] * votes, dim=1)
    # The first index of the largest score, as jnp.argmax takes it.
    return torch.argmax(scores, dim=-1)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest of each row in descending order,
    equal values in the order of their index (``torch.topk`` leaves the
    order of ties unspecified). The k from ``torch.topk`` are put in that
    order; a row in which values equal to the k-th do not all fit in the
    k, so that ``torch.topk`` chose among them, is sorted whole, stably."""
    values, index = torch.topk(x, k, dim=-1)
    index, order = index.sort(dim=-1)
    values, order = values.gather(-1, order).sort(dim=-1, descending=True,
                                                  stable=True)
    index = index.gather(-1, order)
    kth = values[..., -1:]
    ties = (x == kth).sum(-1) > (values == kth).sum(-1)
    if bool(ties.any()):
        rows = ties.nonzero()[:, 0]
        v, i = torch.sort(x[rows], dim=-1, descending=True, stable=True)
        values[rows], index[rows] = v[:, :k], i[:, :k]
    return values, index


def knn_accuracy(
    query: torch.Tensor,
    query_labels: torch.Tensor,
    train_features: torch.Tensor,
    train_labels: torch.Tensor,
    num_classes: int,
    k: int = 20,
    temperature: float = 0.07,
    chunk_size: int = 4096,
) -> float:
    """The share of queries whose prediction is their label. Queries run in
    chunks of ``chunk_size``, so the (Nq, Nt) similarities never exist
    whole; a last chunk after the first is padded to the chunk shape, as
    the JAX package pads it."""
    nq = int(query.shape[0])
    correct = 0
    for start in range(0, nq, chunk_size):
        q = query[start:start + chunk_size]
        n = int(q.shape[0])
        if n < chunk_size and start > 0:
            q = torch.nn.functional.pad(q, (0, 0, 0, chunk_size - n))
        pred = knn_predict(q, train_features, train_labels, num_classes, k,
                           temperature)[:n]
        correct += int(torch.sum(
            (pred == query_labels[start:start + n].long()).to(torch.int32)))
    return correct / max(nq, 1)
