"""DenseCL: dense contrastive learning with a momentum encoder.

Port of ``lightly_train_tpu/methods/densecl.py``: two views, an EMA teacher
of the whole tree (momentum 0.999) on the second view, a global head on the
pooled features and a dense head on every feature-map pixel; each student
pixel is matched to the teacher pixel of the most similar backbone feature
(an argmax), and both heads' outputs are contrasted by InfoNCE against ring
queues of teacher embeddings (before the first enqueue, against the batch's
own teacher embeddings). SGD by default.

The queue's write pointer and fill count are host integers, so the branch on
whether the queue holds anything is a Python one. The queue products are
plain GEMMs: at batch 64 and the default 65536 rows the dense logits alone
are 16384 x 65537 fp32 (4 GiB).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from lightly_train_tpu_torch._optim import SGDArgs
from lightly_train_tpu_torch.methods.base import (
    Method,
    MethodArgs,
    ViewSpec,
    enqueue_rows,
)
from lightly_train_tpu_torch.models.heads import SimCLRProjectionHead
from lightly_train_tpu_torch.models.wrapper import WrappedModel
from lightly_train_tpu_torch.ops.augment import ViewAugmentConfig
from lightly_train_tpu_torch.ops.ema import ema_update
from lightly_train_tpu_torch.ops.losses import l2_normalize


@dataclasses.dataclass
class DenseCLArgs(MethodArgs):
    image_size: int = 224
    temperature: float = 0.2
    queue_size: int = 65536
    momentum: float = 0.999
    lambda_dense: float = 0.5
    hidden_dim: int = 2048
    output_dim: int = 128
    reference_batch_size: int = 256
    lr_scale_method: str = "linear"


def info_nce(q: torch.Tensor, pos: torch.Tensor, queue: torch.Tensor,
             temp: float) -> torch.Tensor:
    """InfoNCE of (B, D) queries with one positive each against the rows of
    ``queue`` as negatives."""
    q, pos, neg = l2_normalize(q), l2_normalize(pos), l2_normalize(queue)
    l_pos = (q * pos).sum(dim=-1, keepdim=True)
    logits = torch.cat([l_pos, q @ neg.T], dim=1) / temp
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()


def dense_match(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """(B, n) index of the teacher pixel whose l2-normalized feature is the
    most similar to each student pixel's (the first of equal maxima)."""
    corr = torch.einsum("bnd,bmd->bnm", l2_normalize(f_s), l2_normalize(f_t))
    return corr.argmax(dim=-1)


class DenseCL(Method):
    name = "densecl"
    default_steps = 100_000
    default_batch_size = 256
    ema_teacher = True

    def __init__(self, wrapped: WrappedModel, args: DenseCLArgs):
        super().__init__(wrapped, args)
        self.args: DenseCLArgs = args

    def view_specs(self) -> List[ViewSpec]:
        s = self.args.image_size
        return [ViewSpec(ViewAugmentConfig(out_size=(s, s)), 2)]

    def init(self, generator: torch.Generator, device: torch.device
             ) -> Tuple[nn.ModuleDict, Dict[str, Any]]:
        a = self.args
        d = self.wrapped.feature_dim
        modules = {
            "student": self.wrapped.module,
            "global_head": SimCLRProjectionHead(d, a.hidden_dim, a.output_dim),
            "dense_head": SimCLRProjectionHead(d, a.hidden_dim, a.output_dim),
        }
        for m in modules.values():
            m.reset_parameters(generator)
        params = nn.ModuleDict(modules).to(device)
        return params, {
            "teacher": copy.deepcopy(params).requires_grad_(False),
            "queue_global": torch.zeros(a.queue_size, a.output_dim,
                                        device=device),
            "queue_dense": torch.zeros(a.queue_size, a.output_dim,
                                       device=device),
            "queue_ptr": 0,
            "queue_filled": 0,
        }

    def encode(self, modules: nn.ModuleDict, images: torch.Tensor,
               train: bool, generator=None):
        """(global embedding (B, D'), dense embeddings (B, n, D'), backbone
        pixels (B, n, D))."""
        out = self.wrapped.forward_features(images, None, train=train,
                                            generator=generator,
                                            module=modules["student"])
        feats = out["features"]
        B, h, w, D = feats.shape
        feats = feats.reshape(B, h * w, D)
        return (modules["global_head"](self.wrapped.forward_pool(out)),
                modules["dense_head"](feats), feats)

    def loss_fn(self, params, method_state, views, step, total_steps,
                generator=None, masks=None):
        """``masks`` pins the (B, n) dense match (the JAX package's argmax,
        where two teacher pixels tie within rounding)."""
        a = self.args
        v0, v1 = views[0], views[1]
        zg_s, zd_s, f_s = self.encode(params, v0, True, generator)
        with torch.no_grad():
            zg_t, zd_t, f_t = self.encode(method_state["teacher"], v1, False)
            match = dense_match(f_s.detach(), f_t) if masks is None else (
                masks.to(zd_t.device))
            zd_pos = torch.gather(
                zd_t, 1, match[..., None].expand(-1, -1, zd_t.shape[-1]))
        B, n, D = zd_s.shape
        filled = method_state["queue_filled"] > 0
        qg, qd = method_state["queue_global"], method_state["queue_dense"]
        loss_g = info_nce(zg_s, zg_t, qg if filled else zg_t, a.temperature)
        loss_d = info_nce(zd_s.reshape(B * n, D), zd_pos.reshape(B * n, D),
                          qd if filled else zd_t.reshape(B * n, D),
                          a.temperature)
        loss = (1 - a.lambda_dense) * loss_g + a.lambda_dense * loss_d
        ptr, Q = method_state["queue_ptr"], qg.shape[0]
        new_state = {
            **method_state,
            "queue_global": enqueue_rows(qg, ptr, zg_t),
            "queue_dense": enqueue_rows(qd, ptr, zd_t.mean(dim=1)),
            "queue_ptr": (ptr + B) % Q,
            "queue_filled": min(method_state["queue_filled"] + B, Q),
        }
        return loss, (new_state, {"loss_global": loss_g.detach(),
                                  "loss_dense": loss_d.detach()})

    def post_update(self, params, method_state, step, total_steps):
        ema_update(dict(method_state["teacher"].named_parameters()),
                   dict(params.named_parameters()), self.args.momentum)
        return method_state

    @classmethod
    def default_optimizer_args(cls) -> SGDArgs:
        return SGDArgs(lr=0.3, momentum=0.9, weight_decay=1e-4)
