#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, in parallel).
2. Hold each kernel against its plain PyTorch version on the card and time
   kernel, plain version and the nearest single PyTorch call
   (``library_ms``): the attention kernels K1/K2 (flat layout) in bf16 and
   fp32 at the ViT-B/14 global and local shapes, at N = 730 (ViT-B/14 on
   378^2 images), at head dim 16 (a small grid and the vittest14 shapes
   of phase 3e) and, in fp32, at the frozen DINOv3 ViT-B/16 teacher's
   shape of phase 3f (N = 201); K4/K5 (``vmem_attention``) in both
   layouts and dtypes at the ViT-B/14 shapes, and in ``vmem_attention``'s
   layout at the hd-16 ones; K3, one launch over the
   ViT-B/14 leaves and synthetic ones that exercise its chunk plan (ragged
   sizes, a leaf of no gradient), with lr 0 (bitwise), over two steps of
   ``FusedAdamWEMA`` with every gradient reallocated in between, at several
   chunk sizes, and ``update_and_apply`` on the main path's model
   (``time_update.py``: its host time, ``update_host_ms``).
   In fp32 a control checks the tolerance itself: the kernels fed inputs
   rounded to bf16 must fail it (each output's verdict is printed). The
   SASS of every attention library (each forward and backward, both
   dtypes, at both head dims) must hold wgmma (HGMMA) instructions, and
   that of the two that fill their rings with cp.async (the bf16 forward
   and backward, ``flat_attention_fwd_sm90.cu`` and
   ``flat_attention_bwd_sm90.cu``) LDGSTS too (the fp32 hd-64 forward and
   backward, ``flat_attention_fwd_f32_sm90.cu`` and
   ``flat_attention_bwd_f32_sm90.cu``, load with ld.global and split in
   registers; at hd 16 the fp32 kernels land their rows by cp.async as
   well); no library's SASS may hold the warp-level mma.sync (HMMA), and
   no build log a ptxas warning that it serialized the wgmma products.
   Those times are device times (calls captured in a CUDA graph and
   replayed); ``host_ms`` is the kernel's time with its host-side launch
   (Python, ctypes, argument checks; K3's staging copy) included.
3. Run the main paths, each with every launch counter set to 0 just before
   and read just after: ``pretrain`` with DINOv2 on ViT-B/14 at batch 32 in
   bf16 (3) and in fp32 (3b) for 4 steps each on a folder of generated PPM
   images, checking finite losses, the launch counts, and the trained
   backbone against an fp32 CPU reference on a small input, and that
   every forward and backward went to the library its dtype routes to; and
   (3c) the public ``vmem_attention`` op, the one path of K4/K5, forward
   and backward in both dtypes. Phases 3 and 3b checkpoint only at the end,
   after the timed steps, and check the one step file and
   ``exported_models/exported_last`` it leaves. (3d) The rest of the loop a
   user runs: the bf16 main path interrupted after its step-2 checkpoint
   and resumed with ``resume_interrupted``, held against phase 3's
   uninterrupted run (losses of steps 3 and 4 within 1e-3 relative, the
   student within 1e-3 relative L2, and whether they were bitwise equal),
   with each checkpoint's save time and size; phase 3's
   ``augmentations.png`` (its PNG header); and ``embed`` of the 64 images
   with phase 3's exported artifact in fp32 (12 K1 launches on the fp32
   wgmma forward, no K2), held against an fp32 CPU reference, with its
   images per second. (3e) ``pretrain`` DINOv2 on vittest14 (width 32, 2
   heads: head dim 16) at batch 32 for 2 steps in bf16 and in fp32, on the
   same images, counters set to 0 just before and read just after: every
   forward and every backward on its dtype's wgmma library at hd 16,
   finite losses, the backbone against an fp32 CPU reference. (3f)
   ``pretrain`` at its defaults (no model, no method: distillation v3 of
   ViT-B/14 from a frozen DINOv3 ViT-B/16 teacher with LARS, batch 64 and
   queue 16 for the 64 images) for 4 steps in bf16 and 2 in fp32, counters
   set to 0 just before and read just after: per step 24 K1 launches (12
   of the fp32 teacher on the fp32 forward at N = 201, 12 of the student
   on its dtype's forward at N = 257), 12 K2 and no K3; finite losses, the
   queue full (16 rows), the student and the teacher against fp32 CPU
   references; then the bf16 run interrupted after its step-2 checkpoint
   and resumed, held against the uninterrupted one.

The kernels run unless ``LIGHTLY_TRAIN_VMEM_ATTENTION`` turns them off, and
then this check fails.

``--profile`` adds a phase 4: a ``torch.profiler`` window over a few
training steps in each precision, printing the device's busy share and the
kernels that take the most device time.

Prints the card's name and power limit, one JSON line with every kernel's
results, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it prints no result
and exits with 1.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor peak
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor peak
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SEED = 0
BATCH = 32
STEPS = 4
HEADS, HEAD_DIM = 12, 64
# (B, N, H, hd) of ViT-B/14's attention: 2 global views x batch at 224^2
# (16 x 16 patches + CLS), 8 local views x batch at 96^2 (6 x 6 + CLS).
GLOBAL = (2 * BATCH, 257, HEADS, HEAD_DIM)
LOCAL = (8 * BATCH, 37, HEADS, HEAD_DIM)
# The global views at 378^2 (27 x 27 patches + CLS), at batch 32 and 8.
GLOBAL_378 = (2 * BATCH, 730, HEADS, HEAD_DIM)
GLOBAL_378_B8 = (16, 730, HEADS, HEAD_DIM)
# vittest14 (width 32, 2 heads: hd 16), the model of the port's CPU runs:
# its attention in pretrain at batch 32 (phase 3e), and a small grid.
VITTEST_STEPS = 2
VITTEST_GLOBAL = (2 * BATCH, 257, 2, 16)
VITTEST_LOCAL = (8 * BATCH, 37, 2, 16)
HD16_SMALL = (8, 257, 2, 16)
# Phase 3f: ``pretrain`` at its defaults on the 64 images: batch
# min(1536, 64) = 64 of one view, queue 16 (fewer than 1000 images); the
# frozen DINOv3 ViT-B/16 teacher at 224^2 (14 x 14 patches + CLS + 4
# registers) in fp32 in every precision, the ViT-B/14 student at GLOBAL.
DISTILL_BATCH = 2 * BATCH
TEACHER = (DISTILL_BATCH, 201, HEADS, HEAD_DIM)
DISTILL_STEPS = {"bf16": 4, "fp32": 2}
DISTILL_QUEUE = 16
DISTILL_KEYS = ("train_loss", "loss_global", "loss_local", "grad_norm")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one call of ``fn`` launched from the host, launch overhead
    included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, replays: int = 20, per_graph: int = 1) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in
    one CUDA graph, replayed ``replays`` times between two events, so the
    host's launch overhead is left out."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    torch.cuda.empty_cache()
    return ms


def bound_ms(n_bytes: float, flops: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    """(least time in ms, "bytes" or "operations"): each input read once,
    each output written once, against the published H100 SXM peaks."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Tolerances of the attention kernels against their plain versions, per
# input dtype: (max-abs as a share of the plain output's largest magnitude,
# relative L2). bf16 outputs may differ by a few bf16 ulps at the top of
# their range (a probability near a bf16 rounding boundary can round the
# other way when the fp32 sums are taken in another order); the relative L2
# catches a systematic error on a few rows (a dropped or mis-scaled key on
# the ragged edge). fp32 outputs are not rounded to bf16, but p and ds still
# are, on both sides, and the kernels' hi/lo bf16 products are about 2^-16
# off the plain fp32 ones, so some of those roundings go the other way:
# max-abs as for bf16 (one ds one ulp off moves a dk element of a 37-token
# head by ~2^-8 of the largest), relative L2 1e-3, which a kernel computing
# in bf16 alone exceeds (the control in attention_case shows it). Where
# dp - delta cancels (one key, N = 1: dq and dk are rounding residue) both
# bounds add cancel_floor. lse within 5e-3 in both (fp32, __expf,
# reordered sums).
TOLERANCE = {"bf16": (2.0 ** -7, 1e-2), "fp32": (2.0 ** -7, 1e-3)}
LSE_TOLERANCE = 5e-3
DTYPES = ("bf16", "fp32")


def torch_dtype(name: str):
    import torch

    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


# kernel -> (wrapper, direction, line of the TPU kernel it replaces in
# lightly_train_tpu/ops/pallas/attention.py); the CUDA source is the one
# the dtype and head dim route to (attention.fwd_library, bwd_library), at
# hd 16 the header whose kernel that library launches.
KERNELS = {
    "K1": ("flat_attention_fwd", "fwd", 241),
    "K2": ("flat_attention_bwd", "bwd", 265),
    "K4": ("vmem_attention_fwd", "fwd", 69),
    "K5": ("vmem_attention_bwd", "bwd", 92),
}
# The attention libraries, all on Hopper's wgmma, with the instructions
# their SASS must hold (HGMMA: wgmma; LDGSTS: cp.async, where the design
# fills its ring with it), the warp-level product that no library's SASS
# may hold (HMMA: mma.sync), and ptxas's warnings that it serialized their
# wgmma products (C7510-C7519).
SM90_LIBRARIES = {
    "flat_attention_fwd_sm90": ("HGMMA", "LDGSTS"),
    "flat_attention_bwd_sm90": ("HGMMA", "LDGSTS"),
    "flat_attention_fwd_f32_sm90": ("HGMMA",),
    "flat_attention_bwd_f32_sm90": ("HGMMA",),
}
WARP_MMA = "HMMA"
SERIALIZED = tuple(f"C751{i}" for i in range(10))


def cancel_floor(scale: float, hd: int, do, v, other) -> float:
    """Per element, one 2^-16 rounding of dp = do . v (the hi/lo products'
    precision) carried through ds into dq (``other`` = k) or dk (``other`` =
    q): 2^-16 scale sqrt(hd) rms(do) rms(v) rms(other). It matters only
    where the exact dq and dk are near 0."""
    rms = [x.float().pow(2).mean().sqrt().item() for x in (do, v, other)]
    return 2.0 ** -16 * scale * hd ** 0.5 * math.prod(rms)


def compare(got, ref, dtype: str, floor: float = 0.0) -> tuple:
    """(max-abs error, relative L2, whether both are within the dtype's
    tolerance plus ``floor`` per element)."""
    max_rel, l2 = TOLERANCE[dtype]
    diff = got.float() - ref.float()
    err = diff.abs().max().item()
    ref_norm = ref.float().norm().item()
    rel = diff.norm().item() / ref_norm if ref_norm else math.inf
    ok = (err <= max_rel * ref.float().abs().max().item() + 8 * floor
          and diff.norm().item() <= l2 * ref_norm + floor * diff.numel() ** 0.5)
    return err, rel, ok


def held(tag: str, got, ref, dtype: str, floor: float = 0.0) -> float:
    """Max-abs error of ``got`` against ``ref``; fails past the dtype's
    tolerance."""
    err, rel, ok = compare(got, ref, dtype, floor)
    print(f"  {tag}: max_abs_err {err:.3e}, relative L2 {rel:.3e} (tol "
          f"{TOLERANCE[dtype]} + floor {floor:.2e})")
    if not ok:
        fail(f"{tag}: max-abs {err}, relative L2 {rel} (tol "
             f"{TOLERANCE[dtype]} + floor {floor})")
    return err


def attention_bounds(B: int, N: int, H: int, hd: int, dtype: str) -> tuple:
    """(forward, backward) bounds: q, k, v in and o out (forward), q, k, v,
    o, do in and dq, dk, dv out (backward), plus the fp32 lse, against the
    necessary products (2 forward, 5 backward, 2 N^2 hd each per head) at
    the tensor peak of the input type (TF32 for fp32)."""
    elem = B * N * H * hd * (2 if dtype == "bf16" else 4)
    flops = 4.0 * B * H * N * N * hd
    peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_TF32_FLOPS
    lse = B * H * N * 4
    return (bound_ms(4 * elem + lse, flops, peak),
            bound_ms(8 * elem + lse, 2.5 * flops, peak))


def attention_case(A, card: str, kernels: str, dtype: str, shape: tuple,
                   layout: str) -> tuple:
    """One forward and one backward kernel against their plain versions at
    ``shape`` = (B, N, H, hd), then timed: (forward row, backward row).

    ``kernels`` "flat" runs K1/K2 on (B, N, H * hd) tensors; "vmem" runs
    K4/K5 on (B, H, N, hd) tensors, real ones (``layout`` "bhnd") or the
    transposed views of (B, N, H, hd) ones ("bnhd", what ``vmem_attention``
    hands the kernels). In fp32 a control follows: the kernels on the inputs
    rounded to bf16 (what a kernel computing in bf16 alone would see) must
    fail the fp32 tolerance against the plain version on the unrounded
    inputs, or the tolerance does not check the fp32 form."""
    import torch

    B, N, H, hd = shape
    dt = torch_dtype(dtype)
    scale = hd ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + N + hd)
    if kernels == "flat":
        q, k, v, do = (torch.randn((B, N, H * hd), generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        views = [x.view(B, N, H, hd).transpose(1, 2) for x in (q, k, v, do)]
        heads = (H,)
        fwd_k, bwd_k = A.flat_attention_fwd, A.flat_attention_bwd
        fwd_p, bwd_p = A.flat_attention_fwd_plain, A.flat_attention_bwd_plain
        tag, names = f"K1/K2 {dtype} {shape}", ("K1", "K2")
    else:
        full = (B, H, N, hd) if layout == "bhnd" else (B, N, H, hd)
        q, k, v, do = (torch.randn(full, generator=gen, device="cuda").to(dt)
                       for _ in range(4))
        if layout == "bnhd":
            q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
        views = [q, k, v, do]
        heads = ()
        fwd_k, bwd_k = A.vmem_attention_fwd, A.vmem_attention_bwd
        fwd_p, bwd_p = A.vmem_attention_fwd_plain, A.vmem_attention_bwd_plain
        tag, names = f"K4/K5 {dtype} {layout} {shape}", ("K4", "K5")

    def fwd():
        return fwd_k(q, k, v, *heads, scale)

    def fwd_plain():
        return fwd_p(q, k, v, *heads, scale)

    def bwd():
        return bwd_k(q, k, v, o, do, lse, *heads, scale)

    def bwd_plain():
        return bwd_p(q, k, v, o, do, lse, *heads, scale)

    o, lse = fwd()
    o_ref, lse_ref = fwd_plain()
    grads, grads_ref = bwd(), bwd_plain()
    torch.cuda.synchronize()
    floors = {"dq": cancel_floor(scale, hd, do, v, k),
              "dk": cancel_floor(scale, hd, do, v, q)}
    errs = {name: held(f"{tag} {name}", got, ref, dtype, floors.get(name, 0.0))
            for name, got, ref in zip(("o", "dq", "dk", "dv"), (o, *grads),
                                      (o_ref, *grads_ref))}
    lse_err = (lse - lse_ref).abs().max().item()
    print(f"  {tag} lse: max_abs_err {lse_err:.3e} (tol {LSE_TOLERANCE})")
    if not lse_err <= LSE_TOLERANCE:
        fail(f"{tag} lse: {lse_err}")
    control = None
    if dtype == "fp32":
        r = [x.to(torch.bfloat16).float() for x in (q, k, v, do)]
        o_c, lse_c = fwd_k(*r[:3], *heads, scale)
        got_c = (o_c, *bwd_k(*r[:3], o_c, r[3], lse_c, *heads, scale))
        ref_c = (o_ref, *bwd_p(q, k, v, o_ref, do, lse_ref, *heads, scale))
        verdicts = {name: compare(got, ref, dtype, floors.get(name, 0.0))
                    for name, got, ref in zip(("o", "dq", "dk", "dv"), got_c,
                                              ref_c)}
        control = {name: rel for name, (_, rel, _) in verdicts.items()}
        print(f"  {tag} control (inputs rounded to bf16): relative L2 "
              + ", ".join(f"{n} {rel:.3e} ({'within' if ok else 'outside'})"
                          for n, (_, rel, ok) in verdicts.items())
              + f" (tol {TOLERANCE[dtype][1]:g}; must fail)")
        if all(ok for _, _, ok in verdicts.values()):
            fail(f"{tag}: the fp32 tolerance passes a kernel fed bf16 inputs")

    qh, kh, vh, doh = views
    fwd_bound, bwd_bound = attention_bounds(B, N, H, hd, dtype)
    common = {"shape": list(shape), "dtype": dtype, "layout": layout}
    if control is not None:
        common["control_rel_l2"] = control
        common["control_outside"] = {n: not ok for n, (_, _, ok) in
                                     verdicts.items()}
    rows = (
        {**common, "max_abs_err": max(errs["o"], lse_err),
         "ms": device_ms(fwd, per_graph=10),
         "plain_ms": device_ms(fwd_plain),
         "library_ms": device_ms(
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 qh, kh, vh, scale=scale), per_graph=10),
         "host_ms": time_ms(fwd),
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
        {**common, "max_abs_err": max(errs[n] for n in ("dq", "dk", "dv")),
         "ms": device_ms(bwd, per_graph=10),
         "plain_ms": device_ms(bwd_plain),
         "library_ms": library_backward_ms(qh, kh, vh, doh, scale),
         "host_ms": time_ms(bwd),
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]},
    )
    for name, r in zip(names, rows):
        print(f"  {name} {dtype} {layout} {shape}: {r['ms']:.4f} ms (with "
              f"host launch {r['host_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]",
              flush=True)
    return rows


# (kernels, dtype, (B, N, H, hd), layout) of phase 2: K1/K2 at the ViT-B/14
# global and local shapes of both pretrain paths, at ViT-B/14 on 378^2
# images (N = 730, at batch 8 and 32), and at hd 16 on a small grid and at
# the vittest14 shapes of phase 3e, and in fp32 at the teacher's shape of
# phase 3f; K4/K5 at the ViT-B/14 shapes in both layouts and dtypes, and at
# the hd-16 shapes in vmem_attention's layout.
# Between them the shapes take both configurations of the fp32 hd-64
# forward (resident and streamed), and both forms of each kernel (one tile,
# several).
HD16_SHAPES = (HD16_SMALL, VITTEST_GLOBAL, VITTEST_LOCAL)
ATTENTION_CASES = [
    ("flat", dtype, shape, "flat")
    for dtype in DTYPES
    for shape in (GLOBAL, LOCAL, GLOBAL_378_B8, GLOBAL_378, *HD16_SHAPES)
] + [("flat", "fp32", TEACHER, "flat")] + [
    ("vmem", dtype, shape, layout)
    for layout in ("bnhd", "bhnd")
    for dtype in DTYPES
    for shape in (GLOBAL, LOCAL, *(HD16_SHAPES if layout == "bnhd" else ()))
]


def check_attention(A, card: str) -> dict:
    """K1/K2 and K4/K5 against their plain versions: {(kernel, dtype):
    [row, ...]} for the kernels JSON line."""
    rows = {}
    for kernels, dtype, shape, layout in ATTENTION_CASES:
        fwd, bwd = attention_case(A, card, kernels, dtype, shape, layout)
        names = ("K1", "K2") if kernels == "flat" else ("K4", "K5")
        rows.setdefault((names[0], dtype), []).append(fwd)
        rows.setdefault((names[1], dtype), []).append(bwd)
    return rows


def library_backward_ms(qh, kh, vh, doh, scale):
    """Time of PyTorch's own attention backward on the same inputs (the
    yardstick for K2 and K5): flash attention for bf16, memory-efficient
    attention for fp32 (flash takes 16-bit types only); None where this
    PyTorch build lacks it."""
    import torch

    aten = torch.ops.aten
    try:
        if qh.dtype == torch.bfloat16:
            out = aten._scaled_dot_product_flash_attention(
                qh, kh, vh, 0.0, False, False, scale=scale)
            o, lse, cq, ck, mq, mk, seed, offset = out[:8]

            def backward():
                return aten._scaled_dot_product_flash_attention_backward(
                    doh, qh, kh, vh, o, lse, cq, ck, mq, mk, 0.0, False,
                    seed, offset, scale=scale)
        else:
            o, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
                qh, kh, vh, None, True, 0.0, False, scale=scale)

            def backward():
                return aten._scaled_dot_product_efficient_attention_backward(
                    doh, qh, kh, vh, None, o, lse, seed, offset, 0.0,
                    [True, True, True, False], False, scale=scale)

        backward()
    except (RuntimeError, TypeError) as err:
        print(f"  (no attention backward yardstick: {err})")
        return None
    return device_ms(backward, per_graph=10)


def vitb_leaf_shapes():
    """Every parameter shape of ViT-B/14 + DINO and iBOT heads (65536
    prototypes), as the main path's fused update sees them."""
    import torch

    from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    with torch.device("meta"):
        wrapped = get_wrapped_model("dinov2/vitb14", dtype=torch.bfloat16)
        method = DINOv2(wrapped, DINOv2Args())
        heads = [method._head(), method._head()]
    shapes = [p.shape for p in wrapped.module.parameters()]
    for h in heads:
        shapes += [p.shape for p in h.parameters()]
    return shapes


def k3_leaves(shapes, gen):
    """(g, p, mu, nu, t) of each leaf of ``shapes`` on the card, from
    ``gen``."""
    import torch

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")

    return [[randn(shape), randn(shape), randn(shape),
             torch.rand(shape, generator=gen, device="cuda"), randn(shape)]
            for shape in shapes]


def k3_scalars(n: int, lr: float = 2e-3):
    """(n, 8) scalar rows (cs, bc1, bc2, a, wd, m, 0, 0) that differ from
    leaf to leaf."""
    import numpy as np

    s = np.tile(np.float32([0.7, 1.5, 1.1, lr, 0.04, 0.995, 0, 0]), (n, 1))
    s[:, 3] *= 1 + np.arange(n) % 3
    s[:, 4] *= np.arange(n) % 2
    return s


def k3_plain(F, leaves, table, hp, clip=None) -> list:
    """The plain version leaf by leaf on the card: new (p, mu, nu, t) of each
    leaf (a gradient of None is zeros). ``table``: the (leaves, 8) scalars
    on the card, whose column 0 the clip scale of ``clip`` overwrites; no
    copy from the host, so a CUDA graph can capture it."""
    import torch

    if clip is not None:
        table[:, 0] = F.clip_scale_plain(*clip)
    return [F.fused_adamw_ema_leaf_plain(
        torch.zeros_like(p) if g is None else g, p, mu, nu, t, s, **hp)
        for (g, p, mu, nu, t), s in zip(leaves, table)]


def check_fused_update(F, card: str) -> dict:
    """K3 against its plain version, one launch over the real ViT-B/14 +
    head leaves and synthetic ones that exercise the chunk plan (n = 1, 3,
    5, 4097, 65537, a chunk + 3, and a leaf of no gradient); with lr 0
    (the weights bitwise unchanged); and over two steps of ``FusedAdamWEMA``
    whose gradients are all reallocated in between, against the same class
    on the CPU. Then the times of the 239 ViT-B/14 leaves alone, K3 at
    several chunk sizes, and ``update_and_apply`` on the main path's model
    (``time_update.py``)."""
    import torch

    import time_update

    shapes = vitb_leaf_shapes()
    n_vit = len(shapes)
    n_params = sum(math.prod(s) for s in shapes)
    synthetic = [(1,), (3,), (5,), (4097,), (65537,), (F.CHUNK_ELEMS + 3,),
                 (768,)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    leaves = k3_leaves(shapes + synthetic, gen)
    leaves[-1][0] = None  # a leaf with no gradient
    scalars = k3_scalars(len(leaves))
    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    state = F.LeafSet(*([leaf[k] for leaf in leaves] for k in range(1, 5)))
    got = [[x.clone() for x in leaf[1:]] for leaf in leaves]
    state_got = F.LeafSet(*([leaf[k] for leaf in got] for k in range(4)))
    F.fused_adamw_ema(state_got, [leaf[0] for leaf in leaves], scalars, **hp)
    err = 0.0
    for mine, ref in zip(got, k3_plain(
            F, leaves, torch.tensor(scalars, device="cuda"), hp)):
        for a, b in zip(mine, ref):
            err = max(err, (a - b).abs().max().item())
    del got, state_got
    # lr 0 (a warm start with learning_rate=0): p' = p - 0 * u is p.
    p0 = [leaf[1].clone() for leaf in leaves]
    F.fused_adamw_ema(state, [leaf[0] for leaf in leaves],
                      k3_scalars(len(leaves), lr=0.0), **hp)
    torch.cuda.synchronize()
    lr0_bitwise = all(torch.equal(leaf[1], p) for leaf, p in zip(leaves, p0))
    del p0
    err_steps = two_steps_new_grads(F, shapes[:12] + synthetic)
    # Same fp32 arithmetic, only FMA contraction and sqrt/div rounding may
    # differ: values are O(1), so 1e-5 absolute.
    print(f"  K3 {n_vit} leaves + {len(synthetic)} synthetic, one launch: "
          f"max_abs_err {err:.3e}; two steps with new gradients "
          f"{err_steps:.3e} (tol 1e-5); lr 0 keeps p bitwise: {lr0_bitwise}")
    if not (err <= 1e-5 and err_steps <= 1e-5):
        fail(f"fused AdamW+EMA: {err}, {err_steps}")
    if not lr0_bitwise:
        fail("fused AdamW+EMA with lr 0 changed the weights")

    # Times over the 239 ViT-B/14 leaves (the main path's update).
    vit = leaves[:n_vit]
    grads = [leaf[0] for leaf in vit]
    scalars = scalars[:n_vit]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = (norm, 3.0)
    by_chunk = {}
    for chunk in (4096, 8192, 16384, 32768, 65536):
        timed = F.LeafSet(*([leaf[k] for leaf in vit] for k in range(1, 5)),
                          chunk_elems=chunk)
        table = timed.stage(grads, scalars)
        by_chunk[chunk] = device_ms(
            lambda: timed.launch(table, clip, **hp), replays=10)
    print("  K3 device ms by chunk_elems: " + ", ".join(
        f"{k} {v:.4f}" for k, v in by_chunk.items()) + f" [{card}]")
    timed = F.LeafSet(*([leaf[k] for leaf in vit] for k in range(1, 5)))
    table = timed.stage(grads, scalars)

    plain_table = torch.tensor(scalars, device="cuda")

    def plain_pass():
        k3_plain(F, vit, plain_table, hp, clip)

    # 5 fp32 reads + 4 fp32 writes and ~15 fp32 operations per parameter.
    b = bound_ms(36.0 * n_params, 15.0 * n_params, PEAK_FP32_FLOPS)
    row = {
        "leaves": n_vit, "n_params": n_params, "max_abs_err": err,
        "max_abs_err_two_steps": err_steps, "lr0_bitwise": lr0_bitwise,
        "chunk_elems": F.CHUNK_ELEMS,
        "ms": device_ms(lambda: timed.launch(table, clip, **hp), replays=10),
        "ms_by_chunk_elems": by_chunk,
        "plain_ms": device_ms(plain_pass, replays=5),
        "library_ms": None,
        "host_ms": time_ms(lambda: F.fused_adamw_ema(timed, grads, scalars,
                                                     clip, **hp), iters=10),
        "bound_ms": b[0], "bound_by": b[1],
    }
    del leaves, vit, grads, state, timed, table
    torch.cuda.empty_cache()
    # No profiler window here: it could slow the main paths' launches.
    upd = time_update.measure(profile=False)
    row.update({k: upd[k] for k in ("update_host_ms", "update_host_ms_min",
                                    "update_host_ms_max", "norm_host_ms",
                                    "update_ms")})
    print(f"  K3 all leaves: {row['ms']:.4f} ms (with the host's staging and "
          f"launch {row['host_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
          f"update_and_apply: host {row['update_host_ms']:.4f} ms (its grad "
          f"norm {row['norm_host_ms']:.4f} ms), with the card "
          f"{row['update_ms']:.4f} ms [{card}]")
    return row


def two_steps_new_grads(F, shapes) -> float:
    """Max-abs error of two ``FusedAdamWEMA`` steps on the card (K3) against
    the same on CPU copies (the plain version), with a clip norm that the
    second step's large gradients exceed, a leaf of no gradient, and every
    gradient reallocated between the steps while the old ones live (a stale
    address table would read the old ones)."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._optim import AdamWArgs

    rng = np.random.default_rng(SEED + 2)
    names = [f"leaf{i}" for i in range(len(shapes))]
    start = {n: rng.standard_normal(s).astype(np.float32)
             for n, s in zip(names, shapes)}
    runs = {}
    for device in ("cuda", "cpu"):
        params = {n: torch.tensor(v, device=device) for n, v in start.items()}
        teacher = {n: v.clone() for n, v in params.items()}
        upd = F.FusedAdamWEMA(
            AdamWArgs(lr=1e-3, weight_decay=0.04), lambda c: 1e-3 * (1 + c),
            params, grad_clip_norm=3.0, momentum_fn=lambda s: 0.99,
            lr_scales={n: 0.5 + (i % 3) for i, n in enumerate(names)})
        runs[device] = (params, teacher, upd)
    old = None
    for step in range(2):
        grads_np = {n: (rng.standard_normal(s) * (1e-4 if step == 0 else 10.0)
                        ).astype(np.float32) for n, s in zip(names, shapes)}
        for device, (params, teacher, upd) in runs.items():
            grads = {n: torch.tensor(g, device=device)
                     for n, g in grads_np.items()}
            grads[names[-1]] = None
            if device == "cuda":
                if old is not None and {g.data_ptr() for g in old if g is not
                                        None} & {g.data_ptr() for g in
                                                 grads.values() if g is not
                                                 None}:
                    fail("two-step K3 check: a gradient kept its address")
                old = list(grads.values())
            upd.update_and_apply(grads, params, teacher, step)
    torch.cuda.synchronize()
    err = 0.0
    (p_c, t_c, u_c), (p_h, t_h, u_h) = runs["cuda"], runs["cpu"]
    for a, b in ((p_c, p_h), (t_c, t_h), (u_c.mu, u_h.mu), (u_c.nu, u_h.nu)):
        for n in names:
            err = max(err, (a[n].cpu() - b[n]).abs().max().item())
    return err


def write_images(folder: Path, n: int, size: int) -> None:
    """Binary PPM images from a numpy seed: smooth colour fields plus noise,
    so crops, blur and jitter see structure."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    folder.mkdir(parents=True)
    yy, xx = np.mgrid[0:size, 0:size] / size
    for i in range(n):
        f = rng.uniform(1, 6, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([
            0.5 + 0.5 * np.sin(2 * np.pi * (f[c, 0] * yy + f[c, 1] * xx)
                               + ph[c]) for c in range(3)
        ], axis=-1) * 200 + rng.normal(0, 20, (size, size, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        header = f"P6\n{size} {size}\n255\n".encode()
        (folder / f"img_{i:03d}.ppm").write_bytes(header + img.tobytes())


def reset_counters(A, F) -> tuple:
    """Sets every launch counter to 0; returns the per-kernel counters in
    the order K1, K2, K3, K4, K5."""
    counters = (A.flat_attention_fwd, A.flat_attention_bwd,
                F.fused_adamw_ema, A.vmem_attention_fwd,
                A.vmem_attention_bwd)
    for fn in counters:
        fn.launches = 0
    for by_lib in (A.fwd_launches, A.bwd_launches):
        by_lib.update(dict.fromkeys(by_lib, 0))
    A.shape_launches.clear()
    return counters


def launches_by_shape(A) -> dict:
    """{(library, (B, N, H, hd)): launches} since the counters were set
    to 0."""
    return {(lib, (b, n, h, hd)): count
            for (lib, (b, h, n, hd)), count in A.shape_launches.items()}


def pretrain_main_path(lt, out: Path, data: Path, precision: str,
                       **kwargs):
    """``pretrain`` DINOv2 ViT-B/14 at batch 32 for STEPS steps, logging
    every step."""
    return lt.pretrain(
        out=str(out), data=str(data), model="dinov2/vitb14",
        method="dinov2", batch_size=BATCH, steps=STEPS, precision=precision,
        log_every=1, canonical_size=256, seed=SEED, **kwargs)


def logged_steps(out: Path) -> list:
    return [r for r in (json.loads(line) for line in
                        (out / "metrics.jsonl").read_text().splitlines())
            if "step" in r]


def run_main_path(lt, A, F, card: str, precision: str, work: Path) -> dict:
    """``pretrain`` DINOv2 ViT-B/14 at batch 32 in ``precision`` for STEPS
    steps into ``work / precision``, with every launch counter set to 0
    just before and read just after: K1/K2 once per block and view group,
    K3 once a step over all leaves, K4/K5 never. It checkpoints only at the end
    (``checkpoint_every=STEPS``), after the timed steps: the ~2 GiB save
    would otherwise land in a step's time."""
    import torch

    data = work / "images"
    run_dir = work / precision
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    state = pretrain_main_path(lt, run_dir, data, precision,
                               checkpoint_every=STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_library = {"fwd": dict(A.fwd_launches),
                  "bwd": dict(A.bwd_launches)}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = logged_steps(run_dir)
    saved = sorted(p.name for p in (run_dir / "checkpoints").iterdir())
    if saved != [f"step_{STEPS}.pt"]:
        fail(f"checkpoints {saved} != step_{STEPS}.pt alone")
    meta = json.loads((run_dir / "exported_models" / "exported_last"
                       / "metadata.json").read_text())
    if meta["steps"] != STEPS or meta["model_name"] != "dinov2/vitb14":
        fail(f"exported_last metadata {meta}")

    if [r["step"] for r in steps] != list(range(1, STEPS + 1)):
        fail(f"logged steps {[r['step'] for r in steps]}")
    for r in steps:
        for key in ("train_loss", "dino_loss", "ibot_loss", "koleo_loss",
                    "grad_norm"):
            if not math.isfinite(r[key]):
                fail(f"step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f} (dino "
              f"{r['dino_loss']:.4f}, ibot {r['ibot_loss']:.4f}, koleo "
              f"{r['koleo_loss']:.4f}), grad_norm {r['grad_norm']:.4f}, "
              f"{r['profiling/step_time'] * 1e3:.1f} ms, "
              f"{r['profiling/images_per_sec']:.1f} img/s [{card}]")
    expected = [36 * STEPS, 24 * STEPS, STEPS, 0, 0]
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}); peak memory {peak_gib:.2f} GiB; wall "
          f"{wall:.1f} s")
    if launches != expected:
        fail(f"launch counts {launches} != {expected}")
    # Every forward and backward of the path at hd 64 in the run's
    # dtype on the wgmma kernels of that dtype.
    check_routes(A, f"{precision} main path", by_library,
                 torch_dtype(precision), HEAD_DIM,
                 {"fwd": 36 * STEPS, "bwd": 24 * STEPS})
    student = state.params["student"]
    check_backbone(student, "dinov2/vitb14", precision, 768)
    times = [r["profiling/step_time"] for r in steps]
    return {
        "launches": launches, "launches_by_library": by_library,
        "step_ms": [t * 1e3 for t in times],
        "images_per_sec": [r["profiling/images_per_sec"] for r in steps],
        "peak_gib": peak_gib, "out": run_dir, "steps": steps,
        "student": {k: v.detach().cpu() for k, v in
                    student.state_dict().items()},
    }


def check_backbone(student, model: str, precision: str, width: int) -> None:
    """The trained backbone on a small input against an fp32 CPU reference
    (plain attention): bf16 over 12 blocks keeps the CLS features within 5%
    relative L2; fp32 (bf16 probabilities only, as on the TPU) within 1%.
    The run's dtype shows that the attention launches came from the
    kernels' fp32 form."""
    import torch

    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    tol = 5e-2 if precision == "bf16" else 1e-2
    images = torch.rand((2, 224, 224, 3), device="cuda") * 4 - 2
    with torch.no_grad():
        out = student(images)["cls_token"]
        if out.dtype != torch_dtype(precision):
            fail(f"{precision} run computed in {out.dtype}")
        got = out.float().cpu()
        ref_model = get_wrapped_model(model).module
        ref_model.load_state_dict(
            {k: v.float().cpu() for k, v in student.state_dict().items()})
        ref = ref_model(images.cpu())["cls_token"]
    rel = ((got - ref).norm() / ref.norm()).item()
    print(f"  trained {model} cls on 2 images vs fp32 CPU reference: "
          f"relative L2 {rel:.3e} (tol {tol:g})")
    if not (got.shape == (2, width) and torch.isfinite(got).all()
            and rel <= tol):
        fail(f"{model} backbone disagrees with the CPU reference: {rel}")


def run_vittest_path(lt, A, F, card: str, precision: str, work: Path) -> dict:
    """Phase 3e: ``pretrain`` DINOv2 on vittest14 (width 32, 2 heads: hd 16)
    at batch 32 for VITTEST_STEPS steps in ``precision``, on phase 3's
    images, with every launch counter set to 0 just before and read just
    after: K1 6 a step (2 blocks x 3 view groups) at VITTEST_GLOBAL and
    VITTEST_LOCAL, every one on the dtype's wgmma forward; K2 4 a step,
    every one on the dtype's wgmma backward (csrc/attention_bwd_hd16.cuh in
    flat_attention_bwd_sm90 or _f32_sm90); K3 once a step. Finite losses,
    and the trained backbone against an fp32 CPU reference."""
    import torch

    out = work / f"vittest_{precision}"
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    state = lt.pretrain(
        out=str(out), data=str(work / "images"), model="dinov2/vittest14",
        method="dinov2", batch_size=BATCH, steps=VITTEST_STEPS,
        precision=precision, log_every=1, canonical_size=256, seed=SEED,
        checkpoint_every=VITTEST_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_library = {"fwd": dict(A.fwd_launches), "bwd": dict(A.bwd_launches)}
    steps = logged_steps(out)
    if [r["step"] for r in steps] != list(range(1, VITTEST_STEPS + 1)):
        fail(f"vittest14 logged steps {[r['step'] for r in steps]}")
    for r in steps:
        for key in ("train_loss", "dino_loss", "ibot_loss", "koleo_loss",
                    "grad_norm"):
            if not math.isfinite(r[key]):
                fail(f"vittest14 step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f}, grad_norm "
              f"{r['grad_norm']:.4f}, {r['profiling/step_time'] * 1e3:.1f} "
              f"ms [{card}]")
    expected = [6 * VITTEST_STEPS, 4 * VITTEST_STEPS, VITTEST_STEPS, 0, 0]
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}); wall {wall:.1f} s")
    if launches != expected:
        fail(f"vittest14 launch counts {launches} != {expected}")
    check_routes(A, f"vittest14 {precision}", by_library,
                 torch_dtype(precision), 16,
                 {"fwd": expected[0], "bwd": expected[1]})
    check_backbone(state.params["student"], "dinov2/vittest14", precision,
                   32)
    shutil.rmtree(out)
    return {"launches": launches, "launches_by_library": by_library,
            "step_ms": [r["profiling/step_time"] * 1e3 for r in steps]}


class Interrupted(Exception):
    """Raised by the phase-3d loader after its second batch."""


def run_resume_path(lt, A, F, card: str, work: Path, ref: dict, run,
                    steps: int, keys: tuple, expected: list,
                    expected_by_library: dict, tag: str) -> dict:
    """Phase 3d (and 3f), resume: ``run(out, **kwargs)`` (a bf16 main path
    of ``steps`` steps) with ``checkpoint_every=2``, stopped after its
    step-2 checkpoint by a loader that raises when asked for a third batch,
    then resumed with ``resume_interrupted=True`` to step ``steps``; held
    against the uninterrupted run ``ref`` (the same seed, data and steps)
    on the logged ``keys`` of the resumed steps and the student. Launch
    counters are set to 0 before the first run and read after the second:
    ``expected`` (K1..K5) and ``expected_by_library``."""
    import torch

    from lightly_train_tpu_torch._checkpoint import checkpoint as C
    from lightly_train_tpu_torch._commands import train as T

    out = work / f"resume_{tag}"
    loader_cls, save = T.PretrainLoader, C.CheckpointManager.save
    saves = []

    class StopAfterTwo(loader_cls):
        def __iter__(self):
            for i, batch in enumerate(super().__iter__()):
                if i == 2:
                    raise Interrupted
                yield batch

    def timed_save(self, step, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(self, step, *args)
        saves.append((step, (time.perf_counter() - t0) * 1e3,
                      self.path(step).stat().st_size / 2 ** 30))

    counters = reset_counters(A, F)
    C.CheckpointManager.save = timed_save
    T.PretrainLoader = StopAfterTwo
    try:
        run(out, checkpoint_every=2)
        fail(f"the interrupted {tag} run was not interrupted")
    except Interrupted:
        pass
    finally:
        T.PretrainLoader = loader_cls
    try:
        saved = sorted(p.name for p in (out / "checkpoints").iterdir())
        meta = json.loads((out / "exported_models" / "exported_last"
                           / "metadata.json").read_text())
        print(f"  interrupted after step 2: checkpoints {saved}, "
              f"exported_last steps {meta['steps']}")
        if saved != ["step_2.pt"] or meta["steps"] != 2:
            fail(f"interrupted {tag} run left {saved}, exported steps "
                 f"{meta['steps']}")
        state = run(out, checkpoint_every=2, resume_interrupted=True)
        torch.cuda.synchronize()
    finally:
        C.CheckpointManager.save = save
    launches = [fn.launches for fn in counters]
    by_library = {"fwd": dict(A.fwd_launches), "bwd": dict(A.bwd_launches)}
    print(f"  launches over both runs K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}); by library {by_library} (expected "
          f"{expected_by_library})")
    if launches != expected or by_library != expected_by_library:
        fail(f"{tag} resume path launch counts {launches}, {by_library}")
    for step, ms, gib in saves:
        print(f"  checkpoint save at step {step}: {ms:.1f} ms, {gib:.3f} GiB "
              f"[{card}]")

    logged = logged_steps(out)
    if [r["step"] for r in logged] != list(range(1, steps + 1)):
        fail(f"{tag} resume path logged steps {[r['step'] for r in logged]}")
    bitwise = True
    for r, r_ref in zip(logged[2:], ref["steps"][2:]):
        for key in keys:
            rel = abs(r[key] - r_ref[key]) / max(abs(r_ref[key]), 1e-12)
            bitwise &= r[key] == r_ref[key]
            print(f"  step {r['step']} {key}: resumed {r[key]!r}, "
                  f"uninterrupted {r_ref[key]!r} (relative {rel:.3e}, tol "
                  f"1e-3)")
            if not (math.isfinite(r[key]) and rel <= 1e-3):
                fail(f"{tag} resumed step {r['step']} {key}: relative {rel}")
    student = {k: v.detach().cpu() for k, v in
               state.params["student"].state_dict().items()}
    diff = math.sqrt(sum((student[k] - v).float().pow(2).sum().item()
                         for k, v in ref["student"].items()))
    norm = math.sqrt(sum(v.float().pow(2).sum().item()
                         for v in ref["student"].values()))
    bitwise &= all(torch.equal(student[k], v)
                   for k, v in ref["student"].items())
    print(f"  resumed student vs uninterrupted: relative L2 {diff / norm:.3e}"
          f" (tol 1e-3); bitwise equal: {bitwise}")
    if not diff <= 1e-3 * norm:
        fail(f"{tag} resumed student: relative L2 {diff / norm}")
    shutil.rmtree(out)
    return {"launches": launches, "save_ms": [ms for _, ms, _ in saves],
            "bitwise": bitwise}


def distill_expected(A, precision: str, steps: int) -> tuple:
    """What ``steps`` steps of phase 3f launch: K1..K5; K1/K2 by library;
    K1/K2 by (library, shape). Per step 12 teacher forwards on the fp32
    forward at TEACHER, 12 student forwards and backwards on the run
    dtype's libraries at GLOBAL."""
    import torch

    n = 12 * steps
    dtype = torch_dtype(precision)
    teacher_fwd = A.fwd_library(torch.float32, HEAD_DIM)
    fwd, bwd = A.fwd_library(dtype, HEAD_DIM), A.bwd_library(dtype, HEAD_DIM)
    by_library = {"fwd": dict.fromkeys(A.fwd_launches, 0),
                  "bwd": dict.fromkeys(A.bwd_launches, 0)}
    by_library["fwd"][teacher_fwd] += n
    by_library["fwd"][fwd] += n
    by_library["bwd"][bwd] += n
    by_shape = {(teacher_fwd, TEACHER): n, (fwd, GLOBAL): n, (bwd, GLOBAL): n}
    return [2 * n, n, 0, 0, 0], by_library, by_shape


def distill_pretrain(lt, out: Path, data: Path, precision: str, steps: int,
                     **kwargs):
    """``pretrain`` at its defaults (no model, no method, batch and queue
    from the data) for ``steps`` steps, logging every step."""
    return lt.pretrain(out=str(out), data=str(data), steps=steps,
                       precision=precision, log_every=1, seed=SEED, **kwargs)


def write_teacher(folder: Path) -> None:
    """An exported DINOv3 ViT-B/16 with seeded weights and LayerScale 0.5,
    for ``teacher_weights``. At the random init (LayerScale 1e-5) every
    image's CLS lies within about 1e-5 of the learned token, so the queue's
    rows coincide, the loss is log Q and the gradient vanishes; this
    teacher's CLS tells the images apart, as a pretrained one does."""
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import export_model
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    module = get_wrapped_model("dinov3/vitb16").module
    module.reset_parameters(torch.Generator().manual_seed(SEED + 1))
    for name, p in module.named_parameters():
        if name.endswith("gamma"):
            p.data.fill_(0.5)
    export_model(folder, "dinov3/vitb16", module.state_dict())


def run_distillation_path(lt, A, F, card: str, precision: str, work: Path,
                          teacher: Path = None) -> dict:
    """Phase 3f: ``pretrain`` at its defaults on phase 3's 64 images for
    DISTILL_STEPS[precision] steps (with ``teacher``: its weights as
    ``teacher_weights``, the one option set), with every launch counter set
    to 0 just before and read just after. It checkpoints only at the end,
    after the timed steps."""
    import torch

    steps = DISTILL_STEPS[precision]
    tag = precision if teacher is None else f"{precision}_teacher"
    out = work / f"distill_{tag}"
    kwargs = {} if teacher is None else {
        "method_args": {"teacher_weights": str(teacher)}}
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    state = distill_pretrain(lt, out, work / "images", precision, steps,
                             checkpoint_every=steps, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_library = {"fwd": dict(A.fwd_launches), "bwd": dict(A.bwd_launches)}
    by_shape = launches_by_shape(A)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    hp = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])[
        "hyperparams"]
    resolved = {k: hp[k] for k in ("model", "method", "resolved_batch_size")}
    resolved.update(optim=hp["optim_args"]["type"],
                    teacher=hp["method_args"]["teacher"],
                    queue_size=hp["method_args"]["queue_size"])
    print(f"  defaults resolved: {resolved}, lr {hp['resolved_lr']!r}")
    want = {"model": "dinov2/vitb14", "method": "distillation",
            "resolved_batch_size": DISTILL_BATCH, "optim": "lars",
            "teacher": "dinov3/vitb16", "queue_size": DISTILL_QUEUE}
    if resolved != want or not math.isclose(
            hp["resolved_lr"], 1.8 * DISTILL_BATCH / 1536, rel_tol=1e-12):
        fail(f"pretrain defaults resolved to {resolved}, expected {want}")
    logged = logged_steps(out)
    if [r["step"] for r in logged] != list(range(1, steps + 1)):
        fail(f"distillation logged steps {[r['step'] for r in logged]}")
    for r in logged:
        for key in DISTILL_KEYS:
            if not math.isfinite(r[key]):
                fail(f"distillation step {r['step']}: {key} = {r[key]}")
        print(f"  step {r['step']}: loss {r['train_loss']:.4f} (global "
              f"{r['loss_global']:.4f}, local {r['loss_local']:.4f}), "
              f"grad_norm {r['grad_norm']:.4e}, "
              f"{r['profiling/step_time'] * 1e3:.1f} ms, "
              f"{r['profiling/images_per_sec']:.1f} img/s [{card}]")
    ms = state.method_state
    filled = min(steps * DISTILL_BATCH, DISTILL_QUEUE)
    print(f"  queue {tuple(ms['queue'].shape)}: filled {ms['queue_filled']}, "
          f"ptr {ms['queue_ptr']} (expected {filled}, "
          f"{steps * DISTILL_BATCH % DISTILL_QUEUE})")
    if (ms["queue_filled"] != filled
            or ms["queue_ptr"] != steps * DISTILL_BATCH % DISTILL_QUEUE
            or not torch.isfinite(ms["queue"]).all()
            or not (ms["queue"].norm(dim=1) > 0).all()):
        fail("distillation queue state")
    expected, expected_by_library, expected_by_shape = distill_expected(
        A, precision, steps)
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 "
          f"{launches[2]}, K4 {launches[3]}, K5 {launches[4]} (expected "
          f"{expected}); by library {by_library}; by shape {by_shape}; "
          f"peak memory {peak_gib:.2f} GiB; wall {wall:.1f} s")
    if (launches != expected or by_library != expected_by_library
            or by_shape != expected_by_shape):
        fail(f"distillation launch counts {launches}, {by_library}, "
             f"{by_shape}")
    if teacher is not None:
        # A teacher that tells the images apart: once the queue is full the
        # loss leaves 2 log Q (both terms' value where the queue's rows
        # coincide, as with a random teacher), and the gradient is no
        # longer rounding noise (a random teacher's is ~1e-6).
        uniform = 2 * math.log(DISTILL_QUEUE)
        print(f"  with teacher_weights: losses "
              f"{[r['train_loss'] for r in logged[1:]]} (2 log Q = "
              f"{uniform:.4f}), grad norms "
              f"{[r['grad_norm'] for r in logged]}")
        if (not all(r["grad_norm"] > 1e-2 for r in logged)
                or all(abs(r["train_loss"] - uniform) < 1e-3
                       for r in logged[1:])):
            fail("the exported teacher's run has nothing to learn")
    teacher = ms["teacher"]
    if (teacher.cfg.dtype != torch.float32
            or any(p.requires_grad for p in teacher.parameters())):
        fail("the teacher is not a frozen fp32 model")
    student = state.params["student"]
    check_backbone(student, "dinov2/vitb14", precision, 768)
    check_backbone(teacher, "dinov3/vitb16", "fp32", 768)
    meta = json.loads((out / "exported_models" / "exported_last"
                       / "metadata.json").read_text())
    if meta["model_name"] != "dinov2/vitb14" or meta["steps"] != steps:
        fail(f"distillation exported_last metadata {meta}")
    times = [r["profiling/step_time"] for r in logged]
    ips = [r["profiling/images_per_sec"] for r in logged]
    print(f"distillation {tag}: step ms {[t * 1e3 for t in times]}, "
          f"img/s {ips}, peak {peak_gib:.2f} GiB [{card}]", flush=True)
    return {
        "launches": launches, "by_shape": by_shape,
        "step_ms": [t * 1e3 for t in times], "images_per_sec": ips,
        "peak_gib": peak_gib, "steps": logged, "out": out,
        "student": {k: v.detach().cpu() for k, v in
                    student.state_dict().items()},
    }


def check_grid(out: Path, n_images: int) -> None:
    """Phase 3d, grid: ``augmentations.png`` of the defaults run is a PNG
    of one row per view config of the first 8 images, each at the global
    views' size (no PIL on the card: the header is read by hand)."""
    import struct

    raw = (out / "augmentations.png").read_bytes()
    if raw[:8] != b"\x89PNG\r\n\x1a\n" or raw[12:16] != b"IHDR":
        fail("augmentations.png is not a PNG")
    width, height, depth, color = struct.unpack(">IIBB", raw[16:26])
    n, size, rows = min(n_images, 8), 224, 3  # 2 global configs, 1 local
    expected = (n * size + (n - 1) * 2, rows * size, 8, 2)
    print(f"  augmentations.png: {width} x {height}, bit depth {depth}, "
          f"colour type {color} (expected {expected}), {len(raw)} bytes")
    if (width, height, depth, color) != expected:
        fail(f"augmentations.png header {(width, height, depth, color)}")


def run_embed_path(lt, A, F, card: str, work: Path, artifact: Path) -> int:
    """Phase 3d, embed: ``embed`` on the 64 images with the exported
    artifact of phase 3, fp32, batch 64, counters set to 0 just before and
    read just after: 12 K1 launches on the fp32 wgmma forward (one per
    block, under no grad), no K2, no K3. Two images' CLS against an fp32
    CPU reference loaded from the same artifact. Returns K1's launches."""
    import numpy as np
    import torch

    from lightly_train_tpu_torch._checkpoint.checkpoint import (
        load_exported_model,
    )
    from lightly_train_tpu_torch._data.image_dataset import (
        ImageDataset,
        list_image_files,
    )
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    kwargs = dict(data=str(work / "images"), checkpoint=str(artifact),
                  image_size=224, batch_size=2 * BATCH, precision="fp32",
                  format="npz")
    counters = reset_counters(A, F)
    t0 = time.perf_counter()
    path = lt.embed(out=str(work / "embeddings.npz"), **kwargs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    by_library = dict(A.fwd_launches)
    print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, "
          f"K4 {launches[3]}, K5 {launches[4]} (expected [12, 0, 0, 0, 0])")
    if launches != [12, 0, 0, 0, 0]:
        fail(f"embed launch counts {launches}")
    check_routes(A, "fp32 embed", {"fwd": by_library}, torch.float32,
                 HEAD_DIM, {"fwd": 12})
    emb = np.load(path)["embeddings"]
    if emb.shape != (2 * BATCH, 768) or not np.isfinite(emb).all():
        fail(f"embeddings {emb.shape}, finite {np.isfinite(emb).all()}")
    t0 = time.perf_counter()
    lt.embed(out=str(work / "embeddings_again.npz"), **kwargs)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0

    model = get_wrapped_model("dinov2/vitb14").module
    model.load_state_dict(load_exported_model(artifact)["state_dict"])
    dataset = ImageDataset(list_image_files(work / "images"), (224, 224))
    images = torch.from_numpy(np.stack([dataset[0], dataset[1]]))
    with torch.no_grad():
        ref = model(images.float() / 255.0)["cls_token"].numpy()
    rel = float(np.linalg.norm(emb[:2] - ref) / np.linalg.norm(ref))
    print(f"  embed {emb.shape} finite; CLS of 2 images vs fp32 CPU "
          f"reference: relative L2 {rel:.3e} (tol 1e-2)")
    if not rel <= 1e-2:
        fail(f"embed disagrees with the CPU reference: {rel}")
    print(f"  embed of {2 * BATCH} images (artifact load, PPM decode, "
          f"forward, npz): first call {first_s:.3f} s, second "
          f"{again_s:.3f} s = {2 * BATCH / again_s:.1f} img/s [{card}]")
    return launches[0]


def check_routes(A, tag: str, by_library: dict, dtype, head_dim: int,
                 expected: dict):
    """Fails unless every launch counted in ``by_library`` ({"fwd": {library:
    n}, "bwd": ...}) went to the library ``dtype`` routes to at
    ``head_dim``, with ``expected[direction]`` launches."""
    for direction, n in expected.items():
        route = getattr(A, f"{direction}_library")(dtype, head_dim)
        got = by_library[direction]
        print(f"  {tag}: {direction} launches by library {got} (expected "
              f"all {n} on {route})")
        if got != {**dict.fromkeys(got, 0), route: n}:
            fail(f"{tag}: {direction} launches by library {got}")


def run_vmem_path(A, card: str, dtype: str) -> dict:
    """The K4/K5 path: ``vmem_attention`` over (B, N, H, hd) and
    ``vmem_attention_bhnd`` over real (B, H, N, hd) tensors, forward and
    backward through autograd as a user calls them, at the ViT-B/14 global
    shape, with the launch counters set to 0 just before and read just
    after; the results against the plain versions."""
    import torch

    from lightly_train_tpu_torch.ops.kernels import vmem_attention

    B, N, H, hd = GLOBAL
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)

    def randn(shape, grad):
        x = torch.randn(shape, generator=gen, device="cuda").to(
            torch_dtype(dtype))
        return x.requires_grad_() if grad else x

    api = [randn((B, N, H, hd), i < 3) for i in range(4)]
    bhnd = [randn((B, H, N, hd), i < 3) for i in range(4)]
    counters = (A.vmem_attention_fwd, A.vmem_attention_bwd,
                A.flat_attention_fwd, A.flat_attention_bwd)
    for fn in counters:
        fn.launches = 0
    for by_lib in (A.fwd_launches, A.bwd_launches):
        by_lib.update(dict.fromkeys(by_lib, 0))
    t0 = time.perf_counter()
    out_api = vmem_attention(*api[:3])
    grads_api = torch.autograd.grad((out_api * api[3]).sum(), api[:3])
    out_bhnd = A.vmem_attention_bhnd(*bhnd[:3])
    grads_bhnd = torch.autograd.grad((out_bhnd * bhnd[3]).sum(), bhnd[:3])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = [fn.launches for fn in counters]
    print(f"  {dtype}: launches K4 {launches[0]}, K5 {launches[1]}, K1 "
          f"{launches[2]}, K2 {launches[3]} (expected [2, 2, 0, 0]); "
          f"{wall_ms:.1f} ms for both calls with their backward [{card}]")
    if launches != [2, 2, 0, 0]:
        fail(f"vmem_attention path launches {launches}")
    check_routes(A, f"vmem_attention {dtype}",
                 {"fwd": dict(A.fwd_launches), "bwd": dict(A.bwd_launches)},
                 torch_dtype(dtype), hd, {"fwd": 2, "bwd": 2})
    scale = hd ** -0.5
    for layout, (q, k, v, co), out, grads in (
            ("bnhd", [x.transpose(1, 2) for x in api],
             out_api.transpose(1, 2), [g.transpose(1, 2) for g in grads_api]),
            ("bhnd", bhnd, out_bhnd, grads_bhnd)):
        q, k, v = (x.detach() for x in (q, k, v))
        o_ref, lse_ref = A.vmem_attention_fwd_plain(q, k, v, scale)
        refs = A.vmem_attention_bwd_plain(q, k, v, out.detach(), co, lse_ref,
                                          scale)
        floors = {"dq": cancel_floor(scale, hd, co, v, k),
                  "dk": cancel_floor(scale, hd, co, v, q)}
        for name, got, ref in zip(("o", "dq", "dk", "dv"), (out, *grads),
                                  (o_ref, *refs)):
            if not torch.isfinite(got).all():
                fail(f"vmem_attention {dtype} {layout} {name} is not finite")
            held(f"vmem_attention {dtype} {layout} {name}", got.detach(), ref,
                 dtype, floors.get(name, 0.0))
    return {"K4": launches[0], "K5": launches[1]}


def profile_steps(card: str, precision: str, method_name: str = "dinov2",
                  steps: int = 3) -> None:
    """Optional (``--profile``): where a main path's step time goes.

    Runs the pretraining step of ``run_main_path`` (``method_name``
    "dinov2": batch BATCH, the fused update) or of
    ``run_distillation_path`` ("distillation": batch DISTILL_BATCH, queue
    DISTILL_QUEUE, LARS on the unfused update) in ``precision``, on one
    fixed uint8 batch on the card (no host data loading), for 2 warm-up
    steps and ``steps`` profiled steps under ``torch.profiler``, and prints
    the device's busy share and the kernels that take the most device time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lightly_train_tpu_torch._commands.train_loop import make_train_step
    from lightly_train_tpu_torch._optim import cosine_warmup
    from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
    from lightly_train_tpu_torch._optim.update import build_update
    from lightly_train_tpu_torch.methods.base import TrainState
    from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
    from lightly_train_tpu_torch.methods.distillationv3 import (
        DistillationV3,
        DistillationV3Args,
    )
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    dev = torch.device("cuda")
    dtype = torch_dtype(precision)
    wrapped = get_wrapped_model("dinov2/vitb14", dtype=dtype)
    if method_name == "dinov2":
        method, build, batch = DINOv2(wrapped, DINOv2Args()), \
            build_fused_updater, BATCH
    else:
        method, build, batch = DistillationV3(wrapped, DistillationV3Args(
            queue_size=DISTILL_QUEUE)), build_update, DISTILL_BATCH
    params, method_state = method.init(torch.Generator().manual_seed(SEED),
                                       dev)
    named = dict(params.named_parameters())
    updater = build(method, method.default_optimizer_args(),
                    cosine_warmup(1e-3, 1000, 10), named, 1000)
    state = TrainState(0, params, method_state, updater)
    step = make_train_step(method, 1000, aug_dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    images = torch.randint(0, 256, (batch, 256, 256, 3), dtype=torch.uint8,
                           device=dev, generator=gen)
    for _ in range(2):
        step(state, images, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, images, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0.0, 0])
            k[0] += evt.time_range.elapsed_us() / 1e3 / steps  # ms/step
            k[1] += 1
    busy_ms = sum(v[0] for v in kernels.values())
    print(f"profile {method_name} {precision}: {steps} steps, wall {wall_ms:.1f} ms/step, "
          f"device busy "
          f"{busy_ms:.1f} ms/step ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(v[1] for v in kernels.values()) // steps} kernel launches "
          f"per step [{card}]")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {ms:8.3f} ms/step {n // steps:5d} launches  {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import lightly_train_tpu_torch as lt
    except ImportError as err:
        print(f"chip_smoke: the port is not here: {err}", file=sys.stderr)
        return 1
    if Path(lt.__file__).resolve().parent.parent != ROOT:
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    from lightly_train_tpu_torch import _native
    from lightly_train_tpu_torch._optim import fused_update as F
    from lightly_train_tpu_torch.ops.kernels import attention as A

    if not A.use_vmem_attention():
        fail("LIGHTLY_TRAIN_VMEM_ATTENTION disables the attention kernels; "
             "this check runs them")
    # The plain versions' fp32 products in full fp32, not TF32.
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    built = _native.build()
    print(f"phase 1: built {sorted(built)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in _native.LIBRARIES:
        log = (_native.BUILD_DIR / f"{name}.log").read_text()
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "wgmma",
                                       "Compiling entry")):
                print(f"  {name}: {line.strip()}")
        if name in SM90_LIBRARIES and any(w in log for w in SERIALIZED):
            fail(f"ptxas serialized the wgmma products of {name}")
    for name in _native.LIBRARIES:
        sass = _native.sass(name)
        required = SM90_LIBRARIES.get(name, ())
        print(f"  {name}: {sass.count('HGMMA')} HGMMA, "
              f"{sass.count('LDGSTS')} LDGSTS (cp.async) and "
              f"{sass.count(WARP_MMA)} {WARP_MMA} (mma.sync) instructions in "
              f"its SASS (required: {', '.join(required) or 'none'}; "
              f"{WARP_MMA} none)", flush=True)
        missing = [op for op in required if op not in sass]
        if missing:
            fail(f"{name}'s SASS lacks {missing}")
        if WARP_MMA in sass:
            fail(f"{name}'s SASS holds {WARP_MMA} (mma.sync)")

    print("phase 2: kernels against their plain versions", flush=True)
    attn = check_attention(A, card)
    upd = check_fused_update(F, card)

    work_dir = tempfile.TemporaryDirectory()
    work = Path(work_dir.name)
    write_images(work / "images", 2 * BATCH, 256)
    paths = {}
    for phase, precision in zip(("3", "3b"), DTYPES):
        print(f"phase {phase}: main path (pretrain DINOv2 ViT-B/14, batch "
              f"{BATCH}, {precision})", flush=True)
        paths[precision] = run_main_path(lt, A, F, card, precision, work)
        r = paths[precision]
        print(f"main path {precision}: step ms {r['step_ms']}, img/s "
              f"{r['images_per_sec']}, peak {r['peak_gib']:.2f} GiB [{card}]")
    shutil.rmtree(paths["fp32"]["out"])
    print("phase 3c: the K4/K5 path (vmem_attention, ViT-B/14 global shape)",
          flush=True)
    vmem = {dtype: run_vmem_path(A, card, dtype) for dtype in DTYPES}
    print("phase 3d: resume, augmentation grid and embed", flush=True)
    bf16_out = paths["bf16"]["out"]
    check_grid(bf16_out, 2 * BATCH)
    shutil.rmtree(bf16_out / "checkpoints")  # only its metrics serve now
    run_resume_path(
        lt, A, F, card, work, paths["bf16"],
        lambda out, **kw: pretrain_main_path(lt, out, work / "images",
                                             "bf16", **kw),
        STEPS, ("train_loss", "dino_loss", "ibot_loss", "koleo_loss"),
        [36 * STEPS, 24 * STEPS, STEPS, 0, 0],
        {"fwd": {**dict.fromkeys(A.fwd_launches, 0),
                 A.fwd_library(torch.bfloat16, HEAD_DIM): 36 * STEPS},
         "bwd": {**dict.fromkeys(A.bwd_launches, 0),
                 A.bwd_library(torch.bfloat16, HEAD_DIM): 24 * STEPS}},
        "dinov2")
    embed_k1 = run_embed_path(
        lt, A, F, card, work, bf16_out / "exported_models" / "exported_last")
    vittest = {}
    for precision in DTYPES:
        print(f"phase 3e: pretrain DINOv2 vittest14 (hd 16), batch {BATCH}, "
              f"{VITTEST_STEPS} steps, {precision}", flush=True)
        vittest[precision] = run_vittest_path(lt, A, F, card, precision,
                                              work)
    distill = {}
    for precision in DTYPES:
        print(f"phase 3f: pretrain at its defaults (distillation, ViT-B/14 "
              f"from DINOv3 ViT-B/16, LARS), batch {DISTILL_BATCH}, "
              f"{DISTILL_STEPS[precision]} steps, {precision}", flush=True)
        distill[precision] = run_distillation_path(lt, A, F, card, precision,
                                                   work)
    shutil.rmtree(distill["fp32"]["out"])
    teacher = work / "teacher"
    write_teacher(teacher)
    print(f"phase 3f: the same with teacher_weights (an exported DINOv3 "
          f"ViT-B/16, LayerScale 0.5), bf16", flush=True)
    distill["bf16_teacher"] = run_distillation_path(lt, A, F, card, "bf16",
                                                    work, teacher)
    steps = DISTILL_STEPS["bf16"]
    expected, by_library, _ = distill_expected(A, "bf16", steps)
    for key, args in (("bf16", {}), ("bf16_teacher", {
            "method_args": {"teacher_weights": str(teacher)}})):
        print(f"phase 3f: resume of the {key} distillation run", flush=True)
        run_resume_path(
            lt, A, F, card, work, distill[key],
            lambda out, args=args, **kw: distill_pretrain(
                lt, out, work / "images", "bf16", steps, **args, **kw),
            steps, DISTILL_KEYS[:3], expected, by_library,
            f"distillation_{key}")
    work_dir.cleanup()

    # Launches: each wrapper's count over the path that runs it (K1/K2: the
    # pretrain path of the row's dtype, at the global and local shapes of
    # ViT-B/14 (phases 3, 3b) and of vittest14 (phase 3e); K4/K5: phase 3c,
    # at the global shape), 0 for shapes no path runs.
    kernels = []
    for (kernel, dtype), rows in attn.items():
        name, direction, line = KERNELS[kernel]
        route = getattr(A, f"{direction}_library")
        if kernel in ("K4", "K5"):
            by_shape = {tuple(GLOBAL): vmem[dtype][kernel]}
        else:
            i = ("K1", "K2").index(kernel)
            by_shape = dict.fromkeys((GLOBAL, LOCAL),
                                     paths[dtype]["launches"][i])
            by_shape.update(dict.fromkeys((VITTEST_GLOBAL, VITTEST_LOCAL),
                                          vittest[dtype]["launches"][i]))
        # Phase 3f's launches of this kernel's library at each shape, per
        # run: the teacher's K1 at TEACHER (fp32 in both runs), the
        # student's K1/K2 at GLOBAL (in its run's dtype).
        library = {"fwd": A.fwd_library, "bwd": A.bwd_library}[direction]
        lib = library(torch_dtype(dtype), HEAD_DIM)
        distill_runs = {
            shape: {p: distill[p]["by_shape"].get((lib, shape), 0)
                    for p in DTYPES}
            for shape in (TEACHER, GLOBAL)} if kernel in ("K1", "K2") else {}
        by_shape[TEACHER] = sum(distill_runs.get(TEACHER, {}).values())
        kernels += [{
            "name": name, "route": "cuda",
            "source": "lightly_train_tpu_torch/csrc/" + (
                f"attention_{direction}_hd16.cuh" if row["shape"][3] == 16
                else route(torch_dtype(dtype), row["shape"][3]) + ".cu"),
            "replaces": f"lightly_train_tpu/ops/pallas/attention.py:{line}",
            "launches": by_shape.get(tuple(row["shape"]), 0),
            # embed's fp32 forwards (phase 3d) run at the global shape.
            **({"launches_embed": embed_k1}
               if (kernel, dtype) == ("K1", "fp32")
               and row["shape"] == list(GLOBAL) else {}),
            **({"launches_distillation": distill_runs[tuple(row["shape"])],
                "launches_distillation_per_step": {
                    p: n / DISTILL_STEPS[p] for p, n in
                    distill_runs[tuple(row["shape"])].items()}}
               if tuple(row["shape"]) in distill_runs else {}),
            **row,
        } for row in rows]
    kernels.append({
        "name": "fused_adamw_ema", "route": "cuda",
        "source": "lightly_train_tpu_torch/csrc/fused_adamw_ema.cu",
        "replaces": "lightly_train_tpu/_optim/fused_update.py:95",
        "launches": paths["bf16"]["launches"][2],
        "launches_fp32": paths["fp32"]["launches"][2],
        "launches_per_step": paths["bf16"]["launches"][2] / STEPS,
        "launches_distillation": {p: distill[p]["launches"][2]
                                  for p in DTYPES}, **upd,
    })
    if "--profile" in sys.argv[1:]:
        for method in ("dinov2", "distillation"):
            for precision in DTYPES:
                print(f"phase 4: profile of the {method} pretraining step "
                      f"({precision})", flush=True)
                profile_steps(card, precision, method)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
