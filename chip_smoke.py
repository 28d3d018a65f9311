#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Build every CUDA kernel of the DINOv2 pretraining path from ``csrc/``
   (one ``nvcc`` per source, in parallel).
2. Hold each kernel against its plain PyTorch version on the card, at the
   shapes the ViT-B/14 main path gives it, and time kernel, plain version
   and the nearest single PyTorch call (``library_ms``). Those times are
   device times (calls captured in a CUDA graph and replayed); ``host_ms``
   is the kernel's time with its host-side launch (Python, ctypes,
   argument checks) included.
3. Run the main path: ``pretrain`` with DINOv2 on ViT-B/14 at batch 32 in
   bf16 for 4 steps on a folder of generated PPM images, with every launch
   counter set to 0 just before and read just after; check finite losses,
   the launch counts, and the trained backbone against an fp32 CPU
   reference on a small input.

``--profile`` adds a phase 4: a ``torch.profiler`` window over a few
training steps, printing the device's busy share and the kernels that take
the most device time.

Prints the card's name and power limit, one JSON line with every kernel's
results, and as the last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout of the repository, it prints no result
and exits with 1.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor peak
PEAK_FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SEED = 0
BATCH = 32
STEPS = 4
GLOBAL = (2 * BATCH, 257)  # (B, N) of the global views: 2 views x batch
LOCAL = (8 * BATCH, 37)  # 8 local views at 96^2: 6 x 6 patches + CLS
HEADS, HEAD_DIM = 12, 64


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


def check_attention(A, card: str) -> list:
    """K1/K2 against their plain versions at the global and local shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    D = HEADS * HEAD_DIM
    scale = HEAD_DIM ** -0.5
    rows = {"fwd": [], "bwd": []}
    for (B, N) in (GLOBAL, LOCAL):
        q, k, v, do = (
            torch.randn((B, N, D), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(4)
        )
        o, lse = A.flat_attention_fwd(q, k, v, HEADS, scale)
        o_ref, lse_ref = A.flat_attention_fwd_plain(q, k, v, HEADS, scale)
        grads = A.flat_attention_bwd(q, k, v, o, do, lse, HEADS, scale)
        grads_ref = A.flat_attention_bwd_plain(q, k, v, o, do, lse, HEADS,
                                               scale)
        torch.cuda.synchronize()
        # Tolerances: bf16 outputs may differ by a few bf16 ulps at the top
        # of their range (a probability near a bf16 rounding boundary can
        # round the other way when the fp32 sums are taken in another
        # order): max-abs within 2^-7 of the largest reference magnitude,
        # and relative L2 within 1e-2, which a systematic error on a few
        # rows (a dropped or mis-scaled key on the ragged edge) exceeds;
        # lse by 5e-3 (fp32, __expf, reordered sums).
        checks = {
            "o": (o, o_ref), "dq": (grads[0], grads_ref[0]),
            "dk": (grads[1], grads_ref[1]), "dv": (grads[2], grads_ref[2]),
        }
        errs = {}
        for name, (got, ref) in checks.items():
            diff = got.float() - ref.float()
            err = diff.abs().max().item()
            tol = 2.0 ** -7 * ref.float().abs().max().item()
            rel = (diff.norm() / ref.float().norm()).item()
            errs[name] = err
            print(f"  K1/K2 {name} B={B} N={N}: max_abs_err {err:.3e} "
                  f"(tol {tol:.3e}), relative L2 {rel:.3e} (tol 1e-2)")
            if not (err <= tol and rel <= 1e-2):
                fail(f"flat attention {name} at B={B} N={N}: max-abs {err} "
                     f"(tol {tol}), relative L2 {rel} (tol 1e-2)")
        lse_err = (lse - lse_ref).abs().max().item()
        print(f"  K1 lse B={B} N={N}: max_abs_err {lse_err:.3e} (tol 5e-3)")
        if not lse_err <= 5e-3:
            fail(f"flat attention lse at B={B} N={N}: {lse_err}")

        qh, kh, vh, doh = (x.view(B, N, HEADS, HEAD_DIM).transpose(1, 2)
                           for x in (q, k, v, do))
        flops = 4.0 * B * HEADS * N * N * HEAD_DIM
        elem = B * N * D
        fwd_bound = bound_ms(4 * elem * 2 + B * HEADS * N * 4, flops)
        kernel_fwd = lambda: A.flat_attention_fwd(q, k, v, HEADS, scale)
        fwd = {
            "shape": [B, N, D], "max_abs_err": max(errs["o"], lse_err),
            "ms": device_ms(kernel_fwd, per_graph=10),
            "plain_ms": device_ms(
                lambda: A.flat_attention_fwd_plain(q, k, v, HEADS, scale)),
            "library_ms": device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh), per_graph=10),
            "host_ms": time_ms(kernel_fwd),
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
        }
        bwd_bound = bound_ms(8 * elem * 2 + B * HEADS * N * 4, 2.5 * flops)
        kernel_bwd = lambda: A.flat_attention_bwd(
            q, k, v, o, do, lse, HEADS, scale)
        bwd = {
            "shape": [B, N, D],
            "max_abs_err": max(errs["dq"], errs["dk"], errs["dv"]),
            "ms": device_ms(kernel_bwd, per_graph=10),
            "plain_ms": device_ms(lambda: A.flat_attention_bwd_plain(
                q, k, v, o, do, lse, HEADS, scale)),
            "library_ms": flash_backward_ms(qh, kh, vh, doh, scale),
            "host_ms": time_ms(kernel_bwd),
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
        }
        rows["fwd"].append(fwd)
        rows["bwd"].append(bwd)
        for tag, r in (("K1", fwd), ("K2", bwd)):
            print(f"  {tag} B={B} N={N}: {r['ms']:.4f} ms (with host launch "
                  f"{r['host_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} "
                  f"ms ({r['bound_by']}) [{card}]")
    return rows


def flash_backward_ms(qh, kh, vh, doh, scale):
    """Time of PyTorch's own flash-attention backward on the same inputs
    (the yardstick for K2), or None where this PyTorch build lacks it."""
    import torch

    aten = torch.ops.aten
    try:
        out = aten._scaled_dot_product_flash_attention(
            qh, kh, vh, 0.0, False, False, scale=scale)
        o, lse, cq, ck, mq, mk, seed, offset = out[:8]

        def backward():
            return aten._scaled_dot_product_flash_attention_backward(
                doh, qh, kh, vh, o, lse, cq, ck, mq, mk, 0.0, False, seed,
                offset, scale=scale)

        backward()
    except (RuntimeError, TypeError) as err:
        print(f"  (no flash-attention backward yardstick: {err})")
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


def check_fused_update(F, card: str) -> dict:
    """K3 against its plain version on the real ViT-B/14 + head leaves."""
    import torch

    shapes = vitb_leaf_shapes()
    n_params = sum(math.prod(s) for s in shapes)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    leaves = []
    for i, shape in enumerate(shapes):
        g, p, mu, t = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4))
        nu = torch.rand(shape, generator=gen, device="cuda")
        s = torch.tensor([0.7, 1.5, 1.1, 2e-3 * (1 + i % 3), 0.04 * (i % 2),
                          0.995, 0.0, 0.0], device="cuda")
        leaves.append((g, p, mu, nu, t, s))
    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    err = 0.0
    for g, p, mu, nu, t, s in leaves:
        ref = F.fused_adamw_ema_leaf_plain(g, p, mu, nu, t, s, **hp)
        got = [x.clone() for x in (p, mu, nu, t)]
        F.fused_adamw_ema_leaf(g, *got, s, **hp)
        for a, b in zip(got, ref):
            err = max(err, (a - b).abs().max().item())
    torch.cuda.synchronize()
    # Same fp32 arithmetic, only FMA contraction and sqrt/div rounding may
    # differ: values are O(1), so 1e-5 absolute.
    print(f"  K3 {len(shapes)} leaves, {n_params} parameters: max_abs_err "
          f"{err:.3e} (tol 1e-5)")
    if not err <= 1e-5:
        fail(f"fused AdamW+EMA: {err}")

    def kernel_pass():
        for g, p, mu, nu, t, s in leaves:
            F.fused_adamw_ema_leaf(g, p, mu, nu, t, s, **hp)

    def plain_pass():
        for g, p, mu, nu, t, s in leaves:
            F.fused_adamw_ema_leaf_plain(g, p, mu, nu, t, s, **hp)

    # 5 fp32 reads + 4 fp32 writes and ~15 fp32 operations per parameter.
    b = bound_ms(36.0 * n_params, 15.0 * n_params, PEAK_FP32_FLOPS)
    row = {
        "leaves": len(shapes), "n_params": n_params, "max_abs_err": err,
        "ms": device_ms(kernel_pass, replays=10),
        "plain_ms": device_ms(plain_pass, replays=5),
        "library_ms": None, "host_ms": time_ms(kernel_pass, iters=10),
        "bound_ms": b[0], "bound_by": b[1],
    }
    print(f"  K3 all leaves: {row['ms']:.4f} ms (with host launches "
          f"{row['host_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]")
    return row


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


def run_main_path(lt, A, F, card: str) -> dict:
    import torch

    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "images"
        write_images(data, 2 * BATCH, 256)
        out = Path(tmp) / "out"
        torch.cuda.reset_peak_memory_stats()
        counters = (A.flat_attention_fwd, A.flat_attention_bwd,
                    F.fused_adamw_ema_leaf)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        state = lt.pretrain(
            out=str(out), data=str(data), model="dinov2/vitb14",
            method="dinov2", batch_size=BATCH, steps=STEPS, precision="bf16",
            log_every=1, canonical_size=256, seed=SEED,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        records = [json.loads(line) for line in
                   (out / "metrics.jsonl").read_text().splitlines()]
        steps = [r for r in records if "step" in r]
        if not (out / "checkpoints" / "last.pt").exists():
            fail("no checkpoints/last.pt")
        n_leaves = len(list(state.params.parameters()))

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
        expected = [36 * STEPS, 24 * STEPS, n_leaves * STEPS]
        print(f"  launches K1 {launches[0]}, K2 {launches[1]}, K3 "
              f"{launches[2]} (expected {expected}); peak memory "
              f"{peak_gib:.2f} GiB; wall {wall:.1f} s")
        if launches != expected:
            fail(f"launch counts {launches} != {expected}")

        # The trained backbone on a small input against an fp32 CPU
        # reference (plain attention): bf16 over 12 blocks keeps the CLS
        # features within 5% relative L2.
        student = state.params["student"]
        images = torch.rand((2, 224, 224, 3), device="cuda") * 4 - 2
        with torch.no_grad():
            got = student(images)["cls_token"].float().cpu()
            ref_model = get_wrapped_model("dinov2/vitb14").module
            ref_model.load_state_dict(
                {k: v.float().cpu() for k, v in student.state_dict().items()})
            ref = ref_model(images.cpu())["cls_token"]
        rel = ((got - ref).norm() / ref.norm()).item()
        print(f"  trained ViT-B/14 cls on 2 images vs fp32 CPU reference: "
              f"relative L2 {rel:.3e} (tol 5e-2)")
        if not (got.shape == (2, 768) and torch.isfinite(got).all()
                and rel <= 5e-2):
            fail(f"backbone disagrees with the CPU reference: {rel}")
        times = [r["profiling/step_time"] for r in steps]
        return {
            "launches": launches, "n_leaves": n_leaves,
            "step_ms": [t * 1e3 for t in times],
            "images_per_sec": [r["profiling/images_per_sec"] for r in steps],
            "peak_gib": peak_gib,
        }


def profile_steps(card: str, steps: int = 3) -> None:
    """Optional (``--profile``): where the main path's step time goes.

    Runs the pretraining step of ``run_main_path`` (same model, method,
    batch and dtype; one fixed uint8 batch on the card, so no host data
    loading) for 2 warm-up steps and ``steps`` profiled steps under
    ``torch.profiler``, and prints the device's busy share and the kernels
    that take the most device time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lightly_train_tpu_torch._commands.train_loop import make_train_step
    from lightly_train_tpu_torch._optim import cosine_warmup
    from lightly_train_tpu_torch._optim.fused_update import build_fused_updater
    from lightly_train_tpu_torch.methods.base import TrainState
    from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    dev = torch.device("cuda")
    method = DINOv2(get_wrapped_model("dinov2/vitb14", dtype=torch.bfloat16),
                    DINOv2Args())
    params, method_state = method.init(torch.Generator().manual_seed(SEED),
                                       dev)
    named = dict(params.named_parameters())
    updater = build_fused_updater(method, method.default_optimizer_args(),
                                  cosine_warmup(1e-3, 1000, 10), named, 1000)
    state = TrainState(0, params, method_state, updater)
    step = make_train_step(method, 1000, aug_dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    images = torch.randint(0, 256, (BATCH, 256, 256, 3), dtype=torch.uint8,
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
    print(f"profile: {steps} steps, wall {wall_ms:.1f} ms/step, device busy "
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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    print("phase 2: kernels against their plain versions", flush=True)
    attn = check_attention(A, card)
    upd = check_fused_update(F, card)

    print("phase 3: main path (pretrain DINOv2 ViT-B/14, batch 32, bf16)",
          flush=True)
    main_path = run_main_path(lt, A, F, card)
    print(f"main path: step ms {main_path['step_ms']}, img/s "
          f"{main_path['images_per_sec']}, peak {main_path['peak_gib']:.2f} "
          f"GiB [{card}]")

    def attn_row(name, rows, launches, src, replaces):
        g, l = rows
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(g["max_abs_err"], l["max_abs_err"]),
            "ms": g["ms"] + l["ms"], "plain_ms": g["plain_ms"] + l["plain_ms"],
            "host_ms": g["host_ms"] + l["host_ms"],
            "bound_ms": g["bound_ms"] + l["bound_ms"],
            "bound_by": g["bound_by"],
            "library_ms": (None if g["library_ms"] is None
                           or l["library_ms"] is None
                           else g["library_ms"] + l["library_ms"]),
            "shapes": {"global": g, "local": l},
        }

    kernels = [
        attn_row("flat_attention_fwd", attn["fwd"], main_path["launches"][0],
                 "lightly_train_tpu_torch/csrc/flat_attention_fwd.cu",
                 "lightly_train_tpu/ops/pallas/attention.py:241"),
        attn_row("flat_attention_bwd", attn["bwd"], main_path["launches"][1],
                 "lightly_train_tpu_torch/csrc/flat_attention_bwd.cu",
                 "lightly_train_tpu/ops/pallas/attention.py:265"),
        {
            "name": "fused_adamw_ema", "route": "cuda",
            "source": "lightly_train_tpu_torch/csrc/fused_adamw_ema.cu",
            "replaces": "lightly_train_tpu/_optim/fused_update.py:95",
            "launches": main_path["launches"][2], **upd,
        },
    ]
    if "--profile" in sys.argv[1:]:
        print("phase 4: profile of the pretraining step", flush=True)
        profile_steps(card)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
