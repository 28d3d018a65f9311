#!/usr/bin/env python3
"""Time the PyTorch port's attention kernels (K1/K2, K4/K5) on one NVIDIA
card, at the shapes of ``PERF.md``'s kernel table.

    python3 time_attention.py [ROOT] [--hd128]

ROOT is the root of a checkout whose ``lightly_train_tpu_torch`` is timed
(default: the directory of this file), so that two trees can be compared in
one run on one card (parent, change, change, parent). ``--hd128`` times the
hd-128 rows alone. Rows (B, N, H, hd):

- hd 64: K1/K2 (flat layout) at ViT-B/14's global and local shapes, at
  N = 730 (batch 8 and 32) and at fine-tuning's (batch 128, 16 and 8 at
  N = 257), K4/K5 (``vmem_attention_fwd``/``_bwd``) in
  both per-head layouts at the global and local shapes;
- hd 16: K1/K2 and K4/K5 (the (B, N, H, hd) views ``vmem_attention`` hands
  over) at (8, 257, 2, 16) and at vittest14's pretrain shapes at batch 32,
  global (64, 257, 2, 16) and local (256, 37, 2, 16);
- hd 128, forward and backward: K1/K2 and K4/K5 (``vmem_attention``'s
  (B, N, H, hd) views) at ``chip_smoke.HD128_SHAPES`` (the 7B/16's N =
  201, the 7B/14's N = 257, N = 37 and N = 730), and K4/K5 on (B, H, N,
  hd) tensors at the 7B/14 embed shape, each beside one PyTorch call on
  the same inputs (``library_ms``): SDPA for the forward, aten's flash
  (bf16) or memory-efficient (fp32) attention backward for the backward
  (``chip_smoke.library_backward_ms``), and the kernel's plain PyTorch
  version (``plain_ms``);

each in bf16 and fp32, as device time (``chip_smoke.device_ms``: ten calls
captured in a CUDA graph, replayed). The inputs are random, from a seed; the
kernels are not checked here (``chip_smoke.py`` does that).

Prints the card's name and power limit, one line a row, then one JSON line.
Without a CUDA card it prints no result and exits with 1.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
GLOBAL_B14, LOCAL_B14 = (64, 257, 12, 64), (256, 37, 12, 64)
# Fine-tuning's shapes (phase 3r of chip_smoke.py): classification at its
# default batch of 128, the linear probe's batch of 16, the fp32 check's 8.
FINETUNE = ((128, 257, 12, 64), (16, 257, 12, 64), (8, 257, 12, 64))
ROWS_64 = ([("flat", s) for s in (GLOBAL_B14, LOCAL_B14, (16, 730, 12, 64),
                                   (64, 730, 12, 64), *FINETUNE)]
           + [(layout, s) for layout in ("bnhd", "bhnd")
              for s in (GLOBAL_B14, LOCAL_B14)])
HD16 = ((8, 257, 2, 16), (64, 257, 2, 16), (256, 37, 2, 16))
ROWS_16 = [(layout, s) for layout in ("flat", "bnhd") for s in HD16]


def inputs(layout: str, shape: tuple, dtype, gen):
    """q, k, v, do in ``layout``: flat (B, N, H hd), or (B, H, N, hd) real
    ("bhnd") or as views of (B, N, H, hd) tensors ("bnhd")."""
    import torch

    B, N, H, hd = shape
    full = {"flat": (B, N, H * hd), "bhnd": (B, H, N, hd),
            "bnhd": (B, N, H, hd)}[layout]
    xs = [torch.randn(full, generator=gen, device="cuda").to(dtype)
          for _ in range(4)]
    return [x.transpose(1, 2) for x in xs] if layout == "bnhd" else xs


def rows_128(smoke) -> list:
    """(layout, shape) of the hd-128 rows."""
    return ([(layout, s) for layout in ("flat", "bnhd")
             for s in smoke.HD128_SHAPES] + [("bhnd", smoke.EMBED_7B)])


def measure_128(smoke, rows) -> list:
    """The hd-128 rows: the forward (K1, K4) beside SDPA and the backward
    (K2, K5) beside aten's attention backward on the same inputs, for the
    ``lightly_train_tpu_torch`` on sys.path."""
    import torch

    from lightly_train_tpu_torch.ops.kernels import attention as A

    out = []
    for dtype in ("bf16", "fp32"):
        dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
        for layout, shape in rows:
            gen = torch.Generator(device="cuda").manual_seed(sum(shape))
            q, k, v, do = inputs(layout, shape, dt, gen)
            scale = shape[3] ** -0.5
            if layout == "flat":
                names, heads = ("K1", "K2"), (shape[2],)
                fwd_k, bwd_k = A.flat_attention_fwd, A.flat_attention_bwd
                fwd_p = A.flat_attention_fwd_plain
                bwd_p = A.flat_attention_bwd_plain
                views = [A._heads(x, shape[2]) for x in (q, k, v, do)]
            else:
                names, heads = ("K4", "K5"), ()
                fwd_k, bwd_k = A.vmem_attention_fwd, A.vmem_attention_bwd
                fwd_p = A.vmem_attention_fwd_plain
                bwd_p = A.vmem_attention_bwd_plain
                views = [q, k, v, do]
            o, lse = fwd_k(q, k, v, *heads, scale)
            times = (
                (smoke.device_ms(lambda: fwd_k(q, k, v, *heads, scale),
                                 per_graph=10),
                 smoke.device_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         *views[:3], scale=scale), per_graph=10)),
                (smoke.device_ms(
                    lambda: bwd_k(q, k, v, o, do, lse, *heads, scale),
                    per_graph=10),
                 smoke.library_backward_ms(*views, scale)),
            )
            plain = (smoke.device_ms(lambda: fwd_p(q, k, v, *heads, scale)),
                     smoke.device_ms(
                         lambda: bwd_p(q, k, v, o, do, lse, *heads, scale)))
            for name, (ms, library), plain_ms in zip(names, times, plain):
                out.append({"kernel": name, "dtype": dtype, "layout": layout,
                            "shape": list(shape), "ms": ms,
                            "library_ms": library, "plain_ms": plain_ms})
                lib = "n/a" if library is None else f"{library:.4f} ms"
                print(f"  {name} {dtype} {layout} {shape}: {ms:.4f} ms, "
                      f"library {lib}, plain {plain_ms:.4f} ms", flush=True)
            del q, k, v, do, o, lse, views
    return out


def measure(device_ms) -> list:
    """The hd-64 and hd-16 rows above for the ``lightly_train_tpu_torch`` on
    sys.path, timed by ``device_ms``."""
    import torch

    from lightly_train_tpu_torch.ops.kernels import attention as A

    out = []
    for dtype in ("bf16", "fp32"):
        dt = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
        for layout, shape in ROWS_64 + ROWS_16:
            gen = torch.Generator(device="cuda").manual_seed(sum(shape))
            q, k, v, do = inputs(layout, shape, dt, gen)
            scale = shape[3] ** -0.5
            if layout == "flat":
                heads, names = (shape[2],), ("K1", "K2")
                fwd_k, bwd_k = A.flat_attention_fwd, A.flat_attention_bwd
            else:
                heads, names = (), ("K4", "K5")
                fwd_k, bwd_k = A.vmem_attention_fwd, A.vmem_attention_bwd
            o, lse = fwd_k(q, k, v, *heads, scale)
            times = (
                device_ms(lambda: fwd_k(q, k, v, *heads, scale),
                          per_graph=10),
                device_ms(lambda: bwd_k(q, k, v, o, do, lse, *heads, scale),
                          per_graph=10),
            )
            for name, ms in zip(names, times):
                out.append({"kernel": name, "dtype": dtype, "layout": layout,
                            "shape": list(shape), "ms": ms})
                print(f"  {name} {dtype} {layout} {shape}: {ms:.4f} ms",
                      flush=True)
            del q, k, v, do, o, lse
    return out


def main() -> int:
    import importlib.util
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if a != "--hd128"]
    only_128 = "--hd128" in sys.argv[1:]
    root = Path(args[0] if args else HERE).resolve()
    # The timing of this directory's chip_smoke.py, whatever ROOT holds.
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(root))
    import lightly_train_tpu_torch

    if Path(lightly_train_tpu_torch.__file__).resolve().parent.parent != root:
        print(f"time_attention: no port under {root}", file=sys.stderr)
        return 1
    from lightly_train_tpu_torch import _native

    # The attention libraries, one nvcc each, in parallel.
    _native.build([name for name in _native.LIBRARIES if "attention" in name])
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; port under {root}", flush=True)
    rows = [] if only_128 else measure(smoke.device_ms)
    rows += measure_128(smoke, rows_128(smoke))
    print(json.dumps({"root": str(root), "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
