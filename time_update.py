#!/usr/bin/env python3
"""Time the PyTorch port's fused AdamW + EMA update (K3) as the main path
calls it, on one NVIDIA card.

    python3 time_update.py [ROOT]

ROOT is the root of a checkout whose ``lightly_train_tpu_torch`` is timed
(default: the directory of this file), so that two trees can be compared in
one run on one card. The script builds the main path's model on the card
(DINOv2 on ViT-B/14 with its two heads: 239 leaves, 132.0 M parameters,
random weights from seed 0) and its fused updater, gives every parameter a
random gradient, and measures ``FusedAdamWEMA.update_and_apply``:

- ``update_host_ms``: the host's time of one call, started with the card
  idle and with no synchronisation inside (what the update costs the host on
  the main path), over 20 calls: median, min and max;
- ``norm_host_ms``: the same for the grad norm alone (``global_norm``, the
  first part of the call);
- ``update_ms``: one call with the card's work, from CUDA events around 10
  calls in a row;
- with ``profile``, ``kernels`` and ``memcpys``: launches per call on the
  card, and ``device_ms``, their device time per call, from
  ``torch.profiler`` over 5 calls; ``kernel_names``: launches per call by
  kernel name. The profile comes last, and ``chip_smoke.py`` leaves it
  out: once a profiler window has run, later launches of the process may
  be slower.

Prints the card's name and power limit, then one JSON line. Without a CUDA
card it prints no result and exits with 1.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def measure(calls: int = 20, profile: bool = True) -> dict:
    """The numbers above for the ``lightly_train_tpu_torch`` on sys.path."""
    import torch
    from torch.profiler import ProfilerActivity

    from lightly_train_tpu_torch._optim import cosine_warmup
    from lightly_train_tpu_torch._optim.fused_update import (
        build_fused_updater,
        global_norm,
    )
    from lightly_train_tpu_torch.methods.dinov2 import DINOv2, DINOv2Args
    from lightly_train_tpu_torch.models.package_registry import (
        get_wrapped_model,
    )

    dev = torch.device("cuda")
    method = DINOv2(get_wrapped_model("dinov2/vitb14", dtype=torch.bfloat16),
                    DINOv2Args())
    params, method_state = method.init(torch.Generator().manual_seed(0), dev)
    named = dict(params.named_parameters())
    teacher = dict(method_state["teacher"].named_parameters())
    updater = build_fused_updater(method, method.default_optimizer_args(),
                                  cosine_warmup(1e-3, 1000, 10), named, 1000)
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = {n: 1e-3 * torch.randn(p.shape, generator=gen, device=dev)
             for n, p in named.items()}

    def call():
        updater.update_and_apply(grads, named, teacher, updater.count)

    def host_ms(fn) -> list:
        for _ in range(3):
            fn()
        times = []
        for _ in range(calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    host = host_ms(call)
    norm_host = host_ms(lambda: global_norm(grads.values()))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        call()
    end.record()
    torch.cuda.synchronize()
    update_ms = start.elapsed_time(end) / 10
    out = {
        "leaves": len(named),
        "n_params": sum(p.numel() for p in named.values()),
        "update_host_ms": statistics.median(host),
        "update_host_ms_min": min(host), "update_host_ms_max": max(host),
        "norm_host_ms": statistics.median(norm_host),
        "update_ms": update_ms,
    }
    if not profile:
        return out
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    kernels = memcpys = 0
    device_ms = 0.0
    names: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if evt.name.startswith(("Memcpy", "Memset")):
                memcpys += 1
            else:
                kernels += 1
                names[evt.name[:80]] = names.get(evt.name[:80], 0) + 1
            device_ms += evt.time_range.elapsed_us() / 1e3
    return {**out, "kernels": kernels / 5, "memcpys": memcpys / 5,
            "device_ms": device_ms / 5,
            "kernel_names": {k: v / 5 for k, v in names.items()}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_update: no CUDA device", file=sys.stderr)
        return 1
    root = Path(sys.argv[1] if len(sys.argv) > 1 else __file__).resolve()
    root = root if root.is_dir() else root.parent
    sys.path.insert(0, str(root))
    import lightly_train_tpu_torch as lt

    if Path(lt.__file__).resolve().parent.parent != root:
        print(f"time_update: no port under {root}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(json.dumps({"tree": str(root), **measure()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
