"""Where the time of ``ImageGANEngine.score`` goes on the card.

Profiles three 1024² score calls at batch 8 (default config, random weights
from a seed, the grade ``--precision``, "high" by default, images the
engine's own generator made) with
``torch.profiler`` and prints the device time by part of the path, the
device's idle share over the host's wall time, the peak device memory of a
call, and one JSON line:

    python -m probgan_tpu_torch.utils.profile_score [--precision fast] [--trace PATH.json]

Parts: the two discriminator kernels by name (``packed_conv`` with the
"lrelu" epilogue, ``packed_convpool``; at "fast" their kernel mode "mid",
``packed_conv_bf16``, ``packed_convpool_bf16``), the cuDNN convolutions (fromRGB and
stages 6-0), the copy of the images to the card, other copies, and the
elementwise rest (LeakyReLU, pools of the unpacked stages, the layout
permute, minibatch stddev, weight prep). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from probgan_tpu_torch.engine import ImageGANEngine
from probgan_tpu_torch.models.pro_gan import ProGANConfig

_KERNELS = ("packed_convpool", "packed_conv", "packed_convpool_bf16", "packed_conv_bf16")
BATCH = 8
CALLS = 3


def _part(name: str) -> str:
    for k in _KERNELS:  # packed_convpool before its prefix packed_conv
        if f"{k}_kernel" in name:
            return k
    low = name.lower().replace(" ", "")
    if "memcpy" in low and "htod" in low:
        return "copy_to_device"
    if "memcpy" in low or "memset" in low:
        return "other_copies"
    if any(s in low for s in ("conv", "gemm", "xmma", "cudnn", "implicit")):
        return "cudnn_conv_and_dense"
    return "elementwise_and_other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--precision", default="high", choices=["fast", "high", "highest"],
                    help="the engine's grade ('fast': D's packed stages at kernel mode 'mid')")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)

    engine = ImageGANEngine(ProGANConfig(), device="cuda", precision=args.precision)
    images = engine.generate(engine.sample_latents(BATCH)).astype(np.float32) / 127.5 - 1.0
    for _ in range(2):  # warm-up: kernel build, cuDNN plans
        engine.score(images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.score(images)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            engine.score(images)  # returns host numpy: the call has finished
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_name: dict[str, float] = {}
    for e in prof.events():
        # task_trace ranges also show on the device timeline: they span the
        # kernels inside them and are not device work of their own
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("probgan/"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        print("profile_score: the profiler recorded no device time")
        return 1
    parts: dict[str, float] = {}
    for name, us in by_name.items():
        parts[_part(name)] = parts.get(_part(name), 0.0) + us
    busy_us = sum(parts.values())

    print(f"{CALLS} score calls at {args.precision!r}, batch {BATCH}, 1024²: wall "
          f"{wall_us / 1e3:.3f} ms, "
          f"device busy {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}, "
          f"peak device memory {peak_gb:.3f} GB")
    for part, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {part:26s} {us / CALLS / 1e3:9.3f} ms/call  {us / busy_us:7.2%}")
    print("top device entries:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / CALLS / 1e3:9.3f} ms/call  {name[:110]}")
    print(json.dumps({
        "batch": BATCH, "calls": CALLS, "precision": args.precision,
        "wall_ms_per_call": wall_us / CALLS / 1e3,
        "device_busy_ms_per_call": busy_us / CALLS / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "peak_device_memory_gb": peak_gb,
        "parts_ms_per_call": {k: v / CALLS / 1e3 for k, v in parts.items()},
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
