"""Where the time of ``ImageGANEngine.generate`` goes on the card.

Profiles three 1024² generate calls at batch 8 (default config, random
weights from a seed, grade "high" unless ``--precision`` names another) with
``torch.profiler`` and prints the device time by part of the path, the
device's idle share over the host's wall time, and one JSON line:

    python -m probgan_tpu_torch.utils.profile_generate [--trace PATH.json]
        [--precision default|fast|high|highest] [--fmap_base N --fmap_max M]

``--fmap_base`` / ``--fmap_max`` (the trainer CLIs' flags) profile another
1024² generator: ``--fmap_base 2048 --fmap_max 256`` is the narrow one whose
packed stages 6-8 run the kernels at 32, 16 and 8 channels.

With ``--first-call`` it instead times single calls (host clock) in the
steady state, right after ``torch.cuda.empty_cache()`` and right after one
``score`` call of the same engine, with the count of ``cudaMalloc`` calls
each took: what a call costs when the caching allocator's pool has changed
since the last one.

Parts: the late-stage kernels by name (under ``PROBGAN_STAGE_FUSED=1``, read
at each call, the two stage-fused kernels in place of the three; at "fast"
and "default" the three bf16 kernels, ``*_bf16``, or the two stage-fused
ones, ``packed_upconv_conv_bf16`` and ``packed_upconv_conv_rgb_bf16``), the cuDNN
convolutions of the stages before the packed ones, the copy of the images to the host, other copies,
and the elementwise rest (parity-conv interleave, epilogues, weight prep).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time

import torch

from probgan_tpu_torch.engine import ImageGANEngine
from probgan_tpu_torch.models.pro_gan import ProGANConfig, packed_start_stage

# prefixes after the names that hold them
_KERNELS = ("packed_upconv_bf16", "packed_conv_rgb_bf16", "packed_conv_bf16", "packed_upconv",
            "packed_conv_rgb", "packed_conv")
BATCH = 8
CALLS = 3


def _part(name: str, cudnn: str = "cudnn_conv_stages_0_6") -> str:
    """The part of the path a device entry belongs to; ``cudnn`` names the
    cuDNN convolutions of the stages before the packed ones."""
    fused = re.search(r"fused_kernel<\d+, ?(\d)>", name)  # csrc/fused_ring.cuh: <COUT, TAIL>
    if fused:
        return "packed_upconv_conv" if fused.group(1) == "0" else "packed_upconv_conv_rgb"
    # csrc/fused_bf16.cuh: <COUT, NTERM, TAIL>
    fused = re.search(r"fused_bf16_kernel<\d+, ?(\d), ?(\d)>", name)
    if fused:
        kernel = "packed_upconv_conv" if fused.group(2) == "0" else "packed_upconv_conv_rgb"
        return f"{kernel}_{'bf16' if fused.group(1) == '1' else 'mid'}"
    for k in _KERNELS:
        if f"{k}_kernel" in name:
            return k
    if "memcpy" in name.lower() and "dtoh" in name.lower().replace(" ", ""):
        return "copy_to_host"
    if "memcpy" in name.lower() or "memset" in name.lower():
        return "other_copies"
    low = name.lower()
    if any(s in low for s in ("conv", "gemm", "xmma", "cudnn", "implicit")):
        return cudnn
    return "elementwise_and_other"


def first_call(engine: ImageGANEngine, z: torch.Tensor) -> int:
    """Single generate calls after the allocator's pool has changed."""
    def timed(label: str, calls: int) -> list[dict]:
        out = []
        for _ in range(calls):
            mallocs = torch.cuda.memory_stats()["num_device_alloc"]
            t0 = time.perf_counter()
            engine.generate(z)
            ms = (time.perf_counter() - t0) * 1e3
            out.append({"ms": ms, "cuda_mallocs":
                        torch.cuda.memory_stats()["num_device_alloc"] - mallocs})
        print(f"{label:28s} " + "  ".join(
            f"{c['ms']:.1f} ms ({c['cuda_mallocs']} cudaMalloc)" for c in out))
        return out

    result = {"steady": timed("steady state", 4)}
    torch.cuda.empty_cache()
    result["after_empty_cache"] = timed("after empty_cache()", 4)
    images = engine.generate(z).astype("float32") / 127.5 - 1.0
    engine.score(images)
    engine.score(images)
    result["after_score"] = timed("after two score calls", 4)
    print(json.dumps({"batch": BATCH, "first_call": result,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    ap.add_argument("--first-call", action="store_true",
                    help="time single calls after the allocator's pool changed instead")
    ap.add_argument("--precision", default="high",
                    choices=["default", "fast", "high", "highest"],
                    help="the serving grade ('default' is the grade None)")
    ap.add_argument("--fmap_base", type=int, default=None, help="the config's fmap_base")
    ap.add_argument("--fmap_max", type=int, default=None, help="the config's fmap_max")
    args = ap.parse_args(argv)

    precision = None if args.precision == "default" else args.precision
    widths = {k: v for k, v in (("fmap_base", args.fmap_base), ("fmap_max", args.fmap_max))
              if v is not None}
    cfg = ProGANConfig(**widths)
    s0 = packed_start_stage(cfg, cfg.num_stages - 1)
    cudnn = "cudnn_conv_stages_0_6" if s0 is None else f"cudnn_conv_stages_0_{s0 - 1}"
    engine = ImageGANEngine(cfg, device="cuda", precision=precision)
    z = engine.sample_latents(BATCH)
    for _ in range(2):  # warm-up: kernel build, cuDNN plans
        engine.generate(z)
    torch.cuda.synchronize()
    if args.first_call:
        return first_call(engine, z)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            engine.generate(z)  # returns host numpy: the call has finished
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
        print("profile_generate: the profiler recorded no device time")
        return 1
    parts: dict[str, float] = {}
    for name, us in by_name.items():
        part = _part(name, cudnn)
        parts[part] = parts.get(part, 0.0) + us
    busy_us = sum(parts.values())

    print(f"{CALLS} generate calls, batch {BATCH}, 1024²: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, idle "
          f"share {1 - busy_us / wall_us:.4f}")
    for part, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {part:26s} {us / CALLS / 1e3:9.3f} ms/call  {us / busy_us:7.2%}")
    print("top device entries:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / CALLS / 1e3:9.3f} ms/call  {name[:110]}")
    print(json.dumps({
        "batch": BATCH, "calls": CALLS, "precision": args.precision,
        "fmap_base": cfg.fmap_base, "fmap_max": cfg.fmap_max, "packed_from_stage": s0,
        "stage_fused": os.environ.get("PROBGAN_STAGE_FUSED", "0") == "1",
        "wall_ms_per_call": wall_us / CALLS / 1e3,
        "device_busy_ms_per_call": busy_us / CALLS / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "parts_ms_per_call": {k: v / CALLS / 1e3 for k, v in parts.items()},
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
