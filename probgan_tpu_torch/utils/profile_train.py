"""Where the time of a train step goes on the card.

Profiles three ``progan_train_step`` calls at 1024², stage 8, batch 2
(default config, random weights from a seed, ``packed_d = packed_g = True``,
``remat=True``, ``packed_train_mode`` from ``--packed_mode``, "highest" by
default, ``dtype`` from ``--dtype``, fp32 by default; ``--packed_mode default
--dtype bf16`` is the image trainer's ``--fast``; ``--fmap_base 2048
--fmap_max 256``, the trainer CLIs' flags, profile the narrow 1024²
generator N instead, packed stages 6-8) with ``torch.profiler``,
or with ``--kg`` three
``kg_train_step`` calls at 1,000,000 entities (batch 1,024, corrupted
negatives, 8,192 sampled-softmax negatives), and prints the device time by
part of the step, the device's idle share over the host's wall time, the
host's own largest entries, the peak device memory of a step, and one JSON
line:

    python -m probgan_tpu_torch.utils.profile_train [--kg] [--packed_mode default] [--dtype bf16]
        [--fmap_base N --fmap_max M] [--trace PATH.json]

Parts of the image step: the conv kernels by name (``packed_conv_wgrad``
with its reduction pass, ``packed_conv`` and its 3xTF32 "none" kernel
``packed_conv[none]``, ``packed_convpool``, ``packed_upconv``, and at
``--packed_mode default`` or ``mid`` their bf16 kernels ``*_bf16``), the cuDNN
convolutions and dense products of the unpacked stages (forward, backward
and the recompute of ``remat``), copies, and the
elementwise rest (LeakyReLU and PixelNorm and their backward, the masks and
bias gradients of ops/packed_vjp.py, pools, weight prep, Adam). Parts of the
KG step: the dense products, Adam over the tables, gathers and scatters,
and the elementwise rest. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from probgan_tpu_torch.engine import train
from probgan_tpu_torch.models.pro_gan import ProGANConfig

# packed_conv_wgrad and packed_convpool before their prefix packed_conv;
# packed_conv's "none" epilogue is a kernel of its own (3xTF32)
_KERNELS = ("packed_conv_wgrad", "packed_convpool", "packed_conv_rgb", "packed_conv_none",
            "packed_conv", "packed_upconv", "packed_convpool_bf16", "packed_conv_bf16",
            "packed_upconv_bf16", "packed_conv_wgrad_bf16")
CALLS = 3
BATCH, STAGE = 2, 8
KG = dict(num_entities=1_000_000, num_relations=1_000, embed_dim=128, noise_dim=64,
          hidden_dim=1024)
KG_BATCH, KG_CE_NEGATIVES = 1024, 8192


def _part(name: str) -> str:
    for k in _KERNELS:
        if f"{k}_kernel" in name or f"{k}_reduce_kernel" in name:
            return "packed_conv[none]" if k == "packed_conv_none" else k
    low = name.lower().replace(" ", "")
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(s in low for s in ("conv", "gemm", "gemv", "xmma", "cudnn", "implicit", "cutlass",
                              "wgrad", "dgrad")):
        return "cudnn_conv_and_dense"
    if "multi_tensor" in low or "foreach" in low:
        return "adam"
    if any(s in low for s in ("index", "gather", "scatter", "embedding")):
        return "gather_scatter"
    return "elementwise_and_other"


def _image_step(mode: str, dtype: torch.dtype, widths: dict):
    cfg = ProGANConfig(**widths)
    state = train.progan_init_state(0, cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    real = torch.tanh(torch.randn((BATCH, cfg.resolution, cfg.resolution, 3), device="cuda",
                                  generator=gen))
    z = torch.randn((BATCH, cfg.latent_dim), device="cuda", generator=gen)

    def step(st):
        st, m = train.progan_train_step(st, real, z, 1.0, cfg, STAGE, dtype=dtype, packed_d=True,
                                        packed_g=True, remat=True, packed_train_mode=mode)
        float(m["g_loss"])  # reads the card: the step has finished
        return st

    return state, step, (f"progan_train_step, 1024², fmap_base {cfg.fmap_base}, fmap_max "
                         f"{cfg.fmap_max}, stage {STAGE}, batch {BATCH}, {mode}, "
                         f"{str(dtype).removeprefix('torch.')}")


def _kg_step():
    state = train.kg_init_state(0, device="cuda", **KG)
    rng = np.random.default_rng(2)

    def ids(high, *shape):
        return torch.from_numpy(rng.integers(0, high, shape)).cuda()

    n, e, r = KG_BATCH, KG["num_entities"], KG["num_relations"]
    triplets = torch.stack([ids(e, n), ids(r, n), ids(e, n)], 1)
    negatives = torch.stack([ids(e, n), ids(r, n)], 1)
    ce_neg = ids(e, KG_CE_NEGATIVES)
    noise = torch.Generator(device="cuda").manual_seed(3)

    def step(st):
        st, m = train.kg_train_step(st, triplets, noise, negatives=negatives,
                                    ce_negatives=ce_neg)
        float(m["g_loss"])
        return st

    return state, step, (f"kg_train_step, {e:,} entities, batch {n}, "
                         f"{KG_CE_NEGATIVES} sampled negatives")


def profile_steps(step, state, calls: int):
    """Run ``calls`` steps under ``torch.profiler``: (state, wall us, {device
    kernel name: us over the calls}, the profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            state = step(state)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("probgan/"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return state, wall_us, by_name, prof


def parts_of(by_name: dict[str, float]) -> dict[str, float]:
    """Device time by part of the step (``_part``)."""
    parts: dict[str, float] = {}
    for name, us in by_name.items():
        parts[_part(name)] = parts.get(_part(name), 0.0) + us
    return parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kg", action="store_true", help="profile kg_train_step instead")
    ap.add_argument("--packed_mode", default="highest",
                    choices=["default", "mid", "high", "highest"],
                    help="packed_train_mode of the image step")
    ap.add_argument("--dtype", default="fp32", choices=["fp32", "bf16"],
                    help="dtype of the image step")
    ap.add_argument("--fmap_base", type=int, default=None, help="the config's fmap_base")
    ap.add_argument("--fmap_max", type=int, default=None, help="the config's fmap_max")
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    widths = {k: v for k, v in (("fmap_base", args.fmap_base), ("fmap_max", args.fmap_max))
              if v is not None}
    state, step, label = (_kg_step() if args.kg
                          else _image_step(args.packed_mode, dtype, widths))
    for _ in range(2):  # warm-up: kernel build, cuDNN plans
        state = step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = step(state)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    state, wall_us, by_name, prof = profile_steps(step, state, CALLS)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    if not by_name:
        print("profile_train: the profiler recorded no device time")
        return 1
    parts = parts_of(by_name)
    busy_us = sum(parts.values())

    print(f"{CALLS} steps of {label}: wall {wall_us / CALLS / 1e3:.3f} ms/step, device busy "
          f"{busy_us / CALLS / 1e3:.3f} ms/step, idle share {1 - busy_us / wall_us:.4f}, "
          f"peak device memory {peak_gb:.3f} GB")
    for part, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {part:26s} {us / CALLS / 1e3:9.3f} ms/step  {us / busy_us:7.2%}")
    print("top device entries:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
        print(f"  {us / CALLS / 1e3:9.3f} ms/step  {name[:110]}")
    print("top host entries (self CPU time):")
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        print(f"  {e.self_cpu_time_total / CALLS / 1e3:9.3f} ms/step  x{e.count // CALLS:<5d} "
              f"{e.key[:90]}")
    print(json.dumps({
        "step": label, "calls": CALLS,
        "wall_ms_per_step": wall_us / CALLS / 1e3,
        "device_busy_ms_per_step": busy_us / CALLS / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "peak_device_memory_gb": peak_gb,
        "parts_ms_per_step": {k: v / CALLS / 1e3 for k, v in parts.items()},
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
