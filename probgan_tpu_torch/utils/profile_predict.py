"""Where the time of ``InferenceEngine.predict_tails`` goes on the card.

Profiles predict_tails calls (64 pairs, top_k 10) against a seeded
checkpoint of 1,000,000 entities (embed 128, noise 64, hidden 1024, 1,000
relations) with ``torch.profiler`` and prints the device time by part of
the path, the device's idle share over the host's wall time, the host time
of the steps before and after the device work, and one JSON line:

    python -m probgan_tpu_torch.utils.profile_predict [--trace PATH.json]

Parts: the ``rank_topk`` kernel, the candidate merge (the stable sort and
gather of ``top_k_lowest_index``), the generator MLP's products, the copies
between host and device, and the elementwise rest (gathers, concat,
LeakyReLU). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import tempfile
import time

import numpy as np
import torch

from probgan_tpu_torch.core.checkpoint import save_checkpoint
from probgan_tpu_torch.engine import InferenceEngine
from probgan_tpu_torch.engine import inference
from probgan_tpu_torch.utils.demo_checkpoint import make_kg_checkpoint

ENTITIES, RELATIONS = 1_000_000, 1_000
BATCH, TOP_K, CALLS = 64, 10, 20


def _part(name: str) -> str:
    low = name.lower()
    if "rank_topk_kernel" in low:
        return "rank_topk_kernel"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(s in low for s in ("sort", "radix", "gather", "bitonic")):
        return "merge_sort_gather"
    if any(s in low for s in ("gemm", "sgemm", "cutlass", "xmma", "gemv")):
        return "generator_mlp_products"
    return "elementwise_and_other"


def _host_steps(engine, pairs) -> dict:
    """Host clock of the per-call steps that run before the device work."""
    n = 200
    out = {}
    t0 = time.perf_counter()
    for _ in range(n):
        inference._check_ids([p[0] for p in pairs], engine.num_entities, "entity")
        inference._check_ids([p[1] for p in pairs], engine.num_relations, "relation")
        inference._pad_ids([p[0] for p in pairs], BATCH)
        inference._pad_ids([p[1] for p in pairs], BATCH)
    out["check_and_pad_ids_ms"] = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        engine._rng.normal("profile", (BATCH, engine.noise_dim))
    out["noise_draw_cpu_ms"] = (time.perf_counter() - t0) / n * 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace", default=None, help="write a Chrome trace here")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(1)
    pairs = [(int(h), int(r)) for h, r in zip(rng.integers(0, ENTITIES, BATCH),
                                              rng.integers(0, RELATIONS, BATCH))]
    quiet = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "best_checkpoint.pt")
        save_checkpoint(path, make_kg_checkpoint(ENTITIES, RELATIONS, seed=0))
        with contextlib.redirect_stdout(quiet):
            engine = InferenceEngine(path, device="cuda", seed=0)

    def call():
        with contextlib.redirect_stdout(quiet):
            return engine.predict_tails(pairs, top_k=TOP_K, return_scores=True)

    for _ in range(3):  # warm-up: kernel build, cuBLAS handles
        call()
    torch.cuda.synchronize()

    # host clock without the profiler (it adds host time to every op)
    times = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    plain_wall_ms = float(np.median(times)) * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            call()  # returns host lists: the call has finished
        wall_us = (time.perf_counter() - t0) * 1e6
    if args.trace:
        prof.export_chrome_trace(args.trace)

    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("probgan/"):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        print("profile_predict: the profiler recorded no device time")
        return 1
    parts: dict[str, float] = {}
    for name, us in by_name.items():
        parts[_part(name)] = parts.get(_part(name), 0.0) + us
    busy_us = sum(parts.values())
    busy_ms = busy_us / CALLS / 1e3
    host = _host_steps(engine, pairs)

    print(f"{CALLS} predict_tails calls, {BATCH} pairs, top_k {TOP_K}, N = {ENTITIES:,}: "
          f"p50 wall {plain_wall_ms:.3f} ms per call without the profiler "
          f"({BATCH / plain_wall_ms * 1e3:.0f} queries/s), "
          f"{wall_us / CALLS / 1e3:.3f} ms with it; device busy {busy_ms:.3f} ms per call, "
          f"idle share {1 - busy_ms / plain_wall_ms:.4f} of the unprofiled wall time")
    for part, us in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"  {part:26s} {us / CALLS / 1e3:9.4f} ms/call  {us / busy_us:7.2%}")
    print(f"host steps per call: {host}")
    print("top device entries:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / CALLS / 1e3:9.4f} ms/call  {name[:110]}")
    print(json.dumps({
        "batch": BATCH, "top_k": TOP_K, "entities": ENTITIES, "calls": CALLS,
        "p50_wall_ms_per_call": plain_wall_ms,
        "profiled_wall_ms_per_call": wall_us / CALLS / 1e3,
        "device_busy_ms_per_call": busy_ms,
        "idle_share": 1 - busy_ms / plain_wall_ms,
        "parts_ms_per_call": {k: v / CALLS / 1e3 for k, v in parts.items()},
        "host_steps_ms_per_call": host,
        "device": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
