"""Times the two kernels that carry the fp32 ranking above top_k 16 and the
train step's input gradients, and the train step itself, on one CUDA card:

- ``rank_scores_fused`` at N = 1,000,000, D = 128, B = 64 and 8;
- ``packed_conv(..., epilogue="none")`` at the (C, Cout, H) the 1024² train
  step gives it, batch 2;
- ``progan_train_step`` at 1024², stage 8, batch 2, packed, ``remat``:
  steps/s and p50 over timed steps (host clock to the metrics on the host).

It calls only public entry points, so the same file times an older tree of
the package: put that tree first on ``PYTHONPATH`` and run this file by its
path. Prints the card's name and power limit and one JSON line::

    python3 probgan_tpu_torch/utils/bench_kernels.py [--steps 6]
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import numpy as np
import torch

from probgan_tpu_torch.engine import train
from probgan_tpu_torch.models.pro_gan import ProGANConfig
from probgan_tpu_torch.ops import packed as pk
from probgan_tpu_torch.ops import rank as rank_ops
from probgan_tpu_torch.ops import rank_fused as rf

CONV_SHAPES = ((32, 32, 1024), (64, 32, 1024), (64, 64, 512), (128, 64, 512),
               (32, 64, 1024), (64, 128, 512))


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6, help="timed train steps (after 2 warm-up)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA card")
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {"card": card, "package": pk.__file__, "rank_scores_ms": {}, "none_ms": {}}

    table = rank_ops.l2_normalize(torch.randn((1_000_000, 128), device="cuda", generator=gen))
    for b in (64, 8):
        pred = torch.randn((b, 128), device="cuda", generator=gen)
        out["rank_scores_ms"][f"B{b}"] = cuda_ms(lambda: rf.rank_scores_fused(pred, table))
    del table

    with torch.no_grad():
        for c, cout, h in CONV_SHAPES:
            x = torch.randn((2, c, h, h), device="cuda", generator=gen)
            w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
            b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            out["none_ms"][f"C{c}->Cout{cout}@{h}"] = cuda_ms(
                lambda: pk.packed_conv(x, w, b, epilogue="none"), iters=10)
            del x

    cfg = ProGANConfig()
    state = train.progan_init_state(0, cfg, device="cuda")
    real = torch.tanh(torch.randn((2, cfg.resolution, cfg.resolution, 3), device="cuda",
                                  generator=gen))
    z = torch.randn((2, cfg.latent_dim), device="cuda", generator=gen)
    times = []
    for i in range(2 + args.steps):
        t0 = time.perf_counter()
        state, m = train.progan_train_step(state, real, z, 1.0, cfg, cfg.num_stages - 1,
                                           packed_d=True, packed_g=True, remat=True)
        float(m["g_loss"])  # reads the card: the step has finished
        if i >= 2:
            times.append(time.perf_counter() - t0)
    out["train_steps_per_s"] = len(times) / sum(times)
    out["train_p50_ms"] = float(np.median(times)) * 1e3
    out["train_step_s"] = times
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
