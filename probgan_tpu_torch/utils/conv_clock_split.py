"""Where a block of packed_conv's fp32 kernel spends its cycles, on one CUDA
card: the "lrelu" epilogue on the synchronous loop (``conv3x3_accumulate``,
the previous kernel) and on the pipelined ring (``csrc/conv_ring.cuh``), each
block summing ``clock64`` laps into waiting for its staged inputs, FMAs and
the epilogue (``csrc/conv_clock_split.cu``, built on first use). Both
outputs must equal ``packed_conv(..., epilogue="lrelu")`` bit for bit.

Prints the card's name and power limit and one JSON line: per (C, Cout, H)
at batch 2 and per loop, the share of the blocks' summed cycles in each
part, a block's mean cycles, and the probe's milliseconds (CUDA events)::

    python3 -m probgan_tpu_torch.utils.conv_clock_split
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess

import torch

from probgan_tpu_torch.ops import _build
from probgan_tpu_torch.ops import packed as pk

SHAPES = ((32, 32, 1024), (64, 64, 512), (32, 64, 1024), (64, 128, 512))
BATCH = 2
PARTS = ("wait", "fma", "epilogue")
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P]


def run(x, wk, b, y, cout: int, ring: bool) -> tuple[torch.Tensor, float]:
    """One probe launch (after one warm-up); (clocks [blocks, 3], ms)."""
    bsz, c, h, wd = x.shape
    n_tiles = pk.conv_tile_count(bsz, cout, h, wd)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = pk.persistent_blocks(n_tiles, sms) if ring else n_tiles
    clocks = torch.zeros((blocks, 3), dtype=torch.int64, device=x.device)
    args = (x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, c, h, wd, cout,
            int(ring), blocks, pk.conv_ring_bytes(cout) if ring else 0, clocks.data_ptr())
    _build.launch("conv_clock_split", ARGTYPES, x.device, *args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _build.launch("conv_clock_split", ARGTYPES, x.device, *args)
    end.record()
    end.synchronize()
    return clocks.cpu(), start.elapsed_time(end)


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_clock_split: no CUDA card")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {"card": card, "batch": BATCH, "shapes": {}}
    with torch.no_grad():
        for c, cout, h in SHAPES:
            x = torch.randn((BATCH, c, h, h), device="cuda", generator=gen)
            w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
            b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            want = pk.packed_conv(x, w, b, epilogue="lrelu")
            wk = pk.convpool_kernel_weights(w)
            row = {}
            for loop, ring in (("old", False), ("ring", True)):
                y = torch.empty_like(want)
                clocks, ms = run(x, wk, b, y, cout, ring)
                total = clocks.sum().item()
                row[loop] = {
                    "ms": ms, "blocks": clocks.shape[0],
                    "mean_block_cycles": total / clocks.shape[0],
                    **{f"{p}_share": clocks[:, i].sum().item() / total
                       for i, p in enumerate(PARTS)},
                    "differing_vs_packed_conv": int((y.view(torch.int32)
                                                     != want.view(torch.int32)).sum()),
                }
            out["shapes"][f"C{c}->Cout{cout}@{h}"] = row
            print(f"C{c}->Cout{cout}@{h}: " + "; ".join(
                f"{k} {v['ms']:.3f} ms, wait {v['wait_share']:.1%}, fma {v['fma_share']:.1%}, "
                f"epilogue {v['epilogue_share']:.1%}, differing {v['differing_vs_packed_conv']}"
                for k, v in row.items()))
            del x, want, y
    print(card)
    print(json.dumps(out))
    bad = [s for s, r in out["shapes"].items() if any(v["differing_vs_packed_conv"]
                                                       for v in r.values())]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
