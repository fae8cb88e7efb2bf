"""Where a block of the fp32 conv kernels spends its cycles, on one CUDA
card: packed_conv's "lrelu" epilogue on the synchronous loop
(``conv3x3_accumulate``, the previous kernel) and on the pipelined ring
(``csrc/conv_ring.cuh``), and packed_conv_rgb's uint8 tail on the ring
(``ConvRgbRing``), each block summing ``clock64`` laps into waiting for its
staged inputs, FMAs and the epilogue (``csrc/conv_clock_split.cu``, built on
first use). Every output must equal ``packed_conv(..., epilogue="lrelu")``
or ``packed_conv_rgb(..., emit_uint8=True)`` bit for bit.

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
# packed_conv_rgb's (C, Cout, H): stage 8 of the 1024² generator, and stage 7
RGB_SHAPES = ((32, 32, 1024), (64, 64, 512))
BATCH = 2
PARTS = ("wait", "fma", "epilogue")
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, ctypes.c_float,
            _P]
OLD, RING, RGB_RING = 0, 1, 2  # the probe's modes


def run(x, wk, b, y, cout: int, mode: int, rgb=(None, None, None, 0.0)
        ) -> tuple[torch.Tensor, float]:
    """One probe launch (after one warm-up); (clocks [blocks, 3], ms).
    ``rgb``: (rgb_w, rgb_b, prev, alpha) of the RGB_RING mode."""
    bsz, c, h, wd = x.shape
    n_tiles = pk.conv_tile_count(bsz, cout, h, wd)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = pk.persistent_blocks(n_tiles, sms) if mode != OLD else n_tiles
    clocks = torch.zeros((blocks, 3), dtype=torch.int64, device=x.device)
    rgb_w, rgb_b, prev, alpha = rgb
    args = (x.data_ptr(), wk.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, c, h, wd, cout,
            mode, blocks, pk.conv_ring_bytes(cout) if mode != OLD else 0, clocks.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (rgb_w, rgb_b, prev)), alpha)
    _build.launch("conv_clock_split", ARGTYPES, x.device, *args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _build.launch("conv_clock_split", ARGTYPES, x.device, *args)
    end.record()
    end.synchronize()
    return clocks.cpu(), start.elapsed_time(end)


def shares(clocks: torch.Tensor, ms: float, differing: int) -> dict:
    total = clocks.sum().item()
    return {"ms": ms, "blocks": clocks.shape[0], "mean_block_cycles": total / clocks.shape[0],
            **{f"{p}_share": clocks[:, i].sum().item() / total for i, p in enumerate(PARTS)},
            "differing": differing}


def print_row(label: str, row: dict) -> None:
    print(f"{label}: " + "; ".join(
        f"{k} {v['ms']:.3f} ms, wait {v['wait_share']:.1%}, fma {v['fma_share']:.1%}, "
        f"epilogue {v['epilogue_share']:.1%}, differing {v['differing']}"
        for k, v in row.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_clock_split: no CUDA card")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {"card": card, "batch": BATCH, "shapes": {}, "rgb_shapes": {}}
    with torch.no_grad():
        for c, cout, h in SHAPES:
            x = torch.randn((BATCH, c, h, h), device="cuda", generator=gen)
            w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
            b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            want = pk.packed_conv(x, w, b, epilogue="lrelu")
            wk = pk.convpool_kernel_weights(w)
            row = {}
            for loop, mode in (("old", OLD), ("ring", RING)):
                y = torch.empty_like(want)
                clocks, ms = run(x, wk, b, y, cout, mode)
                row[loop] = shares(clocks, ms, int((y.view(torch.int32)
                                                    != want.view(torch.int32)).sum()))
            out["shapes"][f"C{c}->Cout{cout}@{h}"] = row
            print_row(f"C{c}->Cout{cout}@{h}", row)
            del x, want, y
        for c, cout, h in RGB_SHAPES:
            x = torch.randn((BATCH, c, h, h), device="cuda", generator=gen)
            w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
            b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
            rgb_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
            prev = 0.5 * torch.randn((BATCH, 3, h // 2, h // 2), device="cuda", generator=gen)
            want = pk.packed_conv_rgb(x, w, b, rgb_w, rgb_b, prev, 1.0, emit_uint8=True)
            y = torch.empty_like(want)
            clocks, ms = run(x, pk.conv_kernel_weights(w), b, y, cout, RGB_RING,
                             (rgb_w, rgb_b, prev, 1.0))
            row = {"rgb_ring": shares(clocks, ms, int((y != want).sum()))}
            out["rgb_shapes"][f"C{c}->Cout{cout}@{h}"] = row
            print_row(f"packed_conv_rgb C{c}->Cout{cout}@{h}", row)
            del x, want, y, prev
    print(card)
    print(json.dumps(out))
    bad = [s for group in ("shapes", "rgb_shapes") for s, r in out[group].items()
           if any(v["differing"] for v in r.values())]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
