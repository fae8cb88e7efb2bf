"""Where a block of the fp32 conv kernels spends its cycles, on one CUDA
card: packed_conv's "lrelu" epilogue on the synchronous loop
(``conv3x3_accumulate``, the previous kernel) and on the pipelined ring
(``csrc/conv_ring.cuh``), and packed_conv_rgb's uint8 tail on the ring
(``ConvRgbRing``), each block summing ``clock64`` laps into waiting for its
staged inputs, FMAs and the epilogue (``csrc/conv_clock_split.cu``, built on
first use). Every output must equal ``packed_conv(..., epilogue="lrelu")``
or ``packed_conv_rgb(..., emit_uint8=True)`` bit for bit. Then the
stage-fused kernels (``csrc/fused_ring.cuh``): B10 ``packed_upconv_conv`` at
stage 7 and B11 ``packed_upconv_conv_rgb`` at stage 8 (uint8), their cycles
in waiting, conv1's FMAs, conv2's FMAs and the epilogues, their outputs
equal to the wrappers' bit for bit. The fused probe also records each tile
its walk takes, which must equal ``ops/packed.py:fused_tile_origin`` under
the split the wrappers pass (``fused_split``), and counts the conv1 pixels
it stores into shared memory: conv1 pixels a conv2 output, measured, beside
``fused_conv1_per_output``'s figure from the tiling.

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
# the stage-fused kernels' (label, C, Cout, input H, tail): tail 0 features
# (B10), 2 uint8 RGB (B11)
FUSED_SHAPES = (("packed_upconv_conv@s7", 128, 64, 256, 0),
                ("packed_upconv_conv_rgb@s8_uint8", 64, 32, 512, 2))
BATCH = 2
PARTS = ("wait", "fma", "epilogue")
FUSED_PARTS = ("wait", "conv1_fma", "epilogue", "conv2_fma")  # SplitClock's order
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, ctypes.c_float,
            _P]
FUSED_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _I, _P, _P, _P, _P]
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


def run_fused(args: tuple, device: torch.device, blocks: int, n_tiles: int
              ) -> tuple[torch.Tensor, float, torch.Tensor, int]:
    """One launch of the stage-fused probe (after one warm-up): ``args`` its
    C entry's arguments up to the clocks; (clocks [blocks, 4], ms, the walk's
    record [n_tiles, 4], conv1 pixels stored), the last two of the timed
    launch."""
    lib = _build.load("conv_clock_split")
    fn = lib.probgan_conv_clock_split_fused
    fn.argtypes, fn.restype = FUSED_ARGTYPES, ctypes.c_int
    clocks = torch.zeros((blocks, 4), dtype=torch.int64, device=device)
    tiles = torch.empty((n_tiles, 4), dtype=torch.int32, device=device)
    pixels = torch.zeros(1, dtype=torch.int64, device=device)

    def launch():
        tiles.fill_(-1)
        pixels.zero_()
        with torch.cuda.device(device):
            err = fn(*args, clocks.data_ptr(), tiles.data_ptr(), pixels.data_ptr(),
                     torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise RuntimeError(f"conv_clock_split_fused: CUDA error {err} "
                               f"({lib.probgan_error_string(err).decode()})")

    launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    return clocks.cpu(), start.elapsed_time(end), tiles.cpu(), int(pixels.item())


def shares(clocks: torch.Tensor, ms: float, differing: int, parts=PARTS) -> dict:
    total = clocks.sum().item()
    return {"ms": ms, "blocks": clocks.shape[0], "mean_block_cycles": total / clocks.shape[0],
            **{f"{p}_share": clocks[:, i].sum().item() / total for i, p in enumerate(parts)},
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
    out = {"card": card, "batch": BATCH, "shapes": {}, "rgb_shapes": {}, "fused_shapes": {}}
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
        for label, c, cout, h, tail in FUSED_SHAPES:
            x = torch.randn((BATCH, c, h, h), device="cuda", generator=gen)
            w1 = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
            w2 = torch.randn((cout, cout, 3, 3), device="cuda", generator=gen) * math.sqrt(
                2 / (9 * cout))
            b1 = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            b2 = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            rgb = tail != 0
            if rgb:
                rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
                prev_w = torch.randn((3, c), device="cuda", generator=gen) / math.sqrt(c)
                rgb_b, prev_b = (0.1 * torch.randn(3, device="cuda", generator=gen)
                                 for _ in range(2))
                want = pk.packed_upconv_conv_rgb(x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b,
                                                 1.0, emit_uint8=tail == 2)
            else:
                rgb_w = rgb_b = prev_w = prev_b = None
                want = pk.packed_upconv_conv(x, w1, b1, w2, b2)
            y = torch.empty_like(want)
            n_tiles = pk.fused_tile_count(BATCH, cout, h, h)
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            split = pk.fused_split(BATCH, cout, h, h, sms)
            # the kernel's weight layouts, held while the probe runs
            wk1, wk2 = pk.upconv_kernel_weights(w1), pk.conv_kernel_weights(w2)
            args = (*(None if t is None else t.data_ptr() for t in (
                        x, wk1, b1, wk2, b2, rgb_w, rgb_b, prev_w, prev_b)),
                    1.0, y.data_ptr(), tail, BATCH, c, h, h, cout, *split,
                    pk.fused_ring_bytes(cout, rgb))
            clocks, ms, tiles, pixels = run_fused(args, x.device, split[0], n_tiles)
            wv, yv = (want, y) if tail == 2 else (want.view(torch.int32), y.view(torch.int32))
            walk = [tuple(r[:3]) + (bool(r[3]),) for r in tiles.tolist()]
            mirror = [pk.fused_tile_origin(t, split, cout, h, h) for t in range(n_tiles)]
            walk_off = sum(a != b for a, b in zip(walk, mirror))
            row = {"fused_ring": {
                **shares(clocks, ms, int((yv != wv).sum()), FUSED_PARTS),
                "tiles_off_the_mirror": walk_off,
                "conv1_per_output": pixels / (BATCH * 4 * h * h),
                "conv1_per_output_tiling": pk.fused_conv1_per_output(BATCH, cout, h, h, sms)}}
            out["fused_shapes"][label] = row
            v = row["fused_ring"]
            print(f"{label}: {v['ms']:.3f} ms, " + ", ".join(
                f"{p} {v[p + '_share']:.1%}" for p in FUSED_PARTS)
                + f", differing {v['differing']}, tiles off the mirror {walk_off}, conv1 "
                f"pixels a conv2 output {v['conv1_per_output']:.4f} counted, "
                f"{v['conv1_per_output_tiling']:.4f} from the tiling")
            del x, want, y, wk1, wk2
    print(card)
    print(json.dumps(out))
    bad = [s for group in ("shapes", "rgb_shapes", "fused_shapes") for s, r in out[group].items()
           if any(v["differing"] or v.get("tiles_off_the_mirror") for v in r.values())]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
