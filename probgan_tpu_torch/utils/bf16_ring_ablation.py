"""Where the time of the pipelined bf16 loop of B1 ``packed_upconv``, B2
``packed_conv``, B3 ``packed_conv_rgb`` and B5 ``packed_convpool``
(``csrc/bf16_ring.cuh``, kernel modes "default" and "mid") goes, by ablation
on one CUDA card.

Each variant is a copy of ``csrc/`` with parts of the loop switched off by a
text edit of ``bf16_ring.cuh``, built with the port's nvcc flags into a
scratch directory and launched with the arguments that the wrapper passes the
real kernel (recorded from one wrapper call; the weights prepared once):

- ``all``: the kernel as it is;
- ``no_products``: no ``compute`` (the copies, the epilogue and the stores);
- ``no_copies``: no copies after the ring's first stages (the products, the
  epilogue, the stores, on stale stages);
- ``no_stores``: the epilogue stores nothing (it returns once the sums are
  read, so the products stay);
- ``products``: no copies and no stores: the products alone;
- ``copies``: no products and no stores: the copies alone;
- ``stores``: no copies and no products: the epilogue's stores alone.

The outputs of the variants are wrong by design; only their times mean
anything. CUDA events, mean of 20 launches after 3 warm-ups, at the main
paths' shapes at batch 8 (B5 at ``score``'s "mid" shapes; B3 uint8 at
``generate``'s stage 8, the generator's packed mode "mid" and "fast").
Prints the card's name and power limit and one JSON line::

    python3 -m probgan_tpu_torch.utils.bf16_ring_ablation [--variants all,copies]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_WALK_COMPUTE = "    cv.compute(smem + (it % kStages) * Conv::kStage, tile, chunk, acc);\n"
_WALK_COPY = "    if (it + kStages - 1 < n_steps) issue_next((it + kStages - 1) % kStages);\n"
_FINISH = ("  __device__ __forceinline__ void finish(int tile, float (&acc)[MT][NT][4]) const {\n"
           "    int b, COORDS;\n")
_NO_STORES = ("    float s_ = 0.f;  // read every sum, store nothing\n"
              "#pragma unroll\n    for (int m = 0; m < MT; ++m)\n#pragma unroll\n"
              "      for (int n = 0; n < NT; ++n)\n#pragma unroll\n"
              "        for (int e = 0; e < 4; ++e) s_ += acc[m][n][e];\n"
              "    if (s_ != 1.2345e-30f) return;\n")
_FINISH_B2 = _FINISH.replace("COORDS", "y0, x0, slab")
_FINISH_B1 = _FINISH.replace("COORDS", "i0, j0, py")
_FINISH_B5 = _FINISH.replace(
    "COORDS;\n", "y0, x0, slab;  // pooled: rows y0 / 2 .. + TH / 2, columns x0 / 2 .. + 15\n")
_FINISH_B3 = _FINISH.replace("COORDS;\n", "y0, x0, slab;  // slab 0: all COUT channels\n")
_EDITS = {
    "no_products": [(_WALK_COMPUTE, "")],
    "no_copies": [(_WALK_COPY, "")],
    "no_stores": [(f, f + _NO_STORES) for f in (_FINISH_B2, _FINISH_B1, _FINISH_B5, _FINISH_B3)],
}
_EDITS["products"] = _EDITS["no_copies"] + _EDITS["no_stores"]
_EDITS["copies"] = _EDITS["no_products"] + _EDITS["no_stores"]
_EDITS["stores"] = _EDITS["no_products"] + _EDITS["no_copies"]
VARIANTS = ("all", *_EDITS)
# (label, kernel, C, Cout, input H, mode, epilogue, toRGB), batch 8; B3's
# "epilogue" is its output, uint8 at alpha 1
CASES = (
    ("B2 64->64@512 default", "packed_conv", 64, 64, 512, "default", "lrelu_norm", False),
    ("B2 64->64@512 mid lrelu", "packed_conv", 64, 64, 512, "mid", "lrelu", False),
    ("B2 32->32@1024 mid lrelu", "packed_conv", 32, 32, 1024, "mid", "lrelu", False),
    ("B2 8->8@1024 default lrelu", "packed_conv", 8, 8, 1024, "default", "lrelu", False),
    ("B1 128->64@256 default", "packed_upconv", 128, 64, 256, "default", "lrelu_norm", False),
    ("B1 64->32@512 default toRGB", "packed_upconv", 64, 32, 512, "default", "lrelu_norm",
     True),
    ("B1 16->8@512 default toRGB", "packed_upconv", 16, 8, 512, "default", "lrelu_norm", True),
    ("B5 32->64@1024 mid lrelu", "packed_convpool", 32, 64, 1024, "mid", "lrelu", False),
    ("B5 64->128@512 mid lrelu", "packed_convpool", 64, 128, 512, "mid", "lrelu", False),
    ("B3 32->32@1024 mid uint8", "packed_conv_rgb", 32, 32, 1024, "mid", "uint8", True),
    ("B3 32->32@1024 default uint8", "packed_conv_rgb", 32, 32, 1024, "default", "uint8", True),
)
LIBRARIES = ("packed_conv_bf16", "packed_upconv_bf16", "packed_convpool_bf16",
             "packed_conv_rgb_bf16")


def build_variants(names, root: Path) -> dict:
    """{(variant, library): ctypes.CDLL}: csrc/ copied and edited a variant,
    every nvcc started at once."""
    from probgan_tpu_torch.ops import _build

    procs = {}
    for v in names:
        d = root / v
        shutil.copytree(_build.CSRC, d)
        ring = d / "bf16_ring.cuh"
        src = ring.read_text()
        for old, new in _EDITS.get(v, []):
            if src.count(old) != 1:
                raise RuntimeError(f"{v}: the edit's anchor is not in bf16_ring.cuh once: {old!r}")
            src = src.replace(old, new)
        ring.write_text(src)
        for lib in LIBRARIES:
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o", str(d / f"{lib}.so"),
                   str(d / f"{lib}.cu")]
            procs[(v, lib)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.PIPE, text=True)
    libs = {}
    for key, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc exit {proc.returncode}\n{out}{err}")
        libs[key] = ctypes.CDLL(str(root / key[0] / f"{key[1]}.so"))
    return libs


def recorded_launch(call):
    """(name, argtypes, args, output) of the one C launch a wrapper call makes."""
    from probgan_tpu_torch.ops import _build

    real, seen = _build.launch, []

    def record(name, argtypes, device, *args):
        seen.append((name, argtypes, args))
        real(name, argtypes, device, *args)
    _build.launch = record
    try:
        with torch.no_grad():
            out = call()
    finally:
        _build.launch = real
    (name, argtypes, args), = seen
    return name, argtypes, args, out


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
    ap.add_argument("--variants", default=",".join(VARIANTS), help=f"comma list of {VARIANTS}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_ring_ablation: no CUDA card")
        return 1
    names = args.variants.split(",")
    if not set(names) <= set(VARIANTS):
        ap.error(f"--variants takes {VARIANTS}")
    from probgan_tpu_torch.ops import packed as pk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": card, "batch": 8, "ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(names, Path(tmp))
        for i, (label, kernel, c, cout, h, mode, epi, rgb) in enumerate(CASES):
            gen = torch.Generator(device="cuda").manual_seed(600 + i)
            x = torch.randn((8, c, h, h), device="cuda", generator=gen)
            w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
            b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            rgb_in = c if kernel == "packed_upconv" else cout  # B1: toRGB of its input
            kw = {"rgb_w": torch.randn((3, rgb_in), device="cuda", generator=gen)
                  / math.sqrt(rgb_in),
                  "rgb_b": 0.1 * torch.randn(3, device="cuda", generator=gen)} if rgb else {}
            rgb_w = pk._bf16(kw["rgb_w"]).contiguous() if rgb else None
            if kernel in ("packed_conv", "packed_convpool"):
                def call(fn=getattr(pk, kernel)):
                    return fn(x, w, b, epi, mode=mode)
            elif kernel == "packed_conv_rgb":
                prev = 0.5 * torch.randn((8, 3, h // 2, h // 2), device="cuda", generator=gen)

                def call(prev=prev):
                    return pk.packed_conv_rgb(x, w, b, kw["rgb_w"], kw["rgb_b"], prev, 1.0,
                                              emit_uint8=True, mode=mode)
            else:
                def call():
                    return pk.packed_upconv(x, w, b, epilogue=epi, mode=mode, **kw)
            name, argtypes, launch_args, keep = recorded_launch(call)
            if rgb:  # the wrapper's rounded toRGB weights, kept alive here
                launch_args = (*launch_args[:3], rgb_w.data_ptr(), *launch_args[4:])
            row = {}
            for v in names:
                fn = getattr(libs[(v, name)], f"probgan_{name}")
                fn.argtypes, fn.restype = argtypes, ctypes.c_int

                def go(fn=fn):
                    err = fn(*launch_args, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{label}: launch failed, CUDA error {err}")
                row[v] = cuda_ms(go)
            out["ms"][label] = row
            del x, keep
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
