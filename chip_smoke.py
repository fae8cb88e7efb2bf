#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``probgan_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every kernel from ``probgan_tpu_torch/csrc`` with nvcc
   (one process per source, all at once), with ptxas's register report;
2. each late-stage kernel at the shapes the 1024² generator gives it
   (batch 2), held against its plain PyTorch twin on the card with TF32 off:
   fp32 outputs to atol = rtol = 1e-4, uint8 outputs within +-1 on at most
   0.5% of bytes. Times (CUDA events, after warm-up) of the kernel's
   wrapper, the plain twin and a cuDNN-based yardstick the port never calls,
   beside the kernel's bound on an H100 (67 TFLOP/s fp32, 3.35 TB/s);
3. the main path: ``ImageGANEngine(ProGANConfig(), device="cuda",
   precision="high").generate`` on batches of 8 latents at 1024². The launch
   counts must move 2/1/1 per call; the output must be uint8 [8,1024,1024,3]
   and agree (PSNR >= 50 dB, +-1 on at most 0.5% of bytes) with the same
   engine run with each kernel's plain twin in its place on the card, and
   with the unpacked path on the card; so must fade-in renders at stage 7
   (alpha 0.5) and stage 8 (alpha 0.3); for one image, the output must agree
   with the plain path on the CPU (PSNR >= 50 dB). Prints img/s and p50
   ms/img;
4. the last lines: the card's name and power limit, one JSON line with each
   kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FP32_FLOPS = 67e12  # H100 SXM, CUDA cores, no tensor cores
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
BATCH_KERNELS = 2
BATCH_MAIN = 8
MAIN_BATCHES = 6  # timed generate calls on the main path
UINT8_MAX_FLIP_SHARE = 0.005
PSNR_FLOOR_DB = 50.0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def uint8_agreement(a: np.ndarray, b: np.ndarray) -> tuple[int, float, float]:
    """(max |a-b|, share of bytes that differ, PSNR dB)."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    mse = float(np.mean(d.astype(np.float64) ** 2))
    psnr = math.inf if mse == 0 else 10 * math.log10(255.0**2 / mse)
    return int(d.max()), float(np.mean(d != 0)), psnr


def finite_or_none(x: float) -> float | None:
    """JSON has no infinity: an exact match's PSNR is written as null."""
    return x if math.isfinite(x) else None


def check_uint8(label: str, got: np.ndarray, want: np.ndarray) -> tuple[int, float, float]:
    worst, share, psnr = uint8_agreement(got, want)
    print(f"  {label}: max |diff| {worst}, differing bytes {share:.6%}, PSNR {psnr:.2f} dB")
    if worst > 1 or share > UINT8_MAX_FLIP_SHARE:
        raise AssertionError(f"{label}: uint8 outputs disagree beyond +-1 on "
                             f"{UINT8_MAX_FLIP_SHARE:.1%} of bytes")
    return worst, share, psnr


def phase_kernels(pk, pro_gan) -> list[dict]:
    """Each kernel at its main-path shapes against its plain twin."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"

    def feats(*shape):  # post-PixelNorm features, like the generator's
        return pro_gan.pixel_norm(torch.randn(shape, device=dev, generator=gen))

    def conv_w(cout, cin, k=3, gain=math.sqrt(2.0)):
        w = torch.randn((cout, cin, k, k), device=dev, generator=gen)
        return w * (gain / math.sqrt(cin * k * k))

    def bias(n):
        return 0.1 * torch.randn(n, device=dev, generator=gen)

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t))

    B = BATCH_KERNELS
    rows = []

    # -- packed_upconv: stage 7 (128 -> 64, 256² -> 512²), stage 8 + toRGB
    up_calls = []
    for label, c, cout, h, rgb in (("stage7", 128, 64, 256, False),
                                   ("stage8+rgb", 64, 32, 512, True)):
        x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
        kw = {}
        if rgb:
            kw = {"rgb_w": conv_w(3, c, 1, 1.0).reshape(3, c), "rgb_b": bias(3)}
        got = pk.packed_upconv(x, w, b, **kw)
        want = pk.packed_upconv_plain(x, w, b, **kw)
        got, want = (got, want) if rgb else ((got,), (want,))
        err = 0.0
        for g, t in zip(got, want):
            torch.testing.assert_close(g, t, atol=1e-4, rtol=1e-4)
            err = max(err, (g - t).abs().max().item())

        def library():
            y = lrelu_norm(F.conv2d(F.interpolate(x, scale_factor=2.0, mode="nearest"),
                                    w, b, padding=1))
            if rgb:
                return y, F.conv2d(x, kw["rgb_w"][:, :, None, None], kw["rgb_b"])
            return y

        flops = 2 * 4 * c * cout * B * 4 * h * h + (2 * c * 3 * B * h * h if rgb else 0)
        nbytes = 4 * (B * c * h * h + B * cout * 4 * h * h + 9 * c * cout + cout
                      + ((3 * c + 3 + B * 3 * h * h) if rgb else 0))
        up_calls.append({
            "call": label, "shape_in": [B, c, h, h], "max_abs_err": err,
            "ms": cuda_ms(lambda: pk.packed_upconv(x, w, b, **kw)),
            "plain_ms": cuda_ms(lambda: pk.packed_upconv_plain(x, w, b, **kw)),
            "library_ms": cuda_ms(library), "flops": flops, "bytes": nbytes,
        })
        del x, got, want
    rows.append(("packed_upconv", "probgan_tpu/ops/pallas_packed.py:832", up_calls))

    # -- packed_conv: stage 7 conv2 (64 -> 64 at 512²)
    c, cout, h = 64, 64, 512
    x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
    got, want = pk.packed_conv(x, w, b), pk.packed_conv_plain(x, w, b)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    rows.append(("packed_conv", "probgan_tpu/ops/pallas_packed.py:382", [{
        "call": "stage7", "shape_in": [B, c, h, h],
        "max_abs_err": (got - want).abs().max().item(),
        "ms": cuda_ms(lambda: pk.packed_conv(x, w, b)),
        "plain_ms": cuda_ms(lambda: pk.packed_conv_plain(x, w, b)),
        "library_ms": cuda_ms(lambda: lrelu_norm(F.conv2d(x, w, b, padding=1))),
        "flops": 2 * 9 * c * cout * B * h * h,
        "bytes": 4 * (2 * B * c * h * h + 9 * c * cout + cout),
    }]))
    del x, got, want

    # -- packed_conv_rgb: stage 8 conv2 (32 -> 32 at 1024²) -> uint8 NHWC
    c, cout, h = 32, 32, 1024
    x, w, b = feats(B, c, h, h), conv_w(cout, c), bias(cout)
    rgb_w, rgb_b = conv_w(3, cout, 1, 1.0).reshape(3, cout), bias(3)
    prev = 0.5 * torch.randn((B, 3, h // 2, h // 2), device=dev, generator=gen)
    args = (x, w, b, rgb_w, rgb_b, prev)
    # fp32 emission at a fade-in alpha: the blend itself to fp32 tolerance
    got = pk.packed_conv_rgb(*args, 0.3)
    want = pk.packed_conv_rgb_plain(*args, 0.3)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    err_fp32 = (got - want).abs().max().item()
    # uint8 emission at the main path's alpha = 1
    got = pk.packed_conv_rgb(*args, 1.0, emit_uint8=True)
    want = pk.packed_conv_rgb_plain(*args, 1.0, emit_uint8=True)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, h, h, 3)
    worst, _, _ = check_uint8("packed_conv_rgb uint8 vs plain", got.cpu().numpy(),
                              want.cpu().numpy())

    def library():
        feat = lrelu_norm(F.conv2d(x, w, b, padding=1))
        rgb = F.conv2d(feat, rgb_w[:, :, None, None], rgb_b)
        up = F.interpolate(prev, scale_factor=2.0, mode="nearest")
        return pro_gan.to_uint8((up + 1.0 * (rgb - up)).permute(0, 2, 3, 1))

    rows.append(("packed_conv_rgb", "probgan_tpu/ops/pallas_packed.py:678", [{
        "call": "stage8", "shape_in": [B, c, h, h], "max_abs_err": float(worst),
        "max_abs_err_fp32": err_fp32,
        "ms": cuda_ms(lambda: pk.packed_conv_rgb(*args, 1.0, emit_uint8=True)),
        "plain_ms": cuda_ms(lambda: pk.packed_conv_rgb_plain(*args, 1.0, emit_uint8=True)),
        "library_ms": cuda_ms(library),
        "flops": 2 * 9 * c * cout * B * h * h + 2 * cout * 3 * B * h * h,
        "bytes": 4 * (B * c * h * h + 9 * c * cout + cout + 3 * cout + 3
                      + B * 3 * (h // 2) ** 2) + B * h * h * 3,
    }]))
    del x, got, want, args, prev

    out = []
    for name, replaces, calls in rows:
        flops = sum(k["flops"] for k in calls)
        nbytes = sum(k["bytes"] for k in calls)
        bound_ms, bound_by = bound(flops, nbytes)
        entry = {
            "name": name, "route": "cuda",
            "source": f"probgan_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": 0,
            "max_abs_err": max(k["max_abs_err"] for k in calls),
            "ms": sum(k["ms"] for k in calls),
            "plain_ms": sum(k["plain_ms"] for k in calls),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(k["library_ms"] for k in calls),
            "batch": B, "calls": calls,
        }
        for k in calls:
            k["bound_ms"], k["bound_by"] = bound(k["flops"], k["bytes"])
            print(f"  {name}[{k['call']}] x{k['shape_in']}: max_abs_err "
                  f"{k['max_abs_err']:.3g}  kernel {k['ms']:.3f} ms  plain "
                  f"{k['plain_ms']:.3f} ms  library {k['library_ms']:.3f} ms  bound "
                  f"{k['bound_ms']:.3f} ms ({k['bound_by']}, "
                  f"{k['flops'] / 1e9:.1f} GFLOP, {k['bytes'] / 1e6:.1f} MB)")
        out.append(entry)
    return out


def phase_main_path(pk, pro_gan, engine_mod) -> tuple[dict, dict]:
    cfg = pro_gan.ProGANConfig()
    stage = cfg.num_stages - 1
    assert pro_gan.packed_start_stage(cfg, stage) == 7
    engine = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    engine.generate(engine.sample_latents(BATCH_MAIN))  # warm-up (cuDNN plans)
    latents = [engine.sample_latents(BATCH_MAIN) for _ in range(MAIN_BATCHES)]
    torch.cuda.synchronize()

    pk.reset_launches()
    times, img = [], None
    for z in latents:
        t0 = time.perf_counter()
        img = engine.generate(z)  # returns host numpy: the call has finished
        times.append(time.perf_counter() - t0)
    counts = dict(pk.launches)

    per_call = {"packed_upconv": 2, "packed_conv": 1, "packed_conv_rgb": 1}
    print(f"  launch counts over {MAIN_BATCHES} generate calls: {counts}")
    for name, n in per_call.items():
        if counts[name] != n * MAIN_BATCHES:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{n} per generate call")
    if img.dtype != np.uint8 or img.shape != (BATCH_MAIN, cfg.resolution, cfg.resolution, 3):
        raise AssertionError(f"generate returned {img.dtype} {img.shape}")

    z = latents[-1]
    # The same engine with each kernel's plain twin in its place, on the card.
    kernels = {name: getattr(pk, name) for name in per_call}
    try:
        for name in per_call:
            setattr(pk, name, getattr(pk, f"{name}_plain"))
        twins = engine.generate(z)
    finally:
        for name, fn in kernels.items():
            setattr(pk, name, fn)
    worst, share, psnr = check_uint8("main path vs its plain twins on the card", img, twins)
    # and the unpacked path (all stages through ops/fused_upconv.py + cuDNN)
    ref = pro_gan.generator_apply(engine.g_params, z, cfg, stage, 1.0, "high",
                                  packed=False).cpu().numpy()
    _, _, psnr_unpacked = check_uint8("main path vs the unpacked path on the card", img, ref)
    if min(psnr, psnr_unpacked) < PSNR_FLOOR_DB:
        raise AssertionError(f"PSNR {min(psnr, psnr_unpacked):.2f} dB < {PSNR_FLOOR_DB} dB")

    # fade-in renders: stage 7 alone on the kernels (Cout 64 with toRGB and
    # the fused tail) and stage 8 at alpha 0.3, against the unpacked path
    for st, alpha in ((7, 0.5), (8, 0.3)):
        got = engine.generate(z[:2], stage=st, alpha=alpha)
        want = pro_gan.generator_apply(engine.g_params, z[:2], cfg, st, alpha, "high",
                                       packed=False).cpu().numpy()
        _, _, p = check_uint8(f"stage {st} alpha {alpha} vs the unpacked path", got, want)
        if p < PSNR_FLOOR_DB:
            raise AssertionError(f"stage {st}: PSNR {p:.2f} dB < {PSNR_FLOOR_DB} dB")

    cpu_params = engine_mod.to_device(engine.g_params, torch.device("cpu"))
    with torch.inference_mode():
        cpu_img = pro_gan.generator_apply(cpu_params, z[:1].cpu(), cfg, stage, 1.0,
                                          "high", packed=True).numpy()
    _, _, psnr_cpu = uint8_agreement(img[:1], cpu_img)
    print(f"  main path image 0 vs the plain path on the CPU: PSNR {psnr_cpu:.2f} dB")
    if psnr_cpu < PSNR_FLOOR_DB:
        raise AssertionError(f"card vs CPU PSNR {psnr_cpu:.2f} dB < {PSNR_FLOOR_DB} dB")

    per_img_ms = sorted(t / BATCH_MAIN * 1e3 for t in times)
    main = {
        "batch": BATCH_MAIN, "calls": MAIN_BATCHES,
        "img_per_s": BATCH_MAIN * MAIN_BATCHES / sum(times),
        "p50_ms_per_img": float(np.median(per_img_ms)),
        "batch_s": times, "psnr_vs_plain_twins_db": finite_or_none(psnr),
        "max_abs_diff": worst, "differing_bytes": share,
        "psnr_vs_unpacked_db": finite_or_none(psnr_unpacked),
        "psnr_vs_cpu_db": finite_or_none(psnr_cpu),
    }
    print(f"  {main['img_per_s']:.3f} img/s, p50 {main['p50_ms_per_img']:.3f} ms/img "
          f"(batch {BATCH_MAIN}, {MAIN_BATCHES} calls, host clock incl. copy to host)")
    return counts, main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from probgan_tpu_torch.engine import image as engine_mod
    from probgan_tpu_torch.models import pro_gan
    from probgan_tpu_torch.ops import _build
    from probgan_tpu_torch.ops import packed as pk

    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print("phase 1: build")
    t0 = time.perf_counter()
    logs = _build.build(ptxas_info=True)
    print(f"  built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    print("phase 2: kernels vs plain twins (batch 2, main-path shapes)")
    kernels = phase_kernels(pk, pro_gan)
    torch.cuda.empty_cache()

    print("phase 3: main path, ImageGANEngine.generate at 1024²")
    counts, main = phase_main_path(pk, pro_gan, engine_mod)
    for k in kernels:
        k["launches"] = counts[k["name"]]

    print(card_line())
    print(json.dumps({"kernels": kernels, "main_path": main, "card": card},
                     allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
