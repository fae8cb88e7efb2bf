#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``probgan_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every kernel from ``probgan_tpu_torch/csrc`` with nvcc
   (one process per source, all at once), with ptxas's register report;
2. each late-stage generator kernel at the shapes the 1024² generator gives
   it (batch 2), held against its plain PyTorch twin on the card with TF32
   off: fp32 outputs to atol = rtol = 1e-4, uint8 outputs within +-1 on at
   most 0.5% of bytes. Times (CUDA events, after warm-up) of the kernel's
   wrapper, the plain twin and a cuDNN-based yardstick the port never calls,
   beside the kernel's bound on an H100 (67 TFLOP/s fp32, 3.35 TB/s);
3. the image main path: ``ImageGANEngine(ProGANConfig(), device="cuda",
   precision="high").generate`` on batches of 8 latents at 1024². The launch
   counts must move 2/1/1 per call; the output must be uint8 [8,1024,1024,3]
   and agree (PSNR >= 50 dB, +-1 on at most 0.5% of bytes) with the same
   engine run with each kernel's plain twin in its place on the card, and
   with the unpacked path on the card; so must fade-in renders at stage 7
   (alpha 0.5) and stage 8 (alpha 0.3); for one image, the output must agree
   with the plain path on the CPU (PSNR >= 50 dB). Prints img/s and p50
   ms/img;
4. the two fused rank kernels at the KG path's shapes (N = 1,000,000
   entities, D = 128): ``rank_topk`` at B = 64 and B = 8 with k = 10, with
   ``nvalid`` below the row count, with planted duplicate rows, and as
   ``rank_topk_local``; ``rank_scores`` at B = 64. Values must agree with
   the plain twin to atol 2e-6 (the kernel sums a dot's 128 terms in another
   order than ``torch.matmul``: about 1 ulp); every returned id's plain
   score must equal the returned value within 2e-6, no entity left out may
   score more than 2e-6 above the k-th value, and bit-equal scores
   (duplicate rows) must come in ascending id. The yardstick is
   ``F.normalize`` -> ``torch.matmul`` (-> ``torch.topk``);
5. the KG main path: a seeded C17 checkpoint (1,000,000 entities, 1,000
   relations, embed 128, noise 64, hidden 1024) written as ``.pt`` into a
   temporary directory, then ``InferenceEngine(path, device="cuda")``:
   ``predict_tails`` on 64 pairs with top_k 10 (``rank_topk`` must launch
   exactly once per call; results must agree with the same engine run with
   the kernels' plain twins in their place under the same noise), once with
   top_k 32 (``rank_scores`` must launch once), ``find_similar_entities``
   (``rank_topk`` with k = 11, the query itself excluded),
   ``score_triplets`` and ``analyze_relations`` against the engine on the
   CPU (atol 1e-5, relation ids equal), the CLI's ``predict_tails`` and
   ``model_info`` tasks in process, and the REPL fed from stdin. Prints
   queries/s and p50 ms per call;
6. the last lines: the card's name and power limit, one JSON line with each
   kernel's numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
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
KG_ENTITIES = 1_000_000  # the JAX package's own "production scale" rank size
KG_RELATIONS = 1_000
KG_DIM, KG_NOISE, KG_HIDDEN = 128, 64, 1024
KG_BATCH = 64
KG_CALLS = 6  # timed predict_tails calls
KG_TOP_K = 10
# fp32 dots summed in another order than torch.matmul differ by about 1 ulp
# of a cosine near 1: the JAX package's own tolerance for its rank kernels.
RANK_ATOL = 2e-6


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


def check_topk(label: str, values, ids, plain_scores, planted=None) -> float:
    """Hold one fused top-k result against the plain scores [B, nvalid] of
    the same inputs, by the rule in the module docstring. Returns the max
    |value - plain top-k value|."""
    k = ids.shape[1]
    want_v = torch.sort(plain_scores, dim=1, descending=True, stable=True)[0][:, :k]
    err = (values - want_v).abs().max().item()
    if err > RANK_ATOL:
        raise AssertionError(f"{label}: top-k values differ from the plain twin by {err:.3g}")
    if (values[:, 1:] > values[:, :-1]).any():
        raise AssertionError(f"{label}: values are not in descending order")
    if ids.min() < 0 or ids.max() >= plain_scores.shape[1]:
        raise AssertionError(f"{label}: an id lies outside [0, nvalid)")
    if (torch.sort(ids, dim=1)[0].diff(dim=1) == 0).any():
        raise AssertionError(f"{label}: an id is returned twice")
    own = torch.gather(plain_scores, 1, ids)
    if (own - values).abs().max().item() > RANK_ATOL:
        raise AssertionError(f"{label}: a returned id's plain score is not its value")
    rest = plain_scores.clone().scatter_(1, ids, float("-inf")).max(dim=1)[0]
    if (rest > values[:, -1] + RANK_ATOL).any():
        raise AssertionError(f"{label}: an entity left out beats the k-th value")
    if planted is not None and ids[0, :len(planted)].tolist() != planted:
        raise AssertionError(f"{label}: tied rows {planted} came as "
                             f"{ids[0, :len(planted)].tolist()}, not in ascending id")
    return err


def phase_rank_kernels(rf, rank_ops) -> list[dict]:
    """The fused rank kernels at the KG path's shapes against their plain
    twins: N = 1,000,000 rows, D = 128."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    n, d, k = KG_ENTITIES, KG_DIM, KG_TOP_K
    table = rank_ops.l2_normalize(torch.randn((n, d), device="cuda", generator=gen))
    # bit-equal rows, across tile and block boundaries: their scores tie
    planted = [5, 2047, 2048, 300_000, n - 1]
    for row in planted[1:]:
        table[row] = table[5]
    preds = {b: torch.randn((b, d), device="cuda", generator=gen) for b in (KG_BATCH, 8)}
    for pred in preds.values():
        pred[0] = 3.0 * table[5]  # query 0 ties on the planted rows
    plain_scores = {b: rf.rank_scores_fused_plain(pred, table) for b, pred in preds.items()}

    def topk_call(label, b, nvalid, local=False, planted_rows=None):
        pred = preds[b]
        if local:
            pred = rank_ops.l2_normalize(pred)
            fn, twin = rf.rank_topk_local, rf.rank_topk_local_plain
        else:
            fn, twin = rf.rank_topk_fused, rf.rank_topk_fused_plain
        values, ids = fn(pred, table, k, nvalid)
        torch.cuda.synchronize()
        err = check_topk(f"rank_topk[{label}]", values, ids,
                         plain_scores[b][:, :nvalid], planted_rows)
        twin_v, twin_i = twin(pred, table, k, nvalid)
        flops = 2.0 * b * nvalid * d
        nbytes = 4.0 * (b * d + nvalid * d) + b * k * (4 + 8)
        return {
            "call": label, "shape_in": [b, d], "rows": n, "nvalid": nvalid, "k": k,
            "max_abs_err": err,
            "ids_equal_to_plain": (ids == twin_i).float().mean().item(),
            "ms": cuda_ms(lambda: fn(pred, table, k, nvalid)),
            "kernel_only_ms": cuda_ms(
                lambda: rf.topk_candidates(pred, table, k, nvalid, not local)),
            "plain_ms": cuda_ms(lambda: twin(pred, table, k, nvalid), iters=3, warmup=1),
            "library_ms": cuda_ms(lambda: torch.topk(
                torch.matmul(F.normalize(pred), table[:nvalid].T), k)),
            "flops": flops, "bytes": nbytes,
        }

    topk_calls = [
        topk_call(f"B{KG_BATCH}", KG_BATCH, n, planted_rows=planted),
        topk_call("B8", 8, n, planted_rows=planted),
        # rows at or past nvalid never win, the last planted row among them
        topk_call(f"B{KG_BATCH},nvalid<rows", KG_BATCH, n - 1000, planted_rows=planted[:-1]),
        topk_call(f"local,B{KG_BATCH}", KG_BATCH, n, local=True, planted_rows=planted),
    ]
    # what the k compare-and-insert passes cost: the kernel alone at k = 1 / 16
    pred = preds[KG_BATCH]
    k_sweep = {str(kk): cuda_ms(lambda kk=kk: rf.topk_candidates(pred, table, kk, n, True))
               for kk in (1, KG_TOP_K, 16)}

    b = KG_BATCH
    got = rf.rank_scores_fused(pred, table)
    torch.cuda.synchronize()
    err = (got - plain_scores[b]).abs().max().item()
    if err > RANK_ATOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"rank_scores: differs from the plain twin by {err:.3g}")
    zero = rf.rank_scores_fused(torch.zeros((8, d), device="cuda"), table)
    if zero.abs().max().item() != 0.0:
        raise AssertionError("rank_scores: a zero query row must give zeros")
    del got, zero
    scores_calls = [{
        "call": f"B{b}", "shape_in": [b, d], "rows": n, "max_abs_err": err,
        "ms": cuda_ms(lambda: rf.rank_scores_fused(pred, table)),
        "plain_ms": cuda_ms(lambda: rf.rank_scores_fused_plain(pred, table)),
        "library_ms": cuda_ms(lambda: torch.matmul(F.normalize(pred), table.T)),
        "flops": 2.0 * b * n * d, "bytes": 4.0 * (b * d + n * d + b * n),
    }]

    out = []
    for name, replaces, calls in (
            ("rank_topk", "probgan_tpu/ops/pallas_rank.py:261", topk_calls),
            ("rank_scores", "probgan_tpu/ops/pallas_rank.py:52", scores_calls)):
        for c in calls:
            c["bound_ms"], c["bound_by"] = bound(c["flops"], c["bytes"])
            print(f"  {name}[{c['call']}] x{c['shape_in']} vs {c['rows']} rows: max_abs_err "
                  f"{c['max_abs_err']:.3g}  kernel {c['ms']:.3f} ms  plain "
                  f"{c['plain_ms']:.3f} ms  library {c['library_ms']:.3f} ms  bound "
                  f"{c['bound_ms']:.3f} ms ({c['bound_by']}, {c['flops'] / 1e9:.1f} GFLOP, "
                  f"{c['bytes'] / 1e6:.1f} MB)")
        # the entry's own numbers are those of the main path's shape: calls[0]
        head = calls[0]
        entry = {
            "name": name, "route": "cuda",
            "source": f"probgan_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": 0, "max_abs_err": max(c["max_abs_err"] for c in calls),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "batch": head["shape_in"][0], "calls": calls,
        }
        if name == "rank_topk":
            entry["kernel_only_ms_by_k"] = k_sweep
            print(f"  rank_topk kernel alone (no merge) at B{KG_BATCH} by k: {k_sweep}")
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


def check_same_topk(label: str, got_ids, got_vals, want_ids, want_vals) -> int:
    """Two top-k results of the same queries (lists, descending): values
    within RANK_ATOL position by position; where the ids differ, the id must
    be one the other side also returned, or sit within RANK_ATOL of the k-th
    value (two entities that close may swap). Returns the differing
    positions."""
    got_vals, want_vals = np.asarray(got_vals, np.float32), np.asarray(want_vals, np.float32)
    got_ids, want_ids = np.asarray(got_ids), np.asarray(want_ids)
    if got_ids.shape != want_ids.shape or got_vals.shape != want_vals.shape:
        raise AssertionError(f"{label}: shapes differ: {got_ids.shape} vs {want_ids.shape}")
    err = float(np.abs(got_vals - want_vals).max())
    if not np.isfinite(got_vals).all() or err > RANK_ATOL:
        raise AssertionError(f"{label}: scores differ by {err:.3g}")
    swapped = 0
    for q, j in zip(*np.nonzero(got_ids != want_ids)):
        swapped += 1
        for ids, vals, other in ((got_ids, got_vals, want_ids), (want_ids, want_vals, got_ids)):
            if ids[q, j] not in other[q] and vals[q, j] - vals[q, -1] > RANK_ATOL:
                raise AssertionError(f"{label}: query {q} position {j}: id {ids[q, j]} "
                                     "is missing from the other result")
    print(f"  {label}: max |score diff| {err:.3g}, {swapped} of {got_ids.size} "
          "positions hold another id (near-ties)")
    return swapped


def assert_close_tree(label: str, got, want, atol: float) -> None:
    """Equal keys, ints and strings; floats within atol."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            raise AssertionError(f"{label}: keys differ")
        for key in want:
            assert_close_tree(f"{label}[{key!r}]", got[key], want[key], atol)
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{label}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_tree(f"{label}[{i}]", g, w, atol)
    elif isinstance(want, float):
        if not (isinstance(got, float) and math.isfinite(got) and abs(got - want) <= atol):
            raise AssertionError(f"{label}: {got} vs {want}")
    elif got != want:
        raise AssertionError(f"{label}: {got!r} vs {want!r}")


def json_blob(text: str) -> dict:
    """The CLI prints banners, then one indented JSON object."""
    return json.loads(text[text.index("{\n"):])


def phase_kg_path(rf, inference_mod, checkpoint_mod, cli_infer,
                  make_kg_checkpoint) -> tuple[dict, dict]:
    rng = np.random.default_rng(1)
    pairs = [(int(h), int(r)) for h, r in zip(rng.integers(0, KG_ENTITIES, KG_BATCH),
                                              rng.integers(0, KG_RELATIONS, KG_BATCH))]
    quiet = io.StringIO()  # the engine's banners
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "best_checkpoint.pt")
        t0 = time.perf_counter()
        checkpoint_mod.save_checkpoint(path, make_kg_checkpoint(
            KG_ENTITIES, KG_RELATIONS, KG_DIM, KG_NOISE, KG_HIDDEN, seed=0))
        print(f"  wrote {os.path.getsize(path) / 1e6:.0f} MB checkpoint in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(quiet):
            engine = inference_mod.InferenceEngine(path, device="cuda", seed=0)
        load_s = time.perf_counter() - t0
        if engine.num_entities != KG_ENTITIES or engine.entity_norm.device.type != "cuda":
            raise AssertionError("the engine did not load the table onto the card")

        def predict(eng, top_k=KG_TOP_K):
            with contextlib.redirect_stdout(quiet):
                return eng.predict_tails(pairs, top_k=top_k, return_scores=True)

        first = predict(engine)  # warm-up; also noise draw 0, compared below
        torch.cuda.synchronize()

        rf.reset_launches()
        times = []
        for i in range(KG_CALLS):
            t0 = time.perf_counter()
            res = predict(engine)  # returns host lists: the call has finished
            times.append(time.perf_counter() - t0)
            if rf.launches != {"rank_topk": i + 1, "rank_scores": 0}:
                raise AssertionError(f"predict_tails call {i}: launches {rf.launches}, "
                                     "expected one rank_topk per call")
            ids, vals = np.asarray(res["predictions"]), np.asarray(res["scores"])
            if ids.shape != (KG_BATCH, KG_TOP_K) or vals.shape != (KG_BATCH, KG_TOP_K):
                raise AssertionError(f"predict_tails returned {ids.shape} / {vals.shape}")
            if ids.min() < 0 or ids.max() >= KG_ENTITIES or not np.isfinite(vals).all():
                raise AssertionError("predict_tails: ids out of range or scores not finite")

        t0 = time.perf_counter()
        res32 = predict(engine, top_k=32)
        top32_s = time.perf_counter() - t0
        if rf.launches != {"rank_topk": KG_CALLS, "rank_scores": 1}:
            raise AssertionError(f"top_k 32: launches {rf.launches}, expected one rank_scores")
        vals32 = np.asarray(res32["scores"], np.float32)
        if vals32.shape != (KG_BATCH, 32) or (np.diff(vals32, axis=1) > 0).any():
            raise AssertionError("top_k 32: wrong shape or scores not descending")

        seen_k = []
        launch_topk = rf.topk_candidates

        def spy(pred, table, k, nvalid, normalize):
            seen_k.append(k)
            return launch_topk(pred, table, k, nvalid, normalize)

        rf.topk_candidates = spy
        try:
            with contextlib.redirect_stdout(quiet):
                sim = engine.find_similar_entities([0, 7, 123456], top_k=10)
        finally:
            rf.topk_candidates = launch_topk
        if seen_k != [11] or rf.launches["rank_topk"] != KG_CALLS + 1:
            raise AssertionError(f"find_similar_entities: rank_topk k {seen_k}, "
                                 f"launches {rf.launches}")
        for entry in sim["similar_entities"]:
            if (len(entry["similar_entities"]) != 10
                    or entry["query_entity"] in entry["similar_entities"]):
                raise AssertionError("find_similar_entities: the query was not excluded")
        counts = dict(rf.launches)  # the KG path's run ends here
        print(f"  launch counts over {KG_CALLS} predict_tails calls, one with top_k 32 "
              f"and one find_similar_entities: {counts}")

        # the same engine code with each kernel's plain twin in its place, on
        # the card, under the same noise (a fresh engine's draw 0)
        kernels = {name: getattr(rf, name) for name in
                   ("rank_topk_fused", "rank_topk_local", "rank_scores_fused")}
        try:
            for name in kernels:
                setattr(rf, name, getattr(rf, f"{name}_plain"))
            with contextlib.redirect_stdout(quiet):
                twin_engine = inference_mod.InferenceEngine(path, device="cuda", seed=0)
            twins = predict(twin_engine)
            with contextlib.redirect_stdout(quiet):
                twin_sim = twin_engine.find_similar_entities([0, 7, 123456], top_k=10)
        finally:
            for name, fn in kernels.items():
                setattr(rf, name, fn)
        if rf.launches != counts:
            raise AssertionError("the plain twins launched a kernel")
        swapped = check_same_topk("predict_tails vs its plain twins on the card",
                                  first["predictions"], first["scores"],
                                  twins["predictions"], twins["scores"])
        for a, b in zip(sim["similar_entities"], twin_sim["similar_entities"]):
            check_same_topk(f"find_similar_entities({a['query_entity']}) vs plain twins",
                            [a["similar_entities"]], [a["similarity_scores"]],
                            [b["similar_entities"]], [b["similarity_scores"]])
        del twin_engine
        torch.cuda.empty_cache()

        # tasks without a rank kernel, and the rank tasks again, against the
        # engine on the CPU built from the same file
        with contextlib.redirect_stdout(quiet):
            cpu_engine = inference_mod.InferenceEngine(path, device="cpu", seed=0)
            triplets = [(0, 1, 2), (123456, 999, 7), (999_999, 0, 500_000)]
            # each task has its own noise counter: both engines make draw 0
            got_scores = engine.score_triplets(triplets, method="both")
            want_scores = cpu_engine.score_triplets(triplets, method="both")
            got_rel = engine.analyze_relations([0, 123456], [7, 999_999], top_k=5)
            want_rel = cpu_engine.analyze_relations([0, 123456], [7, 999_999], top_k=5)
            cpu_sim = cpu_engine.find_similar_entities([0, 7, 123456], top_k=10)
        assert_close_tree("score_triplets vs the CPU engine", got_scores, want_scores, 1e-5)
        assert_close_tree("analyze_relations vs the CPU engine", got_rel, want_rel, 1e-5)
        if len(got_rel["relation_analysis"]) != 4 or any(
                len(e["top_relations"]) != 5
                or any(not 0 <= r["relation_id"] < KG_RELATIONS for r in e["top_relations"])
                for e in got_rel["relation_analysis"]):
            raise AssertionError("analyze_relations: wrong shape or a padded relation id")
        for a, b in zip(sim["similar_entities"], cpu_sim["similar_entities"]):
            check_same_topk(f"find_similar_entities({a['query_entity']}) vs the CPU engine",
                            [a["similar_entities"]], [a["similarity_scores"]],
                            [b["similar_entities"]], [b["similarity_scores"]])
        print("  score_triplets and analyze_relations agree with the CPU engine "
              "(atol 1e-5, relation ids equal)")
        del cpu_engine, engine
        torch.cuda.empty_cache()

        # the CLI in process, and the REPL fed from stdin
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_infer.main(["--checkpoint_path", path, "--task", "predict_tails",
                            "--input_pairs", "[[0,1],[2,3]]", "--top_k", "5",
                            "--device", "cuda"])
        cli_pred = json_blob(out.getvalue())
        if (np.asarray(cli_pred["predictions"]).shape != (2, 5)
                or cli_pred["metadata"]["num_queries"] != 2):
            raise AssertionError(f"CLI predict_tails printed {cli_pred}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_infer.main(["--checkpoint_path", path, "--task", "model_info",
                            "--device", "cuda"])
        info = json_blob(out.getvalue())
        if info["device"] != "cuda:0" or info["model_architecture"] != {
                "embedding_dim": KG_DIM, "noise_dim": KG_NOISE, "hidden_dim": KG_HIDDEN,
                "num_entities": KG_ENTITIES, "num_relations": KG_RELATIONS}:
            raise AssertionError(f"CLI model_info printed {info}")
        out, stdin = io.StringIO(), sys.stdin
        sys.stdin = io.StringIO("predict 0 1 3\ninfo\nquit\n")
        try:
            with contextlib.redirect_stdout(out):
                cli_infer.main(["--checkpoint_path", path, "--task", "interactive",
                                "--device", "cuda"])
        finally:
            sys.stdin = stdin
        repl_out = out.getvalue()
        for needle in ("Top 3 predictions for (0, 1):", "   3. Entity ", "Model Information:",
                       "Entities: 1,000,000", "Device: cuda:0", "done!"):
            if needle not in repl_out:
                raise AssertionError(f"REPL output lacks {needle!r}:\n{repl_out[-2000:]}")
        print("  CLI predict_tails and model_info (device cuda:0) and the piped REPL ran")

    per_call_ms = sorted(t * 1e3 for t in times)
    kg = {
        "entities": KG_ENTITIES, "relations": KG_RELATIONS, "embed_dim": KG_DIM,
        "batch": KG_BATCH, "top_k": KG_TOP_K, "calls": KG_CALLS,
        "queries_per_s": KG_BATCH * KG_CALLS / sum(times),
        "p50_ms_per_call": float(np.median(per_call_ms)), "call_s": times,
        "top_k_32_call_ms": top32_s * 1e3, "engine_load_s": load_s,
        "positions_with_another_id_vs_plain_twins": swapped,
    }
    print(f"  {kg['queries_per_s']:.1f} queries/s, p50 {kg['p50_ms_per_call']:.3f} ms per "
          f"call (predict_tails, {KG_BATCH} pairs, top_k {KG_TOP_K}, {KG_CALLS} calls, host "
          f"clock incl. copy to host); top_k 32: {kg['top_k_32_call_ms']:.1f} ms per call")
    return counts, kg


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from probgan_tpu_torch.cli import infer as cli_infer
    from probgan_tpu_torch.core import checkpoint as checkpoint_mod
    from probgan_tpu_torch.engine import image as engine_mod
    from probgan_tpu_torch.engine import inference as inference_mod
    from probgan_tpu_torch.models import pro_gan
    from probgan_tpu_torch.ops import _build
    from probgan_tpu_torch.ops import packed as pk
    from probgan_tpu_torch.ops import rank as rank_ops
    from probgan_tpu_torch.ops import rank_fused as rf
    from probgan_tpu_torch.utils.demo_checkpoint import make_kg_checkpoint

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

    print("phase 2: generator kernels vs plain twins (batch 2, main-path shapes)")
    kernels = phase_kernels(pk, pro_gan)
    torch.cuda.empty_cache()

    print("phase 3: main path, ImageGANEngine.generate at 1024²")
    counts, main = phase_main_path(pk, pro_gan, engine_mod)
    torch.cuda.empty_cache()

    print(f"phase 4: rank kernels vs plain twins (N = {KG_ENTITIES:,}, D = {KG_DIM})")
    kernels += phase_rank_kernels(rf, rank_ops)
    torch.cuda.empty_cache()

    print(f"phase 5: KG path, InferenceEngine at N = {KG_ENTITIES:,}")
    kg_counts, kg = phase_kg_path(rf, inference_mod, checkpoint_mod, cli_infer,
                                  make_kg_checkpoint)
    counts.update(kg_counts)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} was not launched on its main path")

    print(card_line())
    print(json.dumps({"kernels": kernels, "main_path": main, "kg_path": kg, "card": card},
                     allow_nan=False))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
