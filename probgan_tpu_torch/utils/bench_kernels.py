"""Times the port's conv and rank kernels, the train step and ``generate`` on
one CUDA card, in parts (``--parts``, all by default):

- ``rank``: ``rank_scores_fused`` and ``rank_topk_fused`` (k = 10) at
  N = 1,000,000, D = 128, B = 64 and 8;
- ``none``: ``packed_conv(..., epilogue="none")`` at the (C, Cout, H) the
  1024² train step gives it, batch 2;
- ``fp32``: ``packed_upconv`` "lrelu_norm" / "lrelu" at stages 7 and 8
  (batch 2, and "lrelu_norm" with the toRGB of stage 8 at batch 8 as
  ``generate`` runs it), ``packed_conv`` "lrelu" / "lrelu_norm" at the
  score (batch 8), train-step and recompute (batch 2) shapes, and
  ``packed_conv_rgb`` (uint8 at alpha 1, fp32 at alpha 0.3) at stage 8
  (32 -> 32 at 1024²) and stage 7 (64 -> 64 at 512²), batch 2 and 8;
- ``train``: ``progan_train_step`` at 1024², stage 8, batch 2, packed,
  ``remat``, ``packed_train_mode="highest"``: steps/s and p50 over timed
  steps (host clock to the metrics on the host);
- ``generate``: ``ImageGANEngine.generate`` at 1024², batch 8, at the grade
  ``--precision`` ("high" by default): img/s and p50 ms per image (host clock
  to the uint8 images on the host);
- ``bf16``: kernel mode "default" (one bf16 pass) of ``packed_upconv``
  (stage 7, stage 8 with toRGB), ``packed_conv`` "lrelu_norm" (stage 7) and
  ``packed_conv_rgb`` (stage 8, uint8 and fp32) at batch 2 and 8, the bound
  at the bf16 tensor-core peak;
- ``mid``: kernel mode "mid" (the 2-term split) of ``packed_upconv``
  ("lrelu_norm" and "lrelu"), ``packed_conv`` ("lrelu_norm", "lrelu",
  "none"), ``packed_convpool`` ("lrelu", "none") and ``packed_conv_rgb``
  at the shapes of ``score`` at "fast", the train step at
  ``packed_train_mode="mid"`` and ``generate`` with G's packed mode "mid",
  the bound at the bf16 peak for the two passes' products;
- ``bwd``: kernel mode "default" of the training backward at the shapes of
  the train step at ``packed_train_mode="default"`` (batch 2):
  ``packed_upconv`` "lrelu", ``packed_conv`` "lrelu" and "none",
  ``packed_convpool`` "lrelu" and "none", and ``packed_conv_wgrad`` at its
  six shapes beside its fp32 (3xTF32) kernel, the bound at the bf16 peak;
- ``fused``: the stage-fused kernels B10 ``packed_upconv_conv`` (stage 7)
  and B11 ``packed_upconv_conv_rgb`` (stage 8 uint8 and fp32, stage 7
  uint8) at batch 2 and 8, and at the narrow generator N's shapes (B10
  32 -> 16, B11 16 -> 8 uint8 and fp32, B11 32 -> 16) where the tree takes
  them, each beside the two-kernel pair it replaces at its kernel mode:
  "high" (the fp32 ring), and "default" and "mid" where the tree's
  wrappers take ``mode``; then ``generate`` (batch 8) at "high" and
  "fast" and the image trainer CLI's step (``progan_train_step`` with
  ``packed_fake`` at "highest", stage 8, batch 2) with
  ``PROBGAN_STAGE_FUSED`` 1 and 0 in turns in one process;
- ``convpool``: B5 ``packed_convpool`` at every kernel mode ("high",
  "default", "mid"), epilogue and slab width it runs: ``score``'s 32 -> 64
  at 1024² and 64 -> 128 at 512² (batch 8, "lrelu"), the 1024² train step's
  (batch 2, "lrelu" and "none"), the narrow generator N's 8 -> 16 at 1024²
  and 16 -> 32 at 512² (batch 8 and 2, "lrelu"; "none" 8 -> 16 at batch 2),
  8 -> 8 at 1024² (a slab of 8, "none") and a ragged 24 -> 40 at 64² (a
  partial chunk of input channels, 5 slabs of 8), each with ``alone_ms``
  and ``library_ms`` (below; at "high" cuDNN in fp32 with TF32 off), and
  ``b2_ms`` / ``b2_alone_ms``: B2 ``packed_conv`` "lrelu" at the same conv
  and mode, the same ring and products without the pool;
- ``rgb``: B3 ``packed_conv_rgb`` at every kernel mode ("high", "default",
  "mid"), uint8 (alpha 1) and fp32 (alpha 0.3), at ``generate``'s
  32 -> 32 at 1024² (stage 8) and 64 -> 64 at 512² (stage 7), the narrow
  generator N's 8 -> 8 at 1024² and 16 -> 16 at 512², and a ragged 40 -> 32
  at 64² (a partial chunk of input channels), batch 2 and 8, each with
  ``alone_ms`` and ``library_ms`` (cuDNN ``F.conv2d`` with the torch
  epilogue, toRGB, blend and denorm: bf16 tensors at "default", the
  bf16-rounded weights at "mid", fp32 with TF32 off at "high"), and
  ``b2_ms`` / ``b2_alone_ms``: B2 ``packed_conv`` "lrelu" at the same conv
  and mode, the same ring and products without the toRGB tail;
- ``narrow``: the kernels at 16 and 8 channels of the narrow 1024² generator
  (fmap_base 2048, fmap_max 256; packed stages 6-8): ``packed_upconv``
  32 -> 16 and 16 -> 8 (with toRGB), ``packed_conv`` "lrelu_norm" 16 -> 16
  and "lrelu" 8 -> 8 and 16 -> 16, ``packed_conv_rgb`` 8 -> 8 (uint8) and
  ``packed_convpool`` 8 -> 16 and 16 -> 32, and ``packed_conv`` "none" at
  its four shapes in N's train step, at batch 2 and 8, each at "high",
  "default" and "mid", beside ``F.conv2d`` with the torch epilogue (fp32 with
  TF32 off; on bf16 tensors at "default"; the bf16-rounded weights at "mid");
- ``any_width``: the serving path's PixelNorm kernels at the widths of the
  1024² generators of fmap_base 1024, 512 and 3072 (ROADMAP.md B.a.2.3):
  ``packed_upconv`` "lrelu_norm" 8 -> 4, 4 -> 2, 24 -> 12 (with toRGB),
  8 -> 4, 96 -> 48, 48 -> 24, ``packed_conv`` "lrelu_norm" 4 -> 4, 48 -> 48,
  24 -> 24 and ``packed_conv_rgb`` 4 -> 4, 2 -> 2, 12 -> 12 (uint8 and
  fp32), and ``packed_conv`` "lrelu_norm" 8 -> 8 at 1024² (the narrow
  generator N's stage-8 shape), at batch 2 and 8, each at "high", "default"
  and "mid": ms, ``alone_ms``, the plain twin's ms, cuDNN's ms (the torch
  epilogue, toRGB, blend and denorm beside it) and the bound.

Each B1 ``packed_upconv``, B2 ``packed_conv`` and B5 ``packed_convpool``
row of ``bf16``, ``mid``, ``bwd`` and ``narrow`` also gives ``alone_ms``,
the kernel launch alone (the wrapper's weights prepared once, outside the
timed window: one call records the C launch and keeps what it was handed
alive, then only that launch is timed), and ``library_ms``, ``F.conv2d``
with the torch epilogue (and B5's ``F.avg_pool2d``) on bf16 tensors at
"default" and with the bf16-rounded weights at "mid".

``--dump DIR`` saves each ``none``, ``fp32``, ``bf16``, ``mid``, ``bwd``,
``fused``, ``convpool``, ``rgb`` and ``narrow`` output, made from fixed seeds, to
``DIR/<shape>.pt`` (and with ``rank`` the ``rank_scores_fused`` matrices,
with ``generate`` the first call's images);
``--compare A B`` counts the values whose bits differ between two such
directories (0 everywhere: the same bits).

It calls only public entry points, so the same file times an older tree of
the package: put that tree first on ``PYTHONPATH`` and run this file by its
path. Prints the card's name and power limit and one JSON line::

    python3 -m probgan_tpu_torch.utils.bench_kernels [--parts fp32,generate] [--dump DIR]
    PYTHONPATH=OLD_TREE python3 probgan_tpu_torch/utils/bench_kernels.py --dump DIR_OLD
    python3 -m probgan_tpu_torch.utils.bench_kernels --compare DIR_OLD DIR
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import math
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

PARTS = ("rank", "none", "fp32", "train", "generate", "fused", "bf16", "mid", "bwd", "narrow",
         "convpool", "rgb", "any_width")
CONV_SHAPES = ((32, 32, 1024), (64, 32, 1024), (64, 64, 512), (128, 64, 512),
               (32, 64, 1024), (64, 128, 512))
# (label, kernel, epilogue, batch, C, Cout, H, toRGB): the fp32 launches
FP32_SHAPES = (
    ("upconv_s7_lrelu_norm_b2", "packed_upconv", "lrelu_norm", 2, 128, 64, 256, False),
    ("upconv_s8_lrelu_norm_b2", "packed_upconv", "lrelu_norm", 2, 64, 32, 512, False),
    ("upconv_s7_lrelu_b2", "packed_upconv", "lrelu", 2, 128, 64, 256, False),
    ("upconv_s8_lrelu_b2", "packed_upconv", "lrelu", 2, 64, 32, 512, False),
    ("upconv_s7_lrelu_norm_b8", "packed_upconv", "lrelu_norm", 8, 128, 64, 256, False),
    ("upconv_s8_rgb_lrelu_norm_b8", "packed_upconv", "lrelu_norm", 8, 64, 32, 512, True),
    ("conv_C32_Cout32_1024_lrelu_b2", "packed_conv", "lrelu", 2, 32, 32, 1024, False),
    ("conv_C64_Cout64_512_lrelu_b2", "packed_conv", "lrelu", 2, 64, 64, 512, False),
    ("conv_C32_Cout32_1024_lrelu_b8", "packed_conv", "lrelu", 8, 32, 32, 1024, False),
    ("conv_C64_Cout64_512_lrelu_b8", "packed_conv", "lrelu", 8, 64, 64, 512, False),
    ("conv_C32_Cout64_1024_lrelu_b2", "packed_conv", "lrelu", 2, 32, 64, 1024, False),
    ("conv_C64_Cout128_512_lrelu_b2", "packed_conv", "lrelu", 2, 64, 128, 512, False),
    ("conv_C64_Cout64_512_lrelu_norm_b2", "packed_conv", "lrelu_norm", 2, 64, 64, 512, False),
    ("conv_C64_Cout64_512_lrelu_norm_b8", "packed_conv", "lrelu_norm", 8, 64, 64, 512, False),
    ("conv_rgb_s8_uint8_b2", "packed_conv_rgb", "uint8", 2, 32, 32, 1024, True),
    ("conv_rgb_s8_fp32_b2", "packed_conv_rgb", "fp32", 2, 32, 32, 1024, True),
    ("conv_rgb_s7_uint8_b2", "packed_conv_rgb", "uint8", 2, 64, 64, 512, True),
    ("conv_rgb_s7_fp32_b2", "packed_conv_rgb", "fp32", 2, 64, 64, 512, True),
    ("conv_rgb_s8_uint8_b8", "packed_conv_rgb", "uint8", 8, 32, 32, 1024, True),
    ("conv_rgb_s8_fp32_b8", "packed_conv_rgb", "fp32", 8, 32, 32, 1024, True),
    ("conv_rgb_s7_uint8_b8", "packed_conv_rgb", "uint8", 8, 64, 64, 512, True),
    ("conv_rgb_s7_fp32_b8", "packed_conv_rgb", "fp32", 8, 64, 64, 512, True),
)
# (label, kernel, batch, C, Cout, input H, emit): the stage-fused launches
# at 1024² ("features": B10; "uint8" / "fp32": B11 at alpha 1 / 0.3); then
# the narrow generator N's (fmap_base 2048, fmap_max 256), labelled "n7" /
# "n8": B10 32 -> 16 and B11 16 -> 8 (stages 7 and 8), B11 32 -> 16
# (latent_walk at stage 7), timed where the tree's stage-fused kernels take
# 16 and 8 channels
FUSED_SHAPES = tuple(
    (f"{kind}_{stage}_{emit}_b{bsz}", kind, bsz, c, cout, h, emit)
    for shapes in ((("upconv_conv", "s7", 128, 64, 256, "features"),
                    ("upconv_conv_rgb", "s8", 64, 32, 512, "uint8"),
                    ("upconv_conv_rgb", "s8", 64, 32, 512, "fp32"),
                    ("upconv_conv_rgb", "s7", 128, 64, 256, "uint8")),
                   (("upconv_conv", "n7", 32, 16, 256, "features"),
                    ("upconv_conv_rgb", "n8", 16, 8, 512, "uint8"),
                    ("upconv_conv_rgb", "n8", 16, 8, 512, "fp32"),
                    ("upconv_conv_rgb", "n7", 32, 16, 256, "uint8")))
    for bsz in (2, 8)
    for kind, stage, c, cout, h, emit in shapes)
# (label, kernel, batch, C, Cout, H, emit): the bf16 launches of "fast" generate
BF16_SHAPES = tuple(
    (f"{kernel}_{stage}_{emit}_b{bsz}", kernel, bsz, c, cout, h, emit)
    for bsz in (2, 8)
    for kernel, stage, c, cout, h, emit in (
        ("packed_upconv", "s7", 128, 64, 256, "features"),
        ("packed_upconv", "s8", 64, 32, 512, "rgb"),
        ("packed_conv", "s7", 64, 64, 512, "features"),
        ("packed_conv_rgb", "s8", 32, 32, 1024, "uint8"),
        ("packed_conv_rgb", "s8", 32, 32, 1024, "fp32")))
# (label, kernel, epilogue, batch, C, Cout, H, emit): the "mid" launches of
# score at "fast", the train step at "mid" and generate with G's "mid"
MID_SHAPES = (
    *((f"upconv_{s}_{epi}_b{bsz}", "packed_upconv", epi, bsz, c, cout, h, emit)
      for epi, bsz, s, c, cout, h, emit in (
          ("lrelu_norm", 2, "s7", 128, 64, 256, "features"),
          ("lrelu_norm", 2, "s8", 64, 32, 512, "features"),
          ("lrelu_norm", 8, "s8", 64, 32, 512, "rgb"),
          ("lrelu", 2, "s7", 128, 64, 256, "features"),
          ("lrelu", 2, "s8", 64, 32, 512, "features"))),
    *((f"{kernel[7:]}_C{c}_Cout{cout}_{h}_{epi}_b{bsz}", kernel, epi, bsz, c, cout, h,
       "features")
      for kernel, epi, bsz, c, cout, h in (
          ("packed_conv", "lrelu_norm", 2, 32, 32, 1024),
          ("packed_conv", "lrelu_norm", 8, 64, 64, 512),
          ("packed_conv", "lrelu", 8, 32, 32, 1024),
          ("packed_conv", "lrelu", 8, 64, 64, 512),
          ("packed_conv", "lrelu", 2, 32, 64, 1024),
          ("packed_conv", "lrelu", 2, 64, 128, 512),
          ("packed_conv", "none", 2, 32, 32, 1024),
          ("packed_conv", "none", 2, 64, 32, 1024),
          ("packed_conv", "none", 2, 64, 64, 512),
          ("packed_conv", "none", 2, 128, 64, 512),
          ("packed_convpool", "lrelu", 8, 32, 64, 1024),
          ("packed_convpool", "lrelu", 8, 64, 128, 512),
          ("packed_convpool", "none", 2, 32, 64, 1024),
          ("packed_convpool", "none", 2, 64, 128, 512))),
    ("conv_rgb_s8_uint8_b8", "packed_conv_rgb", "lrelu_norm", 8, 32, 32, 1024, "uint8"),
    ("conv_rgb_s8_fp32_b2", "packed_conv_rgb", "lrelu_norm", 2, 32, 32, 1024, "fp32"),
)
# (label, kernel, epilogue, C, Cout, H): the "default" backward's launches of
# the train step at packed_train_mode "default", batch 2 (H the input's)
BWD_SHAPES = (
    *((f"upconv_{s}_lrelu", "packed_upconv", "lrelu", c, cout, h)
      for s, c, cout, h in (("s7", 128, 64, 256), ("s8", 64, 32, 512))),
    *((f"{kernel[7:]}_C{c}_Cout{cout}_{h}_{epi}", kernel, epi, c, cout, h)
      for kernel, epi, c, cout, h in (
          ("packed_conv", "lrelu", 32, 32, 1024),
          ("packed_conv", "lrelu", 64, 64, 512),
          ("packed_conv", "lrelu", 32, 64, 1024),
          ("packed_conv", "lrelu", 64, 128, 512),
          ("packed_conv", "none", 32, 32, 1024),
          ("packed_conv", "none", 64, 32, 1024),
          ("packed_conv", "none", 64, 64, 512),
          ("packed_conv", "none", 128, 64, 512),
          ("packed_convpool", "lrelu", 32, 64, 1024),
          ("packed_convpool", "lrelu", 64, 128, 512),
          ("packed_convpool", "none", 32, 64, 1024),
          ("packed_convpool", "none", 64, 128, 512))),
    *((f"wgrad_C{c}_Cout{cout}_{h}", "packed_conv_wgrad", None, c, cout, h)
      for c, cout, h in ((32, 32, 1024), (32, 64, 1024), (64, 64, 512), (64, 128, 512),
                         (128, 64, 512), (64, 32, 1024))),
)
# (kernel, epilogue or emit, C, Cout, H): the narrow generator's launches at
# 16 and 8 channels (H: B1's input), its train step's input gradients ("none")
# last, at batch 2 and 8 and each kernel mode
NARROW_SHAPES = (
    ("packed_upconv", "lrelu_norm", 32, 16, 256), ("packed_upconv", "rgb", 16, 8, 512),
    ("packed_conv", "lrelu_norm", 16, 16, 512), ("packed_conv", "lrelu", 8, 8, 1024),
    ("packed_conv", "lrelu", 16, 16, 512), ("packed_conv_rgb", "uint8", 8, 8, 1024),
    ("packed_convpool", "lrelu", 8, 16, 1024), ("packed_convpool", "lrelu", 16, 32, 512),
    ("packed_conv", "none", 8, 8, 1024), ("packed_conv", "none", 16, 8, 1024),
    ("packed_conv", "none", 16, 16, 512), ("packed_conv", "none", 32, 16, 512),
)
# (epilogue, batch, C, Cout, H): B5's launches, each at "high", "default"
# and "mid": score's, the train step's, N's, a slab of 8, a ragged case
CONVPOOL_SHAPES = (
    ("lrelu", 8, 32, 64, 1024), ("lrelu", 8, 64, 128, 512),
    ("lrelu", 2, 32, 64, 1024), ("lrelu", 2, 64, 128, 512),
    ("none", 2, 32, 64, 1024), ("none", 2, 64, 128, 512),
    ("lrelu", 8, 8, 16, 1024), ("lrelu", 8, 16, 32, 512),
    ("lrelu", 2, 8, 16, 1024), ("lrelu", 2, 16, 32, 512), ("none", 2, 8, 16, 1024),
    ("none", 2, 8, 8, 1024), ("lrelu", 2, 24, 40, 64), ("none", 2, 24, 40, 64),
)
# (kernel, epilogue or emit, C, Cout, H): the launches of generate at the
# widths of T, T2 and O (fmap_base 1024, 512, 3072 at 1024²; B1's H its
# input's), then B2 "lrelu_norm" 8 -> 8 at 1024²; at batch 2 and 8, each mode
ANY_WIDTH_SHAPES = (
    ("packed_upconv", "rgb", 8, 4, 512), ("packed_upconv", "lrelu_norm", 8, 4, 256),
    ("packed_upconv", "rgb", 4, 2, 512), ("packed_upconv", "lrelu_norm", 96, 48, 128),
    ("packed_upconv", "lrelu_norm", 48, 24, 256), ("packed_upconv", "rgb", 24, 12, 512),
    ("packed_conv", "lrelu_norm", 4, 4, 512), ("packed_conv", "lrelu_norm", 48, 48, 256),
    ("packed_conv", "lrelu_norm", 24, 24, 512), ("packed_conv_rgb", "uint8", 4, 4, 1024),
    ("packed_conv_rgb", "fp32", 4, 4, 1024), ("packed_conv_rgb", "uint8", 2, 2, 1024),
    ("packed_conv_rgb", "fp32", 2, 2, 1024), ("packed_conv_rgb", "uint8", 12, 12, 1024),
    ("packed_conv_rgb", "fp32", 12, 12, 1024), ("packed_conv", "lrelu_norm", 8, 8, 1024),
)
# (batch, C, Cout, H): B3's launches, each at "high", "default" and "mid",
# uint8 and fp32: generate's stages 8 and 7, N's, a ragged C
RGB_SHAPES = tuple((bsz, *s) for bsz in (2, 8)
                   for s in ((32, 32, 1024), (64, 64, 512), (8, 8, 1024), (16, 16, 512),
                             (40, 32, 64)))
PEAK_FP32_FLOPS = 67e12  # H100 SXM, CUDA cores
PEAK_BF16_FLOPS = 989e12  # H100 SXM, tensor cores, dense bf16
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3


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


def alone_ms(pk, call, iters: int = 10) -> float:
    """ms of the kernel launches that one ``call`` of a wrapper makes, timed
    alone: the call runs once with ``_build.launch`` recording its arguments
    and with the weights (``conv_bf16_weights``, ``upconv_bf16_weights``,
    ``_bf16``, ``convpool_kernel_weights``, ``conv_kernel_weights``,
    ``upconv_kernel_weights`` and, where the tree has it, the zero padding of
    ``pad_cout``) it hands the kernel kept alive; then only the recorded launches run in the timed
    window. Works on any tree whose wrappers launch through
    ``_build.launch``."""
    from probgan_tpu_torch.ops import _build

    real = _build.launch
    recorded, kept = [], []
    patched = {n: getattr(pk, n) for n in ("conv_bf16_weights", "upconv_bf16_weights", "_bf16",
                                           "convpool_kernel_weights", "conv_kernel_weights",
                                           "pad_cout", "upconv_kernel_weights")
               if hasattr(pk, n)}

    def keep(fn):
        def kept_fn(*args, **kwargs):
            out = fn(*args, **kwargs)
            kept.append(out)
            return out
        return kept_fn

    def record(*args):
        recorded.append(args)
        real(*args)
    try:
        _build.launch = record
        for n, fn in patched.items():
            setattr(pk, n, keep(fn))
        with torch.no_grad():
            kept.append(call())
    finally:
        _build.launch = real
        for n, fn in patched.items():
            setattr(pk, n, fn)
    assert recorded, "the call launched no kernel"

    def replay():
        for args in recorded:
            real(*args)
    return cuda_ms(replay, iters=iters)


def conv_library(kernel: str, epi: str, mode: str, x, w, b, rgb_w=None, rgb_b=None):
    """One cuDNN ``F.conv2d`` (after a nearest-2x upsample for B1) with the
    torch epilogue (and B5's 2x2 mean), the function of ``kernel`` at
    ``mode``: bf16 tensors at "default", the bf16-rounded weights in fp32
    (TF32 off) at "mid", fp32 at "high"; with ``rgb_w`` also B1's toRGB of
    the input."""
    import torch.nn.functional as F

    from probgan_tpu_torch.models import pro_gan

    dtype = torch.bfloat16 if mode == "default" else torch.float32
    xl, bl = x.to(dtype), b.to(dtype)
    wl = w if mode == "high" else w.to(torch.bfloat16).to(dtype)

    def act(y):
        if epi == "lrelu_norm":
            return pro_gan.pixel_norm(pro_gan.lrelu(y.float()))
        return pro_gan.lrelu(y) if epi == "lrelu" else y

    def library():
        src = F.interpolate(xl, scale_factor=2.0) if kernel == "packed_upconv" else xl
        y = act(F.conv2d(src, wl, bl, padding=1))
        if kernel == "packed_convpool":
            y = F.avg_pool2d(y, 2)
        if rgb_w is None:
            return y
        return y, F.conv2d(xl, rgb_w.to(dtype)[:, :, None, None], rgb_b.to(dtype))
    return library


def alone_and_library(pk, kernel: str, epi: str, mode: str, call, x, w, b, rgb_w=None,
                rgb_b=None) -> dict:
    """``alone_ms`` and ``library_ms`` of a B1 / B2 / B5 row."""
    if kernel not in ("packed_upconv", "packed_conv", "packed_convpool"):
        return {}
    library = conv_library(kernel, epi, mode, x, w, b, rgb_w, rgb_b)
    with torch.no_grad():
        return {"alone_ms": alone_ms(pk, call), "library_ms": cuda_ms(library, iters=10)}


def bench_fp32(pk, dump: Path | None) -> dict:
    """The fp32 kernels at FP32_SHAPES: ms, bound (fp32 CUDA cores; upconv
    at its 4 pre-summed taps an output) and share, sha256 of the output's
    bytes; the outputs saved under ``dump``."""
    out = {}
    for i, (label, kernel, epi, bsz, c, cout, h, rgb) in enumerate(FP32_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        if kernel == "packed_upconv":
            kw = {"epilogue": epi}
            if rgb:
                kw["rgb_w"] = torch.randn((3, c), device="cuda", generator=gen) / math.sqrt(c)
                kw["rgb_b"] = 0.1 * torch.randn(3, device="cuda", generator=gen)

            def call(x=x, w=w, b=b, kw=kw):
                return pk.packed_upconv(x, w, b, **kw)
            flops = 2 * 4 * c * cout * bsz * 4 * h * h
        elif kernel == "packed_conv_rgb":
            rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
            rgb_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
            prev = 0.5 * torch.randn((bsz, 3, h // 2, h // 2), device="cuda", generator=gen)
            u8 = epi == "uint8"

            def call(x=x, w=w, b=b, rgb_w=rgb_w, rgb_b=rgb_b, prev=prev, u8=u8):
                return pk.packed_conv_rgb(x, w, b, rgb_w, rgb_b, prev, 1.0 if u8 else 0.3,
                                          emit_uint8=u8)
            flops = 2 * 9 * c * cout * bsz * h * h + 2 * cout * 3 * bsz * h * h
        else:
            def call(x=x, w=w, b=b, epi=epi):
                return pk.packed_conv(x, w, b, epilogue=epi)
            flops = 2 * 9 * c * cout * bsz * h * h
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            ys = y if isinstance(y, tuple) else (y,)
            digest = hashlib.sha256()
            for t in ys:
                digest.update(t.cpu().numpy().tobytes())
            if dump is not None:
                torch.save([t.cpu() for t in ys], dump / f"{label}.pt")
            ms = cuda_ms(call, iters=10)
        bound_ms = flops / PEAK_FP32_FLOPS * 1e3
        out[label] = {"ms": ms, "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                      "sha256": digest.hexdigest()}
        del x, y, ys
    return out


def bench_bf16(pk, dump: Path | None) -> dict:
    """Kernel mode "default" at BF16_SHAPES: ms, the bound (the larger of the
    bf16 FLOP at the tensor cores' peak and the fp32 bytes in and out at the
    HBM rate) and its share, sha256 of the output's bytes; the outputs saved
    under ``dump``."""
    out = {}
    for i, (label, kernel, bsz, c, cout, h, emit) in enumerate(BF16_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        if kernel == "packed_upconv":
            kw = {}
            if emit == "rgb":
                kw = {"rgb_w": torch.randn((3, c), device="cuda", generator=gen) / math.sqrt(c),
                      "rgb_b": 0.1 * torch.randn(3, device="cuda", generator=gen)}

            def call(x=x, w=w, b=b, kw=kw):
                return pk.packed_upconv(x, w, b, mode="default", **kw)
            flops = 2 * 4 * c * cout * bsz * 4 * h * h
            nbytes = 4 * bsz * h * h * (c + 4 * cout + (3 if kw else 0))
        elif kernel == "packed_conv_rgb":
            rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
            rgb_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
            prev = 0.5 * torch.randn((bsz, 3, h // 2, h // 2), device="cuda", generator=gen)
            u8 = emit == "uint8"

            def call(x=x, w=w, b=b, rgb_w=rgb_w, rgb_b=rgb_b, prev=prev, u8=u8):
                return pk.packed_conv_rgb(x, w, b, rgb_w, rgb_b, prev, 1.0 if u8 else 0.3,
                                          emit_uint8=u8, mode="default")
            flops = 2 * 9 * c * cout * bsz * h * h + 2 * cout * 3 * bsz * h * h
            nbytes = 4 * bsz * h * h * (c + 3 / 4) + bsz * h * h * 3 * (1 if u8 else 4)
        else:
            def call(x=x, w=w, b=b):
                return pk.packed_conv(x, w, b, mode="default")
            flops = 2 * 9 * c * cout * bsz * h * h
            nbytes = 4 * bsz * h * h * (c + cout)
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            ys = y if isinstance(y, tuple) else (y,)
            digest = hashlib.sha256()
            for t in ys:
                digest.update(t.cpu().numpy().tobytes())
            if dump is not None:
                torch.save([t.cpu() for t in ys], dump / f"bf16_{label}.pt")
            ms = cuda_ms(call, iters=10)
        rgb = kw if kernel == "packed_upconv" else {}
        extra = alone_and_library(pk, kernel, "lrelu_norm", "default", call, x, w, b, **rgb)
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        out[label] = {"ms": ms, "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                      "sha256": digest.hexdigest(), **extra}
        del x, y, ys
    return out


def bench_mid(pk, dump: Path | None) -> dict:
    """Kernel mode "mid" at MID_SHAPES: ms, the bound (the larger of the two
    passes' bf16 FLOP at the tensor cores' peak and the fp32 bytes in and out
    at the HBM rate) and its share, sha256 of the output's bytes; the outputs
    saved under ``dump``."""
    out = {}
    for i, (label, kernel, epi, bsz, c, cout, h, emit) in enumerate(MID_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(400 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        if kernel == "packed_upconv":
            kw = {"epilogue": epi}
            if emit == "rgb":
                kw.update(rgb_w=torch.randn((3, c), device="cuda", generator=gen) / math.sqrt(c),
                          rgb_b=0.1 * torch.randn(3, device="cuda", generator=gen))

            def call(x=x, w=w, b=b, kw=kw):
                return pk.packed_upconv(x, w, b, mode="mid", **kw)
            flops = 2 * 4 * c * cout * bsz * 4 * h * h
            nbytes = 4 * bsz * h * h * (c + 4 * cout + (3 if emit == "rgb" else 0))
        elif kernel == "packed_conv_rgb":
            rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
            rgb_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
            prev = 0.5 * torch.randn((bsz, 3, h // 2, h // 2), device="cuda", generator=gen)
            u8 = emit == "uint8"

            def call(x=x, w=w, b=b, rgb_w=rgb_w, rgb_b=rgb_b, prev=prev, u8=u8):
                return pk.packed_conv_rgb(x, w, b, rgb_w, rgb_b, prev, 1.0 if u8 else 0.3,
                                          emit_uint8=u8, mode="mid")
            flops = 2 * 9 * c * cout * bsz * h * h + 2 * cout * 3 * bsz * h * h
            nbytes = 4 * bsz * h * h * (c + 3 / 4) + bsz * h * h * 3 * (1 if u8 else 4)
        else:
            fn = getattr(pk, kernel)

            def call(x=x, w=w, b=b, fn=fn, epi=epi):
                return fn(x, w, b, epi, mode="mid")
            flops = 2 * 9 * c * cout * bsz * h * h
            nbytes = 4 * bsz * h * h * (c + cout // (4 if kernel == "packed_convpool" else 1))
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            ys = y if isinstance(y, tuple) else (y,)
            digest = hashlib.sha256()
            for t in ys:
                digest.update(t.cpu().numpy().tobytes())
            if dump is not None:
                torch.save([t.cpu() for t in ys], dump / f"mid_{label}.pt")
            ms = cuda_ms(call, iters=10)
        rgb = ({k: v for k, v in kw.items() if k.startswith("rgb")}
               if kernel == "packed_upconv" else {})
        extra = alone_and_library(pk, kernel, epi, "mid", call, x, w, b, **rgb)
        bound_ms = max(2 * flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        out[label] = {"ms": ms, "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                      "sha256": digest.hexdigest(), **extra}
        del x, y, ys
    return out


def bench_narrow(pk, dump: Path | None) -> dict:
    """NARROW_SHAPES at batch 2 and 8, kernel modes "high", "default" and
    "mid": ms, cuDNN's ms (``F.conv2d`` + the torch epilogue), the bound (the
    larger of the FLOP at the mode's peak, "mid"'s two passes, and the bytes
    in and out at the HBM rate) and its share, sha256 of the output's bytes;
    the outputs saved under ``dump``."""
    import torch.nn.functional as F

    from probgan_tpu_torch.models import pro_gan

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t.float()))

    out = {}
    for i, (bsz, mode, (kernel, epi, c, cout, h)) in enumerate(
            (b, m, s) for b in (2, 8) for m in ("high", "default", "mid") for s in NARROW_SHAPES):
        label = f"{kernel[7:]}_{epi}_C{c}_Cout{cout}_{h}_{mode}_b{bsz}"
        gen = torch.Generator(device="cuda").manual_seed(500 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        lib_dtype = torch.bfloat16 if mode == "default" else torch.float32
        xl, bl = x.to(lib_dtype), b.to(lib_dtype)
        wl = w.to(torch.bfloat16).to(lib_dtype) if mode != "high" else w
        if kernel == "packed_upconv":
            kw = {}
            if epi == "rgb":
                kw = {"rgb_w": torch.randn((3, c), device="cuda", generator=gen) / math.sqrt(c),
                      "rgb_b": 0.1 * torch.randn(3, device="cuda", generator=gen)}

            def call(x=x, w=w, b=b, kw=kw, mode=mode):
                return pk.packed_upconv(x, w, b, mode=mode, **kw)

            def library(xl=xl, wl=wl, bl=bl, kw=kw):
                y = lrelu_norm(F.conv2d(F.interpolate(xl, scale_factor=2.0), wl, bl, padding=1))
                if kw:
                    return y, F.conv2d(xl, kw["rgb_w"].to(xl.dtype)[:, :, None, None],
                                       kw["rgb_b"].to(xl.dtype))
                return y
            flops = 2 * 4 * c * cout * bsz * 4 * h * h
            nbytes = 4 * bsz * h * h * (c + 4 * cout + (3 if kw else 0))
        elif kernel == "packed_conv_rgb":
            rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
            rgb_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
            prev = 0.5 * torch.randn((bsz, 3, h // 2, h // 2), device="cuda", generator=gen)

            def call(x=x, w=w, b=b, rgb_w=rgb_w, rgb_b=rgb_b, prev=prev, mode=mode):
                return pk.packed_conv_rgb(x, w, b, rgb_w, rgb_b, prev, 1.0, emit_uint8=True,
                                          mode=mode)

            def library(xl=xl, wl=wl, bl=bl, rgb_w=rgb_w, rgb_b=rgb_b, prev=prev):
                feat = lrelu_norm(F.conv2d(xl, wl, bl, padding=1)).to(xl.dtype)
                rgb = F.conv2d(feat, rgb_w.to(xl.dtype)[:, :, None, None],
                               rgb_b.to(xl.dtype)).float()
                up = F.interpolate(prev, scale_factor=2.0)
                return pro_gan.to_uint8((up + (rgb - up)).permute(0, 2, 3, 1))
            flops = 2 * 9 * c * cout * bsz * h * h + 2 * cout * 3 * bsz * h * h
            nbytes = 4 * bsz * h * h * (c + 3 / 4) + bsz * h * h * 3
        else:
            fn, pool = getattr(pk, kernel), kernel == "packed_convpool"

            def call(x=x, w=w, b=b, fn=fn, epi=epi, mode=mode):
                return fn(x, w, b, epi, mode=mode)

            def library(xl=xl, wl=wl, bl=bl, epi=epi, pool=pool):
                y = F.conv2d(xl, wl, bl, padding=1)
                if epi != "none":
                    y = lrelu_norm(y) if epi == "lrelu_norm" else pro_gan.lrelu(y)
                return F.avg_pool2d(y, 2) if pool else y
            flops = 2 * 9 * c * cout * bsz * h * h
            nbytes = 4 * bsz * h * h * (c + cout // (4 if pool else 1))
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            ys = y if isinstance(y, tuple) else (y,)
            digest = hashlib.sha256()
            for t in ys:
                digest.update(t.cpu().numpy().tobytes())
            if dump is not None:
                torch.save([t.cpu() for t in ys], dump / f"narrow_{label}.pt")
            ms = cuda_ms(call, iters=10)
            lib_ms = cuda_ms(library, iters=10)
        extra = ({"alone_ms": alone_ms(pk, call)}
                 if (mode != "high" and kernel in ("packed_upconv", "packed_conv")
                     or kernel == "packed_convpool") else {})
        peak, passes = ((PEAK_FP32_FLOPS, 1) if mode == "high"
                        else (PEAK_BF16_FLOPS, 2 if mode == "mid" else 1))
        bound_ms = max(passes * flops / peak, nbytes / PEAK_HBM_BYTES) * 1e3
        out[label] = {"ms": ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                      "roofline_share": bound_ms / ms, "sha256": digest.hexdigest(), **extra}
        del x, y, ys, xl
    return out


def bench_any_width(pk, dump: Path | None) -> dict:
    """ANY_WIDTH_SHAPES at batch 2 and 8, kernel modes "high", "default" and
    "mid": ms, ``alone_ms``, the plain twin's ms (``plain_ms``), cuDNN's ms
    (``narrow``'s library calls at the true Cout; B3's ``rgb_library``), the
    bound (the FLOP and bytes of the true widths) and its share, sha256 of
    the output's bytes; the outputs saved under ``dump``."""
    import torch.nn.functional as F

    from probgan_tpu_torch.models import pro_gan

    def lrelu_norm(t):
        return pro_gan.pixel_norm(pro_gan.lrelu(t.float()))

    out = {}
    for i, (bsz, mode, (kernel, epi, c, cout, h)) in enumerate(
            (b, m, s) for b in (2, 8) for m in ("high", "default", "mid")
            for s in ANY_WIDTH_SHAPES):
        label = f"{kernel[7:]}_{epi}_C{c}_Cout{cout}_{h}_{mode}_b{bsz}"
        gen = torch.Generator(device="cuda").manual_seed(2400 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        lib_dtype = torch.bfloat16 if mode == "default" else torch.float32
        xl, bl = x.to(lib_dtype), b.to(lib_dtype)
        wl = w.to(torch.bfloat16).to(lib_dtype) if mode != "high" else w
        wbytes = 4 if mode == "high" else 2  # a weight as the kernel reads it
        if kernel == "packed_upconv":
            kw = {}
            if epi == "rgb":
                kw = {"rgb_w": torch.randn((3, c), device="cuda", generator=gen) / math.sqrt(c),
                      "rgb_b": 0.1 * torch.randn(3, device="cuda", generator=gen)}

            def call(x=x, w=w, b=b, kw=kw, mode=mode):
                return pk.packed_upconv(x, w, b, mode=mode, **kw)

            def plain(x=x, w=w, b=b, kw=kw, mode=mode):
                return pk.packed_upconv_plain(x, w, b, mode=mode, **kw)

            def library(xl=xl, wl=wl, bl=bl, kw=kw):
                y = lrelu_norm(F.conv2d(F.interpolate(xl, scale_factor=2.0), wl, bl, padding=1))
                if kw:
                    return y, F.conv2d(xl, kw["rgb_w"].to(xl.dtype)[:, :, None, None],
                                       kw["rgb_b"].to(xl.dtype))
                return y
            flops = 2 * 4 * c * cout * bsz * 4 * h * h + (2 * c * 3 * bsz * h * h if kw else 0)
            nbytes = (4 * (bsz * h * h * (c + 4 * cout + (3 if kw else 0)) + cout)
                      + wbytes * (9 if mode == "high" else 16) * c * cout)
        elif kernel == "packed_conv_rgb":
            u8 = epi == "uint8"
            alpha = 1.0 if u8 else 0.3
            rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
            rgb_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
            prev = 0.5 * torch.randn((bsz, 3, h // 2, h // 2), device="cuda", generator=gen)
            args = (x, w, b, rgb_w, rgb_b, prev, alpha)

            def call(args=args, u8=u8, mode=mode):
                return pk.packed_conv_rgb(*args, emit_uint8=u8, mode=mode)

            def plain(args=args, u8=u8, mode=mode):
                return pk.packed_conv_rgb_plain(*args, emit_uint8=u8, mode=mode)
            library = rgb_library(mode, x, w, b, rgb_w, rgb_b, prev, alpha, u8)
            flops = 2 * 9 * c * cout * bsz * h * h + 2 * cout * 3 * bsz * h * h
            nbytes = (4 * bsz * h * h * (c + 3 / 4) + bsz * h * h * 3 * (1 if u8 else 4)
                      + wbytes * 9 * c * cout + 4 * (4 * cout + 3))
        else:
            def call(x=x, w=w, b=b, mode=mode):
                return pk.packed_conv(x, w, b, "lrelu_norm", mode=mode)

            def plain(x=x, w=w, b=b, mode=mode):
                return pk.packed_conv_plain(x, w, b, "lrelu_norm", mode=mode)

            def library(xl=xl, wl=wl, bl=bl):
                return lrelu_norm(F.conv2d(xl, wl, bl, padding=1))
            flops = 2 * 9 * c * cout * bsz * h * h
            nbytes = 4 * (bsz * h * h * (c + cout) + cout) + wbytes * 9 * c * cout
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            ys = y if isinstance(y, tuple) else (y,)
            digest = hashlib.sha256()
            for t in ys:
                digest.update(t.cpu().numpy().tobytes())
            if dump is not None:
                torch.save([t.cpu() for t in ys], dump / f"any_width_{label}.pt")
            ms = cuda_ms(call, iters=10)
            extra = {"alone_ms": alone_ms(pk, call), "plain_ms": cuda_ms(plain, iters=5),
                     "library_ms": cuda_ms(library, iters=10)}
        peak, passes = ((PEAK_FP32_FLOPS, 1) if mode == "high"
                        else (PEAK_BF16_FLOPS, 2 if mode == "mid" else 1))
        bound_ms = max(passes * flops / peak, nbytes / PEAK_HBM_BYTES) * 1e3
        out[label] = {"ms": ms, "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                      "sha256": digest.hexdigest(), **extra}
        del x, y, ys, xl
    return out


def bench_convpool(pk, dump: Path | None) -> dict:
    """B5 at CONVPOOL_SHAPES, kernel modes "high", "default" and "mid": ms,
    ``alone_ms``, cuDNN's ms, the bound (the larger of the FLOP at the mode's
    peak, "mid"'s two passes, and the fp32 bytes in and out at the HBM rate)
    and its share, sha256 of the output's bytes; the outputs saved under
    ``dump``."""
    out = {}
    for i, (mode, (epi, bsz, c, cout, h)) in enumerate(
            (m, s) for m in ("high", "default", "mid") for s in CONVPOOL_SHAPES):
        label = f"convpool_{epi}_C{c}_Cout{cout}_{h}_{mode}_b{bsz}"
        gen = torch.Generator(device="cuda").manual_seed(700 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)

        def call(x=x, w=w, b=b, epi=epi, mode=mode):
            return pk.packed_convpool(x, w, b, epi, mode=mode)
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(y.cpu().numpy().tobytes())
            if dump is not None:
                torch.save([y.cpu()], dump / f"{label}.pt")
            ms = cuda_ms(call, iters=10)
        extra = alone_and_library(pk, "packed_convpool", epi, mode, call, x, w, b)

        def b2(x=x, w=w, b=b, mode=mode):
            return pk.packed_conv(x, w, b, "lrelu", mode=mode)
        with torch.no_grad():
            extra.update(b2_ms=cuda_ms(b2, iters=10), b2_alone_ms=alone_ms(pk, b2))
        flops = 2 * 9 * c * cout * bsz * h * h
        nbytes = 4 * bsz * h * h * (c + cout / 4)
        peak, passes = ((PEAK_FP32_FLOPS, 1) if mode == "high"
                        else (PEAK_BF16_FLOPS, 2 if mode == "mid" else 1))
        bound_ms = max(passes * flops / peak, nbytes / PEAK_HBM_BYTES) * 1e3
        out[label] = {"ms": ms, "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                      "sha256": digest.hexdigest(), **extra}
        del x, y
    return out


def rgb_library(mode: str, x, w, b, rgb_w, rgb_b, prev, alpha: float, u8: bool):
    """B3's function as cuDNN and torch ops: ``F.conv2d`` + LeakyReLU +
    PixelNorm, the toRGB ``F.conv2d`` of the features, the blend with the
    nearest-2x of ``prev`` (and tanh -> uint8): bf16 tensors at "default",
    the bf16-rounded weights in fp32 at "mid", fp32 at "high"."""
    import torch.nn.functional as F

    from probgan_tpu_torch.models import pro_gan

    dtype = torch.bfloat16 if mode == "default" else torch.float32
    xl, bl, rbl = x.to(dtype), b.to(dtype), rgb_b.to(dtype)
    wl, rwl = ((w, rgb_w) if mode == "high"
               else (t.to(torch.bfloat16).to(dtype) for t in (w, rgb_w)))

    def library():
        feat = pro_gan.pixel_norm(pro_gan.lrelu(F.conv2d(xl, wl, bl, padding=1).float()))
        rgb = F.conv2d(feat.to(dtype), rwl[:, :, None, None], rbl).float()
        up = F.interpolate(prev, scale_factor=2.0)
        out = (up + alpha * (rgb - up)).permute(0, 2, 3, 1)
        return pro_gan.to_uint8(out) if u8 else out.contiguous()
    return library


def bench_rgb(pk, dump: Path | None) -> dict:
    """B3 at RGB_SHAPES, kernel modes "high", "default" and "mid", uint8 and
    fp32: ms, ``alone_ms``, cuDNN's ms (``rgb_library``), the bound (the
    larger of the FLOP at the mode's peak, "mid"'s two passes, and the bytes
    in and out at the HBM rate) and its share, B2 "lrelu" at the same conv
    and mode (``b2_ms``, ``b2_alone_ms``), sha256 of the output's bytes; the
    outputs saved under ``dump``."""
    out = {}
    for i, (mode, u8, (bsz, c, cout, h)) in enumerate(
            (m, u, s) for m in ("high", "default", "mid") for u in (True, False)
            for s in RGB_SHAPES):
        label = f"rgb_{'uint8' if u8 else 'fp32'}_C{c}_Cout{cout}_{h}_{mode}_b{bsz}"
        gen = torch.Generator(device="cuda").manual_seed(800 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
        b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
        rgb_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
        prev = 0.5 * torch.randn((bsz, 3, h // 2, h // 2), device="cuda", generator=gen)
        alpha = 1.0 if u8 else 0.3

        def call(x=x, w=w, b=b, rgb_w=rgb_w, rgb_b=rgb_b, prev=prev, alpha=alpha, u8=u8,
                 mode=mode):
            return pk.packed_conv_rgb(x, w, b, rgb_w, rgb_b, prev, alpha, emit_uint8=u8,
                                      mode=mode)

        def b2(x=x, w=w, b=b, mode=mode):
            return pk.packed_conv(x, w, b, "lrelu", mode=mode)
        library = rgb_library(mode, x, w, b, rgb_w, rgb_b, prev, alpha, u8)
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(y.cpu().numpy().tobytes())
            if dump is not None:
                torch.save([y.cpu()], dump / f"{label}.pt")
            ms = cuda_ms(call, iters=10)
            extra = {"alone_ms": alone_ms(pk, call), "library_ms": cuda_ms(library, iters=10),
                     "b2_ms": cuda_ms(b2, iters=10), "b2_alone_ms": alone_ms(pk, b2)}
        flops = 2 * 9 * c * cout * bsz * h * h + 2 * cout * 3 * bsz * h * h
        nbytes = 4 * bsz * h * h * (c + 3 / 4) + bsz * h * h * 3 * (1 if u8 else 4)
        peak, passes = ((PEAK_FP32_FLOPS, 1) if mode == "high"
                        else (PEAK_BF16_FLOPS, 2 if mode == "mid" else 1))
        bound_ms = max(passes * flops / peak, nbytes / PEAK_HBM_BYTES) * 1e3
        out[label] = {"ms": ms, "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                      "sha256": digest.hexdigest(), **extra}
        del x, y
    return out


def bench_bwd(pk, dump: Path | None) -> dict:
    """Kernel mode "default" of the backward at BWD_SHAPES, batch 2: ms, the
    bound (the larger of the bf16 FLOP at the tensor cores' peak and the
    fp32 bytes in and out at the HBM rate) and its share, sha256 of the
    output's bytes, and for the weight gradient the fp32 kernel's ms beside
    it; the outputs saved under ``dump`` (the weight gradient's at both
    kernels, "default" then fp32)."""
    out = {}
    bsz = 2
    for i, (label, kernel, epi, c, cout, h) in enumerate(BWD_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(500 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        extra = {}
        if kernel == "packed_conv_wgrad":
            g = 0.01 * torch.randn((bsz, cout, h, h), device="cuda", generator=gen)

            def call(x=x, g=g):
                return pk.packed_conv_wgrad(x, g, mode="default")
            extra["fp32_ms"] = cuda_ms(lambda: pk.packed_conv_wgrad(x, g), iters=10)
            flops = 2 * 9 * c * cout * bsz * h * h
            nbytes = 4 * (bsz * h * h * (c + cout) + 9 * c * cout)
        else:
            w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
            b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            fn = getattr(pk, kernel)
            if kernel == "packed_upconv":
                def call(x=x, w=w, b=b):
                    return pk.packed_upconv(x, w, b, epilogue="lrelu", mode="default")
                flops = 2 * 4 * c * cout * bsz * 4 * h * h
                nbytes = 4 * bsz * h * h * (c + 4 * cout)
            else:
                def call(x=x, w=w, b=b, fn=fn, epi=epi):
                    return fn(x, w, b, epi, mode="default")
                flops = 2 * 9 * c * cout * bsz * h * h
                nbytes = 4 * bsz * h * h * (c + cout // (4 if kernel == "packed_convpool" else 1))
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(y.cpu().numpy().tobytes())
            if dump is not None:
                ys = [y] + ([pk.packed_conv_wgrad(x, g)] if kernel == "packed_conv_wgrad" else [])
                torch.save([t.cpu() for t in ys], dump / f"bwd_{label}.pt")
            ms = cuda_ms(call, iters=10)
        if kernel != "packed_conv_wgrad":
            extra.update(alone_and_library(pk, kernel, epi, "default", call, x, w, b))
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        out[label] = {"ms": ms, "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                      "sha256": digest.hexdigest(), **extra}
        del x, y
    return out


def bench_fused(pk, dump: Path | None) -> dict:
    """The stage-fused kernels at FUSED_SHAPES beside the pair they replace,
    at each kernel mode the tree's wrappers take ("high"; "default" and
    "mid" once they take ``mode``, labelled "<shape>_<mode>"): ms of each,
    the bound (conv1 at its 4 pre-summed taps an output, conv2 at 9, the
    toRGBs; fp32 at "high", the bf16 peak for each bf16 pass), shares, the
    kernel's time over the pair's, and at "high" the conv1 pixels a conv2
    output where the tree's tiling helper gives them; the kernel's output
    saved under ``dump``."""
    bf16 = "mode" in inspect.signature(pk.packed_upconv_conv).parameters
    out = {}
    for mode in ("high", "default", "mid") if bf16 else ("high",):
        for label, row in _bench_fused_mode(pk, dump, mode).items():
            out[label if mode == "high" else f"{label}_{mode}"] = row
    return out


def _bench_fused_mode(pk, dump: Path | None, mode: str) -> dict:
    kw = {} if mode == "high" else {"mode": mode}
    passes = {"high": 0, "default": 1, "mid": 2}[mode]
    narrow = 16 in getattr(pk, "FUSED_STAGES", {})  # the tree takes 16 and 8 channels
    out = {}
    for i, (label, kind, bsz, c, cout, h, emit) in enumerate(FUSED_SHAPES):
        if cout < 32 and not narrow:
            continue
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        x = torch.randn((bsz, c, h, h), device="cuda", generator=gen)
        w1 = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(2 / (9 * c))
        w2 = torch.randn((cout, cout, 3, 3), device="cuda", generator=gen) * math.sqrt(
            2 / (9 * cout))
        b1 = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        b2 = 0.1 * torch.randn(cout, device="cuda", generator=gen)
        pixels = bsz * 4 * h * h
        flops = 2 * 4 * c * cout * pixels + 2 * 9 * cout * cout * pixels
        if kind == "upconv_conv":
            def call(x=x, w1=w1, b1=b1, w2=w2, b2=b2):
                return pk.packed_upconv_conv(x, w1, b1, w2, b2, **kw)

            def pair(x=x, w1=w1, b1=b1, w2=w2, b2=b2):
                return pk.packed_conv(pk.packed_upconv(x, w1, b1, **kw), w2, b2, **kw)
        else:
            rgb_w = torch.randn((3, cout), device="cuda", generator=gen) / math.sqrt(cout)
            prev_w = torch.randn((3, c), device="cuda", generator=gen) / math.sqrt(c)
            rgb_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
            prev_b = 0.1 * torch.randn(3, device="cuda", generator=gen)
            u8, alpha = emit == "uint8", 1.0 if emit == "uint8" else 0.3
            flops += 2 * cout * 3 * pixels + 2 * c * 3 * pixels // 4

            def call(x=x, w1=w1, b1=b1, w2=w2, b2=b2, rgb_w=rgb_w, rgb_b=rgb_b, prev_w=prev_w,
                     prev_b=prev_b, u8=u8, alpha=alpha):
                return pk.packed_upconv_conv_rgb(x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b,
                                                 alpha, emit_uint8=u8, **kw)

            def pair(x=x, w1=w1, b1=b1, w2=w2, b2=b2, rgb_w=rgb_w, rgb_b=rgb_b, prev_w=prev_w,
                     prev_b=prev_b, u8=u8, alpha=alpha):
                f, rp = pk.packed_upconv(x, w1, b1, rgb_w=prev_w, rgb_b=prev_b, **kw)
                return pk.packed_conv_rgb(f, w2, b2, rgb_w, rgb_b, rp, alpha, emit_uint8=u8, **kw)
        with torch.no_grad():
            y = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
            if dump is not None:
                suffix = "" if mode == "high" else f"_{mode}"
                torch.save([y.cpu()], dump / f"fused_{label}{suffix}.pt")
            del y
            ms, pair_ms = cuda_ms(call, iters=10), cuda_ms(pair, iters=10)
        bound_ms = (flops / PEAK_FP32_FLOPS if mode == "high"
                    else passes * flops / PEAK_BF16_FLOPS) * 1e3
        row = {"ms": ms, "pair_ms": pair_ms, "over_pair": ms / pair_ms, "bound_ms": bound_ms,
               "roofline_share": bound_ms / ms, "pair_roofline_share": bound_ms / pair_ms,
               "sha256": digest}
        if mode == "high" and hasattr(pk, "fused_split"):  # from the tiling; not measured
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            row["conv1_per_output_tiling"] = pk.fused_conv1_per_output(bsz, cout, h, h, sms)
        out[label] = row
        del x
    return out


def stage_fused_turns(engine_mod, train, cfg, gen, rounds: int = 4) -> dict:
    """``generate`` (batch 8) at "high" and "fast" and the image trainer's
    step (stage 8, batch 2, ``packed_fake`` as the CLI passes it) with
    PROBGAN_STAGE_FUSED 1 and 0 in turns: img/s and steps/s of each (host
    clock to a result on the host); "fast" only where the tree's stage-fused
    kernels take a bf16 mode."""
    from probgan_tpu_torch.ops import packed as pk

    with_fast = "mode" in inspect.signature(pk.packed_upconv_conv).parameters
    engine = engine_mod.ImageGANEngine(cfg, device="cuda", precision="high", seed=0)
    fast = engine_mod.ImageGANEngine(cfg, g_params=engine.g_params, d_params=engine.d_params,
                                     device="cuda", precision="fast")
    z = engine.sample_latents(8)
    state = train.progan_init_state(0, cfg, device="cuda")
    real = torch.tanh(torch.randn((2, cfg.resolution, cfg.resolution, 3), device="cuda",
                                  generator=gen))
    zt = torch.randn((2, cfg.latent_dim), device="cuda", generator=gen)
    stage = cfg.num_stages - 1
    times = {flag: {"generate": [], "generate_fast": [], "step": []} for flag in ("1", "0")}
    before = os.environ.get("PROBGAN_STAGE_FUSED")
    try:
        for r in range(rounds + 1):  # round 0 warms both up
            for flag in ("1", "0") if r % 2 else ("0", "1"):
                os.environ["PROBGAN_STAGE_FUSED"] = flag
                t0 = time.perf_counter()
                if with_fast:
                    fast.generate(z)
                t_fast = time.perf_counter() - t0
                t0 = time.perf_counter()
                engine.generate(z)
                t1 = time.perf_counter()
                state, m = train.progan_train_step(state, real, zt, 1.0, cfg, stage,
                                                   packed_fake=True, packed_train_mode="highest")
                float(m["g_loss"])
                t2 = time.perf_counter()
                if r and with_fast:
                    times[flag]["generate_fast"].append(t_fast)
                    times[flag]["generate"].append(t1 - t0)
                    times[flag]["step"].append(t2 - t1)
    finally:
        if before is None:
            os.environ.pop("PROBGAN_STAGE_FUSED", None)
        else:
            os.environ["PROBGAN_STAGE_FUSED"] = before
    return {("stage_fused" if flag == "1" else "two_kernel"): {
        "generate_img_per_s": 8 * len(t["generate"]) / sum(t["generate"]),
        "generate_fast_img_per_s": (8 * len(t["generate_fast"]) / sum(t["generate_fast"])
                                    if with_fast else None),
        "train_steps_per_s": len(t["step"]) / sum(t["step"]),
        "generate_call_s": t["generate"], "train_step_s": t["step"]}
        for flag, t in times.items()}


def differing(ta: torch.Tensor, tb: torch.Tensor) -> int:
    """Values of ``ta`` whose bits differ from ``tb``'s (all of them when the
    shapes or types differ)."""
    if ta.shape != tb.shape or ta.dtype != tb.dtype:
        return ta.numel()
    if ta.dtype == torch.float32:
        ta, tb = ta.view(torch.int32), tb.view(torch.int32)
    return int((ta != tb).sum())


def compare(dir_a: Path, dir_b: Path) -> dict:
    """{file: values whose bits differ} over the .pt files of ``dir_a``."""
    diffs = {}
    for f in sorted(dir_a.glob("*.pt")):
        a, b = torch.load(f), torch.load(dir_b / f.name)
        diffs[f.stem] = sum(differing(ta, tb) for ta, tb in zip(a, b))
    return diffs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6, help="timed train steps (after 2 warm-up)")
    ap.add_argument("--parts", default=",".join(PARTS), help=f"comma list of {PARTS}")
    ap.add_argument("--dump", type=Path, help="save the fp32 kernels' outputs here")
    ap.add_argument("--compare", type=Path, nargs=2, metavar=("A", "B"),
                    help="count differing values between two --dump directories")
    ap.add_argument("--precision", default="high", choices=["default", "fast", "high", "highest"],
                    help="the grade of the generate part ('default' is the grade None)")
    args = ap.parse_args(argv)
    if args.compare:
        diffs = compare(*args.compare)
        print(json.dumps({"differing_values": diffs, "files": len(diffs)}))
        return 0 if diffs and not any(diffs.values()) else 1
    if not torch.cuda.is_available():
        print("bench_kernels: no CUDA card")
        return 1
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        ap.error(f"--parts takes {PARTS}")
    from probgan_tpu_torch.engine import train
    from probgan_tpu_torch.engine.image import ImageGANEngine
    from probgan_tpu_torch.models.pro_gan import ProGANConfig
    from probgan_tpu_torch.ops import packed as pk
    from probgan_tpu_torch.ops import rank as rank_ops
    from probgan_tpu_torch.ops import rank_fused as rf

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {"card": card, "package": pk.__file__}
    if args.dump is not None:
        args.dump.mkdir(parents=True, exist_ok=True)

    if "rank" in parts:
        out["rank_scores_ms"], out["rank_topk_ms"] = {}, {}
        n = 1_000_000
        table = rank_ops.l2_normalize(torch.randn((n, 128), device="cuda", generator=gen))
        for b in (64, 8):
            pred = torch.randn((b, 128), device="cuda", generator=gen)
            if args.dump is not None:
                torch.save([rf.rank_scores_fused(pred, table).cpu()],
                           args.dump / f"rank_scores_B{b}.pt")
            out["rank_scores_ms"][f"B{b}"] = cuda_ms(lambda: rf.rank_scores_fused(pred, table))
            out["rank_topk_ms"][f"B{b}"] = cuda_ms(
                lambda: rf.rank_topk_fused(pred, table, 10, n))
        del table

    if "none" in parts:
        out["none_ms"] = {}
        with torch.no_grad():
            for c, cout, h in CONV_SHAPES:
                x = torch.randn((2, c, h, h), device="cuda", generator=gen)
                w = torch.randn((cout, c, 3, 3), device="cuda", generator=gen) * math.sqrt(
                    2 / (9 * c))
                b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
                if args.dump is not None:
                    torch.save([pk.packed_conv(x, w, b, epilogue="none").cpu()],
                               args.dump / f"none_C{c}_Cout{cout}_{h}.pt")
                out["none_ms"][f"C{c}->Cout{cout}@{h}"] = cuda_ms(
                    lambda: pk.packed_conv(x, w, b, epilogue="none"), iters=10)
                del x

    if "fp32" in parts:
        out["fp32"] = bench_fp32(pk, args.dump)

    if "bf16" in parts:
        out["bf16"] = bench_bf16(pk, args.dump)

    if "mid" in parts:
        out["mid"] = bench_mid(pk, args.dump)

    if "bwd" in parts:
        out["bwd"] = bench_bwd(pk, args.dump)

    if "narrow" in parts:
        out["narrow"] = bench_narrow(pk, args.dump)

    if "convpool" in parts:
        out["convpool"] = bench_convpool(pk, args.dump)

    if "rgb" in parts:
        out["rgb"] = bench_rgb(pk, args.dump)

    if "any_width" in parts:
        out["any_width"] = bench_any_width(pk, args.dump)

    if "fused" in parts:
        from probgan_tpu_torch.engine import image as engine_mod

        out["fused"] = bench_fused(pk, args.dump)
        out["fused_turns"] = stage_fused_turns(engine_mod, train, ProGANConfig(), gen)

    if "generate" in parts:
        precision = None if args.precision == "default" else args.precision
        engine = ImageGANEngine(ProGANConfig(), device="cuda", precision=precision, seed=0)
        images = engine.generate(engine.sample_latents(8))  # warm-up (cuDNN plans)
        if args.dump is not None:
            torch.save([torch.from_numpy(images)], args.dump / "generate_b8.pt")
        latents = [engine.sample_latents(8) for _ in range(8)]
        torch.cuda.synchronize()
        times = []
        for z in latents:
            t0 = time.perf_counter()
            engine.generate(z)  # returns host numpy: the call has finished
            times.append(time.perf_counter() - t0)
        out["generate_precision"] = args.precision
        out["generate_img_per_s"] = 8 * len(times) / sum(times)
        out["generate_p50_ms_per_img"] = float(np.median(times)) * 1e3 / 8
        out["generate_call_s"] = times
        del engine

    if "train" in parts:
        cfg = ProGANConfig()
        state = train.progan_init_state(0, cfg, device="cuda")
        real = torch.tanh(torch.randn((2, cfg.resolution, cfg.resolution, 3), device="cuda",
                                      generator=gen))
        z = torch.randn((2, cfg.latent_dim), device="cuda", generator=gen)
        times = []
        for i in range(2 + args.steps):
            t0 = time.perf_counter()
            state, m = train.progan_train_step(state, real, z, 1.0, cfg, cfg.num_stages - 1,
                                               packed_d=True, packed_g=True, remat=True,
                                               packed_train_mode="highest")
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
