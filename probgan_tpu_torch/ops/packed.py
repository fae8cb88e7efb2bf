"""The late-stage conv kernels of the image G and D: Python side.

Seven kernels carry stages 7-8 of the 1024² generator and the first two
blocks of its discriminator, forward and backward, each written by hand in
CUDA C++ for Hopper (``csrc/*.cu``) and keeping the JAX names of the Pallas
kernels they replace (``probgan_tpu/ops/pallas_packed.py``):

- ``packed_upconv``:   nearest-2x upsample -> conv3x3 + bias -> LeakyReLU ->
  PixelNorm (``"lrelu_norm"``) or LeakyReLU alone (``"lrelu"``, the pre-norm
  tensor the backward recomputes), optionally with the toRGB of its input;
- ``packed_conv``:     conv3x3 + bias -> epilogue: ``"lrelu_norm"``
  (LeakyReLU -> PixelNorm, the generator), ``"lrelu"`` (the discriminator's
  conv1) or ``"none"`` (the training backward's input gradients and
  pre-activation recompute), this one 3xTF32 on the tensor cores (fp32 by
  accuracy) and the other two fp32 FMAs;
- ``packed_conv_rgb``: conv3x3 + bias -> LeakyReLU -> PixelNorm -> toRGB ->
  alpha blend with the upsampled previous RGB -> (tanh -> uint8), NHWC out;
- ``packed_convpool``: conv3x3 + bias -> LeakyReLU (``"lrelu"``, the
  discriminator's conv2) or nothing (``"none"``) -> 2x2 mean pool; only the
  pooled tensor is written;
- ``packed_conv_wgrad``: the weight gradient of a conv3x3 from its input and
  the cotangent of its pre-bias output, 3xTF32 on the tensor cores (fp32 by
  accuracy), or one bf16 pass at kernel mode "default";
- ``packed_upconv_conv``: ``packed_upconv`` then ``packed_conv`` in one
  kernel, a whole non-final generator stage whose conv1 map never reaches
  device memory (opt-in, ``PROBGAN_STAGE_FUSED=1``);
- ``packed_upconv_conv_rgb``: ``packed_upconv`` with the toRGB of its input
  then ``packed_conv_rgb`` in one kernel, the whole final stage (opt-in).

The two stage-fused kernels give the bits of the pair they replace, at
each kernel mode: their plain twins are the pairs' twins composed.

Kernel modes (``mode``, the JAX kernels' name): "high" and "highest" run the
fp32 kernels above, with one set of bits. ``packed_upconv``,
``packed_conv``, ``packed_conv_rgb``, ``packed_convpool`` and the two
stage-fused kernels also take, with every epilogue, "default", the JAX
kernels' one bf16 pass (the train step's
default grade and G's at "fast"): both operands of every dot rounded to bf16
(to nearest even), the products summed in fp32, bias and epilogues in fp32;
and "mid", the 2-term split of the "fast" discriminator and of the train
step at ``packed_train_mode="mid"``: the weights rounded to bf16, the
activations split as ``bf16(x) + bf16(x - bf16(x))`` (``split2``), so that a
dot is the rounded weights times x to ~2^-16, summed in fp32. On the card
each bf16 mode is a kernel of its own (``csrc/*_bf16.cu``: ``packed_upconv``
and ``packed_conv`` over the pipelined ring of ``csrc/bf16_ring.cuh``, the
others over ``csrc/bf16_conv.cuh``, and for the stage-fused pair
``csrc/fused_bf16.cuh``;
bf16 tensor-core products, the two terms two products at "mid"); the twins
round or split the same operands and run fp32 convs. ``packed_conv_wgrad``
takes "default" (``csrc/packed_conv_wgrad_bf16.cu``, both operands rounded)
and "mid" as the reference does, at fp32 ("highest").
"exact6" and "emulate_bf16" are the TPU kernels' test aids and raise
ValueError.

The six forward kernels record no autograd graph. On the CPU their plain
twins are ordinary differentiable torch code; on a CUDA tensor a wrapper
raises when a gradient is wanted (grad mode on and an argument that
``requires_grad``) instead of returning a tensor whose gradient would
silently be zero. The differentiable forms are the ``torch.autograd.Function``s
of ``ops/packed_vjp.py``, whose backward runs on these same kernels.

The TPU kernels' phase-blocked layout, revolving DMAs and bf16 K-stacking are
not ported: these take plain dense NCHW fp32 tensors and OIHW weights with the
equalized-LR scale already applied.

Channel counts on the card, at every mode: the serving path's PixelNorm
kernels, ``packed_upconv`` "lrelu_norm" (with or without toRGB),
``packed_conv`` "lrelu_norm" and ``packed_conv_rgb`` (fp32 RGB and uint8),
take any Cout from 1 to 64 and any C >= 1: every output channel in one
block, on the tile of the least of 8, 16, 32 and 64 at or above Cout
(``norm_tile``), the weights, bias and toRGB weights zero-padded to it by
the wrapper (no activation is padded), so that generators whose last stages
are 4 or 2 channels wide (fmap_base 1024 or 512 at 1024²) or no power of two
(fmap_base 3072: 48, 24, 12) serve on the card. The training backward's
kernels take those generators' widths too, so that the packed train step
trains them: ``packed_upconv`` "lrelu" any Cout from 1 to 64 on
``norm_tile(Cout)``'s tile ("lrelu_norm"'s, so the recompute's
pre-activations are the forward's bits); ``packed_conv`` "lrelu" and "none"
and ``packed_convpool`` any Cout >= 1, in slabs of 64, 32, 16 or 8 (the
largest that divides Cout rounded up to a multiple of 8, the weights and
bias zero-padded to it, only the true Cout stored); ``packed_conv_wgrad``
any Cout >= 1; all of these any C >= 1. No activation is padded: x, the
cotangents and the outputs keep their true channel counts. The narrow
slabs (16 and 8) are a narrow generator's late stages, forward and
backward, e.g. fmap_base 2048 at 1024². Still to come (ROADMAP.md,
B.a.2.4): the stage-fused kernels at any width (they take Cout 8, 16, 32
or 64 and C % 8 == 0) and PixelNorm above 64 channels; the wrappers raise
ValueError before any launch there.

Each kernel has a wrapper (checks device, dtype, shape and contiguity,
allocates outputs with ``torch.empty`` and launches on the current stream), a
plain PyTorch twin of the same function (``*_plain``), and a launch count in
``launches``. A wrapper takes its twin only for CPU tensors; for a CUDA tensor
it launches the kernel or raises, and for any other device it raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from probgan_tpu_torch.models.pro_gan import (
    TRAIN_MODES,
    lrelu,
    pixel_norm,
    to_uint8,
    upsample_nearest_2x,
)
from probgan_tpu_torch.ops import _build
from probgan_tpu_torch.ops.fused_upconv import parity_conv, parity_weights, upsample2x_conv3x3

# Launches of each kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else.
# The bf16 modes count apart: "<kernel>_bf16" at "default", "<kernel>_mid" at
# "mid" (one library, csrc/<kernel>_bf16.cu, serves both).
launches = {"packed_upconv": 0, "packed_conv": 0, "packed_conv_rgb": 0,
            "packed_convpool": 0, "packed_conv_wgrad": 0, "packed_upconv_conv": 0,
            "packed_upconv_conv_rgb": 0, "packed_upconv_bf16": 0, "packed_conv_bf16": 0,
            "packed_conv_rgb_bf16": 0, "packed_upconv_mid": 0, "packed_conv_mid": 0,
            "packed_conv_rgb_mid": 0, "packed_convpool_mid": 0, "packed_convpool_bf16": 0,
            "packed_conv_wgrad_bf16": 0, "packed_upconv_conv_bf16": 0,
            "packed_upconv_conv_mid": 0, "packed_upconv_conv_rgb_bf16": 0,
            "packed_upconv_conv_rgb_mid": 0}
# The launches at a narrow slab, "<counter>[cout<slab>]" (slab 16 or 8, the
# instantiations of csrc/conv_tile.cuh Tile and bf16_conv.cuh BfTile below
# 32 channels), and at a Cout that is no tile's width (2, 4, 12, 24, 48, ...,
# run on the tile above it: "<counter>[cout<Cout>]"; for the sliced kernels
# and packed_conv_wgrad, a Cout that is no multiple of 8), filled as they
# happen.
narrow_launches: dict[str, int] = {}
# The same launches by epilogue, "<kernel>[<epilogue>]", for the kernels that
# have more than one.
epilogue_launches = {
    f"{kernel}{suffix}[{epilogue}]": 0
    for kernel, epilogues in (("packed_upconv", ("lrelu_norm", "lrelu")),
                              ("packed_conv", ("lrelu_norm", "lrelu", "none")),
                              ("packed_convpool", ("lrelu", "none")))
    for suffix in ("", "_bf16", "_mid") for epilogue in epilogues
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "packed_upconv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_conv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_conv_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_convpool": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_conv_rgb": [_P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _I,
                        _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_upconv_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_upconv_conv_rgb": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_upconv_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    "packed_conv_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_conv_rgb_bf16": [_P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_convpool_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_conv_wgrad_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_upconv_conv_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "packed_upconv_conv_rgb_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _I,
                                    _P, _I, _I, _I, _I, _I, _I, _I, _P],
}
# Kernel modes (TRAIN_MODES): the fp32 kernels serve "high" and "highest";
# "default" (one bf16 pass) and "mid" (the 2-term split) the *_bf16 kernels,
# with this many bf16 terms of the activations.
BF16_TERMS = {"default": 1, "mid": 2}
# The bf16 kernels (csrc/bf16_conv.cuh): input channels a shared-memory chunk,
# and bf16 a staged pixel or weight row (the chunk's channels, then 8 zeros).
BF16_CK, BF16_ROW = 32, 40
# The pipelined bf16 ring of packed_conv (and of packed_convpool and
# packed_conv_rgb, which keep its stages and bytes) and packed_upconv
# (csrc/bf16_ring.cuh): stages, and floats a row of a stage's fp32 patch, of
# each.
BF16_RING_STAGES = {"packed_conv": 2, "packed_convpool": 2, "packed_conv_rgb": 2,
                    "packed_upconv": 3}
BF16_RING_ROW = {"packed_conv": 40, "packed_upconv": 24}
# Output channel counts the kernels are instantiated for (csrc/conv_tile.cuh
# Tile, csrc/bf16_conv.cuh BfTile). PixelNorm needs every channel in one
# block, so "lrelu_norm" and packed_conv_rgb take only these; without it
# packed_conv and packed_convpool tile Cout in slabs of 64, 32, 16 or 8 (the
# largest that divides it) and take any multiple of 8, at every epilogue; the
# stage-fused kernels take these too.
SUPPORTED_COUT = (8, 16, 32, 64)
# The serving path's PixelNorm kernels (B1 "lrelu_norm", B2 "lrelu_norm", B3)
# take any Cout up to the widest tile, on the tile just above it
# (``norm_tile``), and any C >= 1.
ANY_WIDTH_MAX = SUPPORTED_COUT[-1]
NARROW_TODO = "not ported yet (ROADMAP.md, B.a.2.4)"
# packed_conv's epilogues, by their code in csrc/packed_conv.cu.
CONV_EPILOGUES = {"lrelu_norm": 0, "lrelu": 1, "none": 2}
UPCONV_EPILOGUES = {"lrelu_norm": 0, "lrelu": 1}
POOL_EPILOGUES = ("lrelu", "none")
# packed_conv_wgrad splits the pixels over about this many blocks of its
# 64-channel tiling in all: one for each of an H100's 132 multiprocessors (the
# 32-channel tiling fits two an SM, so twice as many). A constant, not the
# card's own count, so that the sums' order, and with it dW's bits, is the
# same anywhere.
WGRAD_BLOCKS = 132
# The pipelined fp32 main loop of packed_conv's "lrelu"/"lrelu_norm", of
# packed_conv_rgb, packed_convpool and packed_upconv (csrc/conv_ring.cuh):
# input channels a ring stage (``ring_cc``: RING_CC at 32 and 64 output
# channels, 8 below), stages, and the persistent blocks an SM of the wide
# rings (the narrow ones fit two: ``ring_blocks_per_sm``).
RING_CC, RING_STAGES, RING_BLOCKS_PER_SM = 16, 3, 1
# A block's share of an H100 multiprocessor's shared memory, and what the
# card reserves for each resident block.
SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED = 232_448, 233_472, 1_024
# The stage-fused kernels' ring (csrc/fused_ring.cuh): input channels a conv1
# step, conv2 input channels a conv2 step (Cout itself below it:
# ``fused_c2``), and stages by Cout.
FUSED_C1, FUSED_C2, FUSED_STAGES = 8, 16, {64: 3, 32: 4, 16: 4, 8: 4}


def check_mode(name: str, mode: str) -> int:
    """The bf16 terms of ``mode`` (``BF16_TERMS``: 1 at "default", 2 at
    "mid"), 0 for an fp32 mode; raise ValueError for a mode the port does not
    have: "exact6" and "emulate_bf16" are the TPU kernels' test aids."""
    if mode in TRAIN_MODES:
        return BF16_TERMS.get(mode, 0)
    if mode in ("exact6", "emulate_bf16"):
        raise ValueError(f"{name}: mode {mode!r} is a test aid of the TPU kernels, not a "
                         f"mode of the port's; use one of {TRAIN_MODES}")
    raise ValueError(f"{name}: mode {mode!r} not in {TRAIN_MODES}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even), back in fp32: the operand
    rounding of kernel mode "default", and of the weights at "mid"."""
    return t.to(torch.bfloat16).float()


def split2(t: torch.Tensor) -> torch.Tensor:
    """``t`` as kernel mode "mid" sees an activation: ``bf16(t) + bf16(t -
    bf16(t))``, the sum exact in fp32 (``t`` to ~2^-16 relative)."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _operand(t: torch.Tensor, terms: int) -> torch.Tensor:
    """An activation as a mode with ``terms`` bf16 terms sees it."""
    return _bf16(t) if terms == 1 else split2(t)


def reset_launches() -> None:
    for counts in (launches, epilogue_launches):
        for name in counts:
            counts[name] = 0
    narrow_launches.clear()


def _launch(name: str, x: torch.Tensor, *args, epilogue: str | None = None,
            counter: str | None = None, slab: int | None = None) -> None:
    """Launch kernel ``name``; count it under ``counter`` (default ``name``),
    with ``epilogue`` under "<counter>[<epilogue>]" too, and at a ``slab``
    below 32 channels, or a Cout that is no tile's width, under
    "<counter>[cout<slab>]" in ``narrow_launches``."""
    _build.launch(name, _ARGTYPES[name], x.device, *args)
    counter = counter or name
    launches[counter] += 1
    if epilogue is not None:
        epilogue_launches[f"{counter}[{epilogue}]"] += 1
    if slab is not None and (slab < 32 or slab not in SUPPORTED_COUT):
        key = f"{counter}[cout{slab}]"
        narrow_launches[key] = narrow_launches.get(key, 0) + 1


def _bf16_launch(name: str, terms: int, x: torch.Tensor, *args,
                 epilogue: str | None = None, slab: int | None = None) -> None:
    """Launch the bf16 kernel of ``name`` (csrc/<name>_bf16.cu) with ``terms``
    bf16 terms: counted as "<name>_bf16" at "default", as "<name>_mid" at
    "mid", and by ``epilogue`` and ``slab`` too."""
    by_slab = {} if slab is None else {"slab": slab}
    _launch(f"{name}_bf16", x, *args, epilogue=epilogue,
            counter=f"{name}_bf16" if terms == 1 else f"{name}_mid", **by_slab)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _refuse_grad(name: str, instead: str, *tensors: torch.Tensor | None) -> None:
    """Raise when autograd would record through a kernel launch: the output
    of a launch has no ``grad_fn``, so a loss built on it would have zero
    gradients without any error."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: this kernel is forward-only and records no autograd "
            f"graph, but an argument requires grad; use ops.packed_vjp.{instead} "
            "(or call it under torch.no_grad())"
        )


def _check(name: str, x: torch.Tensor, cin: int, h_mult: int,
           w_mult: int, c8: bool = False, **params: torch.Tensor | None) -> None:
    """Raise unless ``x`` is a contiguous fp32 NCHW CUDA tensor the kernel
    takes (any C >= 1; with ``c8``, the stage-fused kernels', C a multiple
    of 8) and every parameter lies on its device in fp32."""
    if x.device.type != "cuda":
        raise RuntimeError(
            f"{name}: tensors on {x.device.type!r} are not supported; the "
            "kernel runs on CUDA and its plain twin on the CPU"
        )
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(
            f"{name}: x must be a contiguous float32 NCHW tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    _, c, h, w = x.shape
    if c != cin or c < 1 or (c % 8 and c8) or h % h_mult or w % w_mult:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} needs C == {cin}"
            + (f" and a multiple of 8 (another C is {NARROW_TODO})" if c8 else "")
            + f", H % {h_mult} == 0, W % {w_mult} == 0"
        )
    for pname, p in params.items():
        if p is not None and (p.device != x.device or p.dtype != torch.float32):
            raise ValueError(f"{name}: {pname} must be float32 on {x.device}")


def _tile_rows(cout: int) -> int:
    """Output rows of one kernel block at a slab of ``cout`` channels
    (csrc/conv_tile.cuh Tile::TH, csrc/bf16_conv.cuh BfTile::TH): 8 at 64,
    16 at 32, 16 and 8."""
    return 8 if cout == 64 else 16


def _check_cout(name: str, cout: int, sliced: bool = False,
                supported: tuple[int, ...] = SUPPORTED_COUT, any_width: bool = False) -> None:
    """``any_width``: a kernel that holds every output channel in one block
    (``packed_upconv``, the PixelNorm epilogues), any Cout from 1 to
    ANY_WIDTH_MAX; ``sliced``: the kernel tiles Cout in slabs and takes any
    Cout >= 1; else Cout is one of ``supported``. What is refused names the
    ROADMAP.md item that would port it."""
    if any_width:
        if not 0 < cout <= ANY_WIDTH_MAX:
            raise ValueError(f"{name}: Cout={cout} not in 1..{ANY_WIDTH_MAX}; PixelNorm above "
                             f"{ANY_WIDTH_MAX} channels is {NARROW_TODO}")
        return
    if sliced:
        if cout < 1:
            raise ValueError(f"{name}: Cout={cout} must be at least 1")
        return
    if 0 < cout < 8:
        raise ValueError(f"{name}: Cout={cout} below 8 is {NARROW_TODO}")
    if cout not in supported:
        raise ValueError(f"{name}: Cout={cout} not in {supported}; Cout {cout} here is "
                         f"{NARROW_TODO}")


def sliced_cout(cout: int) -> int:
    """The Cout a sliced kernel (``packed_conv`` "lrelu"/"none",
    ``packed_convpool``) walks: ``cout`` rounded up to a multiple of 8, in
    slabs of ``_pool_slab`` of it; the wrapper zero-pads the weights and bias
    to it and the kernel stores only the true Cout."""
    return -(-cout // 8) * 8


def norm_tile(cout: int) -> int:
    """The output channels of the tile a serving PixelNorm kernel runs Cout
    ``cout`` (1 to ANY_WIDTH_MAX) on: the least of SUPPORTED_COUT at or above
    it (1-8 on 8, 9-16 on 16, 17-32 on 32, 33-64 on 64)."""
    return next(t for t in SUPPORTED_COUT if t >= cout)


def pad_cout(t: torch.Tensor, tile: int, dim: int = 0) -> torch.Tensor:
    """``t`` with zeros past its channels (dimension ``dim``) up to ``tile``:
    the weights, bias or toRGB weights of a Cout that is no tile's width
    (the padded channels' sums are 0, add 0 to PixelNorm's sum of squares and
    to toRGB's dot, and are not stored), or the bf16 B1's toRGB weights in
    rows of C rounded up to 4. ``t`` itself where it has that size already."""
    pad = tile - t.shape[dim]
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def check_stage_widths(name: str, x: torch.Tensor, widths) -> None:
    """Raise ValueError before any launch where a generator stage of (C,
    Cout) in ``widths`` would reach, on the card, a stage-fused kernel that
    does not take it yet: they take Cout 8, 16, 32 or 64 and C % 8 == 0
    (ROADMAP.md, B.a.2.4). Nothing on the CPU, where the twins take every
    width."""
    if x.device.type == "cpu":
        return
    for c, cout in widths:
        if cout not in SUPPORTED_COUT or c % 8:
            raise ValueError(f"{name}: a stage of {c} -> {cout} channels on the card is "
                             f"{NARROW_TODO}")


def _lrelu_norm(x: torch.Tensor) -> torch.Tensor:
    return pixel_norm(lrelu(x))


def bf16_chunks(c: int) -> int:
    """Shared-memory chunks of ``c`` input channels in the bf16 kernels
    (csrc/bf16_conv.cuh bf16_chunks): c / 32, and one more, partial, where
    c % 32 != 0."""
    return -(-c // BF16_CK)


def _pad_channels(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w`` with zeros past its input channels (dimension ``dim``) up to
    whole chunks of BF16_CK: the partial chunk's weights."""
    pad = bf16_chunks(w.shape[dim]) * BF16_CK - w.shape[dim]
    if not pad:
        return w
    shape = list(w.shape)
    shape[dim] = pad
    return torch.cat([w, w.new_zeros(shape)], dim=dim)


def conv_bf16_weights(w: torch.Tensor, slab: int | None = None) -> torch.Tensor:
    """OIHW [Cout, C, 3, 3] -> the bf16 kernels' [ceil(C/32)][9 taps][Cout]
    [40] bf16 (csrc/packed_conv_bf16.cu): rounded to bf16, tap ky * 3 + kx,
    each run of 32 input channels followed by 8 zeros, and zeros past C in
    the last run. With ``slab`` (the kernels' ``_pool_slab(Cout)``):
    [Cout/slab][ceil(C/32)][9][slab][40], one slab's after the other."""
    if slab is not None:
        return torch.stack([conv_bf16_weights(ws) for ws in w.split(slab)])
    w = _pad_channels(w, 1)
    cout, c = w.shape[:2]
    wt = w.permute(2, 3, 0, 1).reshape(9, cout, c // BF16_CK, BF16_CK).permute(2, 0, 1, 3)
    out = torch.zeros((c // BF16_CK, 9, cout, BF16_ROW), dtype=torch.bfloat16, device=w.device)
    out[..., :BF16_CK] = wt
    return out


def upconv_bf16_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, C, 3, 3] -> packed_upconv_bf16's [2 py][ceil(C/32)][2 px]
    [4 taps (dy, dx)][Cout][40] bf16: the pre-summed parity taps of
    ``parity_weights`` (summed in fp32, then rounded to bf16), each run of 32
    input channels followed by 8 zeros, and zeros past C in the last run."""
    cout = w.shape[0]
    # [py, px, dy, dx, Cout, C], C padded to whole chunks
    wp = _pad_channels(parity_weights(w), 3).permute(0, 1, 4, 5, 2, 3)
    c = wp.shape[-1]
    wp = wp.reshape(2, 2, 4, cout, c // BF16_CK, BF16_CK).permute(0, 4, 1, 2, 3, 5)
    out = torch.zeros((2, c // BF16_CK, 2, 4, cout, BF16_ROW), dtype=torch.bfloat16,
                      device=w.device)
    out[..., :BF16_CK] = wp
    return out


def _bf16_ring_bytes(name: str, rows: int, taps: int) -> int:
    stage = BF16_CK * (rows * BF16_RING_ROW[name] + 4) + taps * BF16_ROW // 2
    return 4 * BF16_RING_STAGES[name] * stage


def bf16_ring_bytes(cout: int) -> int:
    """Dynamic shared memory of a packed_conv_bf16, a packed_convpool_bf16
    and a packed_conv_rgb_bf16 block (csrc/bf16_ring.cuh
    ConvBf16Ring::kBytes, which ConvPoolBf16Ring and ConvRgbBf16Ring keep) at
    a slab of ``_pool_slab(cout)`` channels (B3: all Cout), the same at both term
    counts: 2 stages of one 32-channel chunk, each its fp32 halo patch (tile
    rows + 2 rows of 40 floats, 4 more a channel) and its 9 x slab x 40 bf16
    weights."""
    slab = _pool_slab(cout)
    return _bf16_ring_bytes("packed_conv", _tile_rows(slab) + 2, 9 * slab)


def bf16_upconv_ring_bytes(cout: int) -> int:
    """Dynamic shared memory of a packed_upconv_bf16 block (csrc/bf16_ring.cuh
    UpconvBf16Ring::kBytes), the same at both term counts: 3 stages of one
    32-channel chunk, each its fp32 patch (tile rows + 1 rows of 24 floats, 4
    more a channel) and one parity's 2 x 4 x Cout x 40 bf16 taps."""
    return _bf16_ring_bytes("packed_upconv", _tile_rows(cout) + 1, 8 * cout)


def bf16_ring_geometry(name: str, cout: int, terms: int) -> tuple[int, int, int]:
    """(stages, bytes a block, resident blocks an SM) of the bf16 ring of
    ``name`` ("packed_conv" and "packed_convpool" at a slab of ``cout``
    channels, "packed_conv_rgb" and "packed_upconv" at Cout ``cout``) as the
    card's library was compiled: the C entry probgan_<name>_bf16_geometry of
    csrc/<name>_bf16.cu. Builds the library if needed; on the card only."""
    lib = _build.load(f"{name}_bf16")
    fn = getattr(lib, f"probgan_{name}_bf16_geometry")
    fn.argtypes, fn.restype = [_I, _I, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    out = (ctypes.c_int * 3)()
    err = fn(cout, terms, out)
    if err:
        raise RuntimeError(f"{name}_bf16 geometry: CUDA error {err}")
    return tuple(out)


def _check_fused_bf16_channels(name: str, x: torch.Tensor, mode: str) -> None:
    """The stage-fused bf16 kernels (csrc/fused_bf16.cuh) take C % 8 == 0: a
    last chunk of C % 32 channels is staged with zeros past C."""
    if x.shape[1] % 8:
        raise ValueError(f"{name}: mode {mode!r} takes C % 8 == 0, got x {tuple(x.shape)}")


def upconv_kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, C, 3, 3] -> packed_upconv's wk [2 py][C][2 px][2 dy]
    [2 dx][Cout]: each output parity's pre-summed 2x2 taps, one input
    channel's slab contiguous per row parity."""
    return parity_weights(w).permute(0, 3, 1, 4, 5, 2).contiguous()


def conv_kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, C, 3, 3] -> packed_conv's [C][3 ky][3 kx][Cout]."""
    return w.permute(1, 2, 3, 0).contiguous()


# ---------------------------------------------------------------------------
# packed_upconv
# ---------------------------------------------------------------------------

def _check_upconv_epilogue(epilogue: str, rgb_w) -> None:
    if epilogue not in UPCONV_EPILOGUES:
        raise ValueError(
            f"packed_upconv: epilogue {epilogue!r} not in {tuple(UPCONV_EPILOGUES)}")
    if epilogue != "lrelu_norm" and rgb_w is not None:
        raise ValueError('packed_upconv: rgb_w goes with epilogue "lrelu_norm" only')


def packed_upconv_plain(x, w, b, *, rgb_w=None, rgb_b=None, epilogue="lrelu_norm",
                        mode="high"):
    """Plain twin of ``packed_upconv``: the four parity convs of
    ops/fused_upconv.py + LeakyReLU (+ PixelNorm); toRGB of ``x`` as a 1x1
    conv. Modes "default" and "mid" round the pre-summed parity taps and
    ``rgb_w`` to bf16 first, and x ("default") or split it (``split2``,
    "mid")."""
    _check_upconv_epilogue(epilogue, rgb_w)
    terms = check_mode("packed_upconv", mode)
    if terms:
        x = _operand(x, terms)
        y = _epilogue(parity_conv(_bf16(parity_weights(w)), b, x), epilogue)
        rgb_w = None if rgb_w is None else _bf16(rgb_w)
    else:
        y = _epilogue(upsample2x_conv3x3(w, b, x), epilogue)
    if rgb_w is None:
        return y
    return y, F.conv2d(x, rgb_w[:, :, None, None]) + rgb_b[:, None, None]


def packed_upconv(x, w, b, *, rgb_w=None, rgb_b=None, epilogue="lrelu_norm", mode="high"):
    """Nearest-2x upsample -> conv3x3 + bias -> LeakyReLU -> PixelNorm
    ("lrelu_norm"), or without the PixelNorm ("lrelu").

    x [B, C, H, W] fp32, w [Cout, C, 3, 3] eq-LR scaled, b [Cout]
    -> [B, Cout, 2H, 2W]. With ``rgb_w`` [3, C] and ``rgb_b`` [3]
    ("lrelu_norm" only), also returns toRGB(x) [B, 3, H, W] (the ``rgb_prev``
    of packed_conv_rgb). On CUDA, both epilogues take any Cout from 1 to 64
    and any C >= 1 (on ``norm_tile(Cout)``'s tile, the taps and bias
    zero-padded to it), so "lrelu", the backward's recompute, sums each
    value as "lrelu_norm" does.
    ``mode``: "high"/"highest" (fp32), "default" (one bf16 pass) or "mid"
    (the 2-term split); both bf16 modes are ``packed_upconv_bf16`` on the
    card."""
    if x.device.type == "cpu":
        return packed_upconv_plain(x, w, b, rgb_w=rgb_w, rgb_b=rgb_b, epilogue=epilogue,
                                   mode=mode)
    name = "packed_upconv"
    _check_upconv_epilogue(epilogue, rgb_w)
    terms = check_mode(name, mode)
    _refuse_grad(name, "upconv_lrelu_norm", x, w, b, rgb_w, rgb_b)
    cout = w.shape[0]
    _check_cout(name, cout, any_width=True)
    if (rgb_w is None) != (rgb_b is None):
        raise ValueError(f"{name}: rgb_w and rgb_b go together")
    tile = norm_tile(cout)  # Cout itself at 8, 16, 32 and 64
    _check(name, x, w.shape[1], _tile_rows(tile), 16, w=w, b=b, rgb_w=rgb_w,
           rgb_b=rgb_b)
    w, b = pad_cout(w, tile), pad_cout(b, tile)
    bsz, c, h, wd = x.shape
    if terms:
        y = torch.empty((bsz, cout, 2 * h, 2 * wd), device=x.device, dtype=x.dtype)
        rgb = None
        if rgb_w is not None:
            # rows of C rounded up to 4 (the kernel's float4 reads), zeros past C
            rgb_w = _bf16(pad_cout(rgb_w.reshape(3, c), -(-c // 4) * 4, 1)).contiguous()
            rgb_b = rgb_b.contiguous()
            rgb = torch.empty((bsz, 3, h, wd), device=x.device, dtype=x.dtype)
        # named, so that nothing the kernel reads is freed before it runs
        wk, b, x = upconv_bf16_weights(w), b.contiguous(), _aligned16(x)
        smem = bf16_upconv_ring_bytes(tile)
        blocks = persistent_blocks(upconv_tile_count(bsz, tile, h, wd), _sms(x.device),
                                   ring_blocks_per_sm(smem))
        _bf16_launch(name, terms, x, _ptr(x), _ptr(wk), _ptr(b), _ptr(rgb_w), _ptr(rgb_b),
                     _ptr(y), _ptr(rgb), bsz, c, h, wd, cout, terms, UPCONV_EPILOGUES[epilogue],
                     blocks, smem, epilogue=epilogue, slab=cout)
        return y if rgb is None else (y, rgb)
    wk = upconv_kernel_weights(w)
    b = b.contiguous()
    y = torch.empty((bsz, cout, 2 * h, 2 * wd), device=x.device, dtype=x.dtype)
    rgb = None
    if rgb_w is not None:
        rgb_w, rgb_b = rgb_w.reshape(3, c).contiguous(), rgb_b.contiguous()
        rgb = torch.empty((bsz, 3, h, wd), device=x.device, dtype=x.dtype)
    x = _aligned16(x)
    smem = upconv_ring_bytes(tile)
    blocks = persistent_blocks(upconv_tile_count(bsz, tile, h, wd), _sms(x.device),
                               ring_blocks_per_sm(smem))
    _launch(name, x, _ptr(x), _ptr(wk), _ptr(b), _ptr(rgb_w), _ptr(rgb_b),
            _ptr(y), _ptr(rgb), bsz, c, h, wd, cout, UPCONV_EPILOGUES[epilogue],
            blocks, smem, epilogue=epilogue, slab=cout)
    return y if rgb is None else (y, rgb)


# ---------------------------------------------------------------------------
# packed_conv
# ---------------------------------------------------------------------------

def _epilogue(y: torch.Tensor, epilogue: str) -> torch.Tensor:
    if epilogue == "lrelu_norm":
        return _lrelu_norm(y)
    return lrelu(y) if epilogue == "lrelu" else y


def packed_conv_plain(x, w, b, epilogue="lrelu_norm", mode="high"):
    """Plain twin of ``packed_conv``; mode "default" rounds x and w to bf16
    first, "mid" rounds w and splits x (``split2``)."""
    if epilogue not in CONV_EPILOGUES:
        raise ValueError(f"packed_conv: epilogue {epilogue!r} not in {tuple(CONV_EPILOGUES)}")
    terms = check_mode("packed_conv", mode)
    if terms:
        x, w = _operand(x, terms), _bf16(w)
    return _epilogue(F.conv2d(x, w, padding=1) + b[:, None, None], epilogue)


def conv_tiling(cout: int) -> tuple[int, int]:
    """(output channels per tile, tile rows) of both csrc/packed_conv.cu
    kernels, which launch the tiling they are given: slabs of
    ``_pool_slab(cout)`` channels (64, 32, 16 or 8), the layout of
    ``convpool_kernel_weights``, with 8-row tiles at 64 and 16-row tiles
    below; the tiles are 32 columns wide."""
    slab = _pool_slab(cout)
    return slab, _tile_rows(slab)


def conv_tile_count(bsz: int, cout: int, h: int, wd: int) -> int:
    """Tiles of packed_conv's walk: (image, tile row, tile column, slab)."""
    o_slab, rows = conv_tiling(cout)
    return bsz * (h // rows) * (wd // 32) * (cout // o_slab)


def conv_tile_origin(t: int, cout: int, h: int, wd: int) -> tuple[int, int, int, int]:
    """(image, first row, first column, first output channel) of tile ``t``
    of packed_conv's walk (``ConvRing::tile_of`` in csrc/conv_ring.cuh and
    ``none_tile`` in csrc/packed_conv.cu): the slab fastest, then columns,
    rows and images."""
    o_slab, rows = conv_tiling(cout)
    t, slab = divmod(t, cout // o_slab)
    t, tx = divmod(t, wd // 32)
    b, ty = divmod(t, h // rows)
    return b, ty * rows, tx * 32, slab * o_slab


def persistent_blocks(n_tiles: int, sms: int, per_sm: int = RING_BLOCKS_PER_SM) -> int:
    """Persistent blocks of a walk over ``n_tiles``: ``per_sm`` an SM (one
    for the "none" kernel's ring, 150-190 KB at every slab, and the wide
    fp32 rings, ~200 KB;
    ``ring_blocks_per_sm`` of a ring's bytes), block k walking tiles k,
    k + blocks, ..."""
    return max(1, min(n_tiles, per_sm * sms))


def ring_blocks_per_sm(smem: int) -> int:
    """Blocks of a fp32 ring of ``smem`` bytes that one H100 multiprocessor
    holds (SMEM_PER_SM, SMEM_RESERVED a block): 1 for the rings at 32 and 64
    channels, 2 for those at 16 and 8."""
    return max(1, SMEM_PER_SM // (smem + SMEM_RESERVED))


def ring_cc(cout: int) -> int:
    """Input channels a stage of the fp32 ring at a slab of ``cout`` output
    channels (csrc/conv_ring.cuh ConvRing::kCC, UpconvRing::kCC): RING_CC at
    32 and 64, 8 at 16 and 8, whose smaller blocks (128 and 64 threads) keep
    the 32-channel tile."""
    return RING_CC if cout >= 32 else 8


def conv_ring_bytes(cout: int) -> int:
    """Dynamic shared memory of packed_conv's fp32 ring, of packed_conv_rgb
    and of packed_convpool (csrc/conv_ring.cuh ConvRing::kBytes, which
    ConvRgbRing and ConvPoolRing keep):
    RING_STAGES stages of ``ring_cc`` input channels, each the channel's halo
    patch (tile rows + 2, 40 columns in rows of 44 floats) and its 9 x slab
    weights."""
    o_slab, rows = conv_tiling(cout)
    return 4 * RING_STAGES * ring_cc(o_slab) * ((rows + 2) * 44 + 9 * o_slab)


def none_ring_bytes(cout: int) -> int:
    """Dynamic shared memory of packed_conv's "none" kernel (csrc/packed_conv.cu
    NoneTile::kStage x 3 stages): 16 input channels a stage, each the halo
    patch (tile rows + 2, 40 columns, + 8 floats) and the slab's 9 x slab
    weights, padded to 8 or 24 floats mod 32 (no padding at a slab of 8)."""
    o_slab, rows = conv_tiling(cout)
    wrow = 9 * o_slab + (0 if (9 * o_slab) % 32 == 8 else 8)
    return 4 * 3 * 16 * ((rows + 2) * 40 + 8 + wrow)


def upconv_tiling(cout: int) -> tuple[int, int]:
    """(input rows, input columns) under one tile of packed_upconv: one
    output row parity of them, all Cout channels (csrc/conv_ring.cuh
    UpconvRing): 8 x 16 at Cout 64, 16 x 16 at 32, 16 and 8."""
    return _tile_rows(cout), 16


def upconv_tile_count(bsz: int, cout: int, h: int, wd: int) -> int:
    """Tiles of packed_upconv's walk over an input of h x wd: (image, tile
    row, tile column, parity)."""
    rows, cols = upconv_tiling(cout)
    return bsz * (h // rows) * (wd // cols) * 2


def upconv_tile_origin(t: int, cout: int, h: int, wd: int) -> tuple[int, int, int, int]:
    """(image, first input row, first input column, output row parity) of
    tile ``t`` of packed_upconv's walk (``UpconvRing::tile_of``): the parity
    fastest, then columns, rows and images. The tile's outputs are rows
    2 * (i0 + r) + py for r < rows, columns 2 * j0 .. 2 * j0 + 31."""
    rows, cols = upconv_tiling(cout)
    t, py = divmod(t, 2)
    t, tx = divmod(t, wd // cols)
    b, ty = divmod(t, h // rows)
    return b, ty * rows, tx * cols, py


def upconv_ring_bytes(cout: int) -> int:
    """Dynamic shared memory of packed_upconv's ring (UpconvRing::kBytes):
    RING_STAGES stages of ``ring_cc`` input channels, each the channel's
    staged rows (tile rows + 1, 24 columns in rows of 24 floats at Cout 64,
    48 below) and one parity's 8 x Cout pre-summed taps."""
    rows, _ = upconv_tiling(cout)
    return 4 * RING_STAGES * ring_cc(cout) * ((rows + 1) * (24 if cout == 64 else 48)
                                              + 8 * cout)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x``, copied when its data is not 16-byte aligned: the ring kernels
    copy 16 bytes at a time."""
    return x.clone() if x.data_ptr() % 16 else x


def packed_conv(x, w, b, epilogue="lrelu_norm", mode="high"):
    """conv3x3 SAME + bias -> epilogue ("lrelu_norm": LeakyReLU -> PixelNorm;
    "lrelu": LeakyReLU; "none"): x [B, C, H, W] fp32, w [Cout, C, 3, 3] eq-LR
    scaled, b [Cout] -> [B, Cout, H, W]. On CUDA, "lrelu_norm" takes any
    Cout from 1 to 64 and any C >= 1 (one slab, ``norm_tile(Cout)``'s, the
    weights and bias zero-padded to it); "lrelu" and "none" any Cout >= 1
    (slabs of ``sliced_cout(Cout)``, the weights and bias zero-padded to
    it), every epilogue any C >= 1. "none" is 3xTF32 on the card
    (each product three TF32 products of the operands' high and low parts,
    within ~1e-6 of the output's largest entry of the fp32 sum) and sums
    every output in a fixed order, so equal inputs give equal bits.
    ``mode``: "high"/"highest" (fp32), "default" (one bf16 pass) or "mid"
    (the 2-term split), every epilogue; both bf16 modes are
    ``packed_conv_bf16`` on the card (Cout in slabs as the fp32 kernels)."""
    if x.device.type == "cpu":
        return packed_conv_plain(x, w, b, epilogue, mode)
    name = "packed_conv"
    if epilogue not in CONV_EPILOGUES:
        raise ValueError(f"{name}: epilogue {epilogue!r} not in {tuple(CONV_EPILOGUES)}")
    terms = check_mode(name, mode)
    _refuse_grad(name, "conv_lrelu_norm" if epilogue == "lrelu_norm" else "conv_lrelu",
                 x, w, b)
    cout = w.shape[0]
    norm = epilogue == "lrelu_norm"
    _check_cout(name, cout, sliced=not norm, any_width=norm)
    # "lrelu_norm": one slab, the tile just above Cout (Cout itself at 8, 16,
    # 32 and 64); else slabs of Cout rounded up to a multiple of 8. The
    # weights and bias are padded to the Cout the tiling's walk sees.
    walk = norm_tile(cout) if norm else sliced_cout(cout)
    slab = walk if norm else _pool_slab(walk)
    _check(name, x, w.shape[1], _tile_rows(slab), 32, w=w, b=b)
    w, b = pad_cout(w, walk), pad_cout(b, walk)
    # counted by the true Cout where it is no tile's width, else by the slab
    key = cout if norm or cout % 8 else slab
    bsz, c, h, wd = x.shape
    if terms:
        y = torch.empty((bsz, cout, h, wd), device=x.device, dtype=x.dtype)
        wk, b, x = conv_bf16_weights(w, slab), b.contiguous(), _aligned16(x)
        smem = bf16_ring_bytes(walk)
        blocks = persistent_blocks(conv_tile_count(bsz, walk, h, wd), _sms(x.device),
                                   ring_blocks_per_sm(smem))
        _bf16_launch(name, terms, x, _ptr(x), _ptr(wk), _ptr(b), _ptr(y), bsz, c, h, wd, cout,
                     terms, CONV_EPILOGUES[epilogue], blocks, smem, epilogue=epilogue, slab=key)
        return y
    # one slab for Cout 8, 16, 32 or 64: then this is conv_kernel_weights(w)
    wk = convpool_kernel_weights(w)
    b = b.contiguous()
    y = torch.empty((bsz, cout, h, wd), device=x.device, dtype=x.dtype)
    x = _aligned16(x)
    smem = none_ring_bytes(walk) if epilogue == "none" else conv_ring_bytes(walk)
    blocks = persistent_blocks(conv_tile_count(bsz, walk, h, wd), _sms(x.device),
                               ring_blocks_per_sm(smem))
    _launch(name, x, _ptr(x), _ptr(wk), _ptr(b), _ptr(y), bsz, c, h, wd, cout,
            CONV_EPILOGUES[epilogue], *conv_tiling(walk), blocks, smem, epilogue=epilogue,
            slab=key)
    return y


# ---------------------------------------------------------------------------
# packed_convpool
# ---------------------------------------------------------------------------

def _pool_slab(cout: int) -> int:
    """Output channels one kernel block owns (csrc/packed_convpool.cu CT):
    the largest of 64, 32, 16 and 8 that divides Cout."""
    for slab in (64, 32, 16):
        if cout % slab == 0:
            return slab
    return 8


def convpool_kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, C, 3, 3] -> packed_convpool's [Cout/CT][C][3 ky][3 kx][CT]:
    packed_conv's layout, one slab of CT output channels after the other."""
    cout, c = w.shape[:2]
    ct = _pool_slab(cout)
    return w.reshape(cout // ct, ct, c, 3, 3).permute(0, 2, 3, 4, 1).contiguous()


def packed_convpool_plain(x, w, b, epilogue="lrelu", mode="high"):
    """Plain twin of ``packed_convpool``; mode "default" rounds x and w to
    bf16 first, "mid" rounds w and splits x (``split2``)."""
    if epilogue not in POOL_EPILOGUES:
        raise ValueError(f"packed_convpool: epilogue {epilogue!r} not in {POOL_EPILOGUES}")
    terms = check_mode("packed_convpool", mode)
    if terms:
        x, w = _operand(x, terms), _bf16(w)
    return F.avg_pool2d(_epilogue(F.conv2d(x, w, padding=1) + b[:, None, None], epilogue), 2)


def packed_convpool(x, w, b, epilogue="lrelu", mode="high"):
    """conv3x3 SAME + bias -> LeakyReLU ("lrelu") or nothing ("none") -> 2x2
    mean pool; the activation comes before the pool. x [B, C, H, W] fp32,
    w [Cout, C, 3, 3] eq-LR scaled, b [Cout] -> [B, Cout, H/2, W/2].
    On CUDA, any Cout >= 1 and any C >= 1, at both epilogues (slabs of
    ``sliced_cout(Cout)``, the weights and bias zero-padded to it, only the
    true Cout stored); the kernels walk packed_conv's tiles
    (``conv_tile_count``) on its rings, in persistent blocks.
    ``mode``: "high"/"highest" (fp32), "default" (one bf16 pass) or "mid"
    (the 2-term split); both bf16 modes are ``packed_convpool_bf16`` on the
    card."""
    if x.device.type == "cpu":
        return packed_convpool_plain(x, w, b, epilogue, mode)
    name = "packed_convpool"
    if epilogue not in POOL_EPILOGUES:
        raise ValueError(f"{name}: epilogue {epilogue!r} not in {POOL_EPILOGUES}")
    terms = check_mode(name, mode)
    _refuse_grad(name, "convpool_lrelu", x, w, b)
    cout = w.shape[0]
    _check_cout(name, cout, sliced=True)
    walk = sliced_cout(cout)
    slab = _pool_slab(walk)
    _check(name, x, w.shape[1], _tile_rows(slab), 32, w=w, b=b)
    w, b = pad_cout(w, walk), pad_cout(b, walk)
    key = cout if cout % 8 else slab  # counted as packed_conv counts it
    bsz, c, h, wd = x.shape
    y = torch.empty((bsz, cout, h // 2, wd // 2), device=x.device, dtype=x.dtype)
    # named, so that nothing the kernel reads is freed before it runs
    b, x = b.contiguous(), _aligned16(x)
    smem = bf16_ring_bytes(walk) if terms else conv_ring_bytes(walk)
    blocks = persistent_blocks(conv_tile_count(bsz, walk, h, wd), _sms(x.device),
                               ring_blocks_per_sm(smem))
    act = int(epilogue == "lrelu")
    if terms:
        wk = conv_bf16_weights(w, slab)
        _bf16_launch(name, terms, x, _ptr(x), _ptr(wk), _ptr(b), _ptr(y), bsz, c, h, wd, cout,
                     terms, act, blocks, smem, epilogue=epilogue, slab=key)
        return y
    wk = convpool_kernel_weights(w)
    _launch(name, x, _ptr(x), _ptr(wk), _ptr(b), _ptr(y), bsz, c, h, wd, cout, act, blocks,
            smem, epilogue=epilogue, slab=key)
    return y


# ---------------------------------------------------------------------------
# packed_conv_rgb
# ---------------------------------------------------------------------------

def packed_conv_rgb_plain(x, w, b, rgb_w, rgb_b, rgb_prev, alpha, *,
                          emit_uint8=False, mode="high"):
    """Plain twin of ``packed_conv_rgb``; modes "default" and "mid" round w
    and ``rgb_w`` to bf16 before their convs, and x and the PixelNorm'd
    features ("default") or split them (``split2``, "mid")."""
    terms = check_mode("packed_conv_rgb", mode)
    if terms:
        x, w, rgb_w = _operand(x, terms), _bf16(w), _bf16(rgb_w)
    feat = _lrelu_norm(F.conv2d(x, w, padding=1) + b[:, None, None])
    rgb = (F.conv2d(_operand(feat, terms) if terms else feat, rgb_w[:, :, None, None])
           + rgb_b[:, None, None])
    prev = upsample_nearest_2x(rgb_prev)
    out = (prev + alpha * (rgb - prev)).permute(0, 2, 3, 1)
    return to_uint8(out) if emit_uint8 else out.contiguous()


def packed_conv_rgb(x, w, b, rgb_w, rgb_b, rgb_prev, alpha, *,
                    emit_uint8=False, mode="high"):
    """The final stage's tail: conv3x3 + bias -> LeakyReLU -> PixelNorm ->
    toRGB -> ``prev + alpha * (rgb - prev)`` with prev the nearest-2x of
    ``rgb_prev`` -> (tanh -> round half to even((t+1)*127.5) -> clip ->
    uint8 when ``emit_uint8``).

    x [B, C, H, W] fp32, w [Cout, C, 3, 3], b [Cout], rgb_w [3, Cout],
    rgb_b [3], rgb_prev [B, 3, H/2, W/2], alpha a runtime scalar
    -> NHWC [B, H, W, 3], uint8 or fp32 pre-tanh RGB. On CUDA, Cout is any
    count from 1 to 64 and C any count >= 1 (``norm_tile(Cout)``'s tile, w,
    b and rgb_w zero-padded to it), and the kernel runs packed_conv's ring
    ("lrelu_norm"'s tiles and sums, so the same bits) with the toRGB tail as
    its epilogue. ``mode``: "high"/"highest" (fp32, the fp32 ring),
    "default" (one bf16 pass) or "mid" (the 2-term split), toRGB's dot too;
    both bf16 modes are ``packed_conv_rgb_bf16`` on the card (the bf16 ring,
    one slab of all Cout)."""
    alpha = float(alpha)
    if x.device.type == "cpu":
        return packed_conv_rgb_plain(x, w, b, rgb_w, rgb_b, rgb_prev, alpha,
                                     emit_uint8=emit_uint8, mode=mode)
    name = "packed_conv_rgb"
    terms = check_mode(name, mode)
    _refuse_grad(name, "conv_lrelu_norm followed by the toRGB conv and the blend as "
                 "torch ops, as models.pro_gan.generator_rgb(packed_mode=...) does",
                 x, w, b, rgb_w, rgb_b, rgb_prev)
    cout = w.shape[0]
    _check_cout(name, cout, any_width=True)
    tile = norm_tile(cout)  # Cout itself at 8, 16, 32 and 64
    _check(name, x, w.shape[1], _tile_rows(tile), 32, w=w, b=b, rgb_w=rgb_w,
           rgb_b=rgb_b, rgb_prev=rgb_prev)
    bsz, c, h, wd = x.shape
    if tuple(rgb_prev.shape) != (bsz, 3, h // 2, wd // 2):
        raise ValueError(
            f"{name}: rgb_prev {tuple(rgb_prev.shape)} must be "
            f"{(bsz, 3, h // 2, wd // 2)}"
        )
    w, b, rgb_w = pad_cout(w, tile), pad_cout(b, tile), pad_cout(rgb_w.reshape(3, cout), tile, 1)
    b = b.contiguous()
    rgb_b = rgb_b.contiguous()
    rgb_prev = rgb_prev.contiguous()
    out = torch.empty((bsz, h, wd, 3), device=x.device,
                      dtype=torch.uint8 if emit_uint8 else torch.float32)
    if terms:
        wk, rgb_w = conv_bf16_weights(w), _bf16(rgb_w).contiguous()
        x = _aligned16(x)
        smem = bf16_ring_bytes(tile)
        blocks = persistent_blocks(conv_tile_count(bsz, tile, h, wd), _sms(x.device),
                                   ring_blocks_per_sm(smem))
        _bf16_launch(name, terms, x, _ptr(x), _ptr(wk), _ptr(b), _ptr(rgb_w), _ptr(rgb_b),
                     _ptr(rgb_prev), alpha, _ptr(out), int(emit_uint8), bsz, c, h, wd, cout,
                     terms, blocks, smem, slab=cout)
        return out
    wk = conv_kernel_weights(w)
    rgb_w = rgb_w.contiguous()
    x = _aligned16(x)
    smem = conv_ring_bytes(tile)
    blocks = persistent_blocks(conv_tile_count(bsz, tile, h, wd), _sms(x.device),
                               ring_blocks_per_sm(smem))
    _launch(name, x, _ptr(x), _ptr(wk), _ptr(b), _ptr(rgb_w), _ptr(rgb_b),
            _ptr(rgb_prev), alpha, _ptr(out), int(emit_uint8), bsz, c, h, wd,
            cout, blocks, smem, slab=cout)
    return out


# ---------------------------------------------------------------------------
# packed_conv_wgrad
# ---------------------------------------------------------------------------

def _check_wgrad_shapes(x: torch.Tensor, dpre: torch.Tensor) -> None:
    if x.dim() != 4 or dpre.dim() != 4 or (
            x.shape[0], x.shape[2], x.shape[3]) != (dpre.shape[0], dpre.shape[2], dpre.shape[3]):
        raise ValueError(
            f"packed_conv_wgrad: x {tuple(x.shape)} and dpre {tuple(dpre.shape)} must be "
            "[B, C, H, W] and [B, Cout, H, W]")


def packed_conv_wgrad_plain(x, dpre, mode="highest"):
    """Plain twin of ``packed_conv_wgrad``: for each of the nine taps, the
    product of the shifted zero-padded input with the cotangent, summed over
    batch and pixels in fp32; mode "default" rounds x and dpre to bf16 first,
    the other modes take them as they are."""
    if check_mode("packed_conv_wgrad", mode) == 1:
        x, dpre = _bf16(x), _bf16(dpre)
    _check_wgrad_shapes(x, dpre)
    h, wd = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1))
    taps = [torch.einsum("bchw,bohw->oc", xp[:, :, ky:ky + h, kx:kx + wd], dpre)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps, dim=-1).reshape(dpre.shape[1], x.shape[1], 3, 3)


def wgrad_tiling(cout: int) -> tuple[int, int, int]:
    """(output channels per block, tile rows, blocks in one wave) for
    csrc/packed_conv_wgrad.cu, which launches the tiling it is given: Cout %
    64 == 0 takes 64-channel slabs with 4-row tiles, one block an SM; any
    other Cout 32-channel slabs with 2-row tiles, two an SM. Both take input
    channels 32 at a time."""
    if cout % 64 == 0:
        return 64, 4, WGRAD_BLOCKS
    return 32, 2, 2 * WGRAD_BLOCKS


def wgrad_ksplit(bsz: int, c: int, cout: int, h: int, wd: int) -> int:
    """Blocks that share the pixels of one (32 input, 32 or 64 output
    channel) slab of ``wgrad_tiling(cout)``, so that the grid is one wave
    (one more block than the card holds at once would double the time)."""
    o_slab, rows, blocks = wgrad_tiling(cout)
    slabs = -(-c // 32) * -(-cout // o_slab)
    tiles = bsz * (h // rows) * (wd // 32)
    return max(1, min(tiles, blocks // slabs, 65535))


def packed_conv_wgrad(x, dpre, mode="highest"):
    """Weight gradient of a conv3x3 SAME: x [B, C, H, W] fp32 the conv's
    input, dpre [B, Cout, H, W] the cotangent of its pre-bias output
    -> dW [Cout, C, 3, 3], dW[o, c, ky, kx] = sum over (b, y, x) of
    x_pad[b, c, y+ky-1, x+kx-1] * dpre[b, o, y, x]. fp32 by accuracy: on the
    card each product is three TF32 products of the operands' high and low
    parts, within ~1e-6 of dW's largest entry of the fp32 sum. Every sum has a
    fixed order, so equal inputs give equal bits. On CUDA, any C >= 1 and
    Cout >= 1 (channels past them staged as zeros, not written), H a
    multiple of 8 and W of 32, and x and dpre 16-byte aligned.
    ``mode``: "mid", "high" and "highest" run this one kernel, as the
    reference promotes its split modes to HIGHEST; "default" is one bf16 pass,
    ``packed_conv_wgrad_bf16`` on the card: both operands rounded to bf16 (to
    nearest even), the products (exact in fp32) summed in fp32 in a fixed
    order too."""
    if x.device.type == "cpu":
        return packed_conv_wgrad_plain(x, dpre, mode)
    name = "packed_conv_wgrad"
    terms = check_mode(name, mode)
    _check_wgrad_shapes(x, dpre)
    _refuse_grad(name, "conv_lrelu and its siblings, whose backward is not "
                 "differentiable a second time", x, dpre)
    _check(name, x, x.shape[1], 8, 32, dpre=dpre)
    bsz, c, h, wd = x.shape
    cout = dpre.shape[1]
    if cout < 1 or not dpre.is_contiguous():
        raise ValueError(f"{name}: dpre {tuple(dpre.shape)} must be contiguous with "
                         "Cout >= 1")
    if x.data_ptr() % 16 or dpre.data_ptr() % 16:  # the kernel copies 16 bytes at a time
        raise ValueError(f"{name}: x and dpre must be 16-byte aligned")
    o_slab, rows, _ = wgrad_tiling(cout)
    ksplit = wgrad_ksplit(bsz, c, cout, h, wd)
    partials = torch.empty((ksplit, 9, c, cout), device=x.device, dtype=x.dtype)
    dw = torch.empty((cout, c, 3, 3), device=x.device, dtype=x.dtype)
    _launch(f"{name}_bf16" if terms == 1 else name, x, _ptr(x), _ptr(dpre), _ptr(partials),
            _ptr(dw), bsz, c, h, wd, cout, o_slab, rows, ksplit,
            slab=cout if cout % 8 else None)
    return dw


# ---------------------------------------------------------------------------
# packed_upconv_conv, packed_upconv_conv_rgb: one kernel per stage
# ---------------------------------------------------------------------------

def packed_upconv_conv_plain(x, w1, b1, w2, b2, *, mode="high"):
    """Plain twin of ``packed_upconv_conv``: the pair's twins composed at
    ``mode``."""
    check_mode("packed_upconv_conv", mode)
    return packed_conv_plain(packed_upconv_plain(x, w1, b1, mode=mode), w2, b2, mode=mode)


def packed_upconv_conv_rgb_plain(x, w1, b1, w2, b2, rgb_w, rgb_b, prev_rgb_w, prev_rgb_b,
                                 alpha, *, emit_uint8=False, mode="high"):
    """Plain twin of ``packed_upconv_conv_rgb``: the pair's twins composed at
    ``mode``."""
    check_mode("packed_upconv_conv_rgb", mode)
    feats, rgb_prev = packed_upconv_plain(x, w1, b1, rgb_w=prev_rgb_w, rgb_b=prev_rgb_b,
                                          mode=mode)
    return packed_conv_rgb_plain(feats, w2, b2, rgb_w, rgb_b, rgb_prev, alpha,
                                 emit_uint8=emit_uint8, mode=mode)


def fused_tiling(cout: int) -> tuple[int, int]:
    """(output rows, output columns) of one conv2 tile of the stage-fused
    kernels, all Cout channels (csrc/conv_tile.cuh Tile): 8 x 32 at Cout 64,
    16 x 32 at 32, 16 and 8."""
    return _tile_rows(cout), 32


def fused_tile_count(bsz: int, cout: int, h: int, wd: int) -> int:
    """conv2 tiles of the stage-fused walk over an input of h x wd."""
    rows, cols = fused_tiling(cout)
    return bsz * (2 * h // rows) * (2 * wd // cols)


def fused_blocks_per_sm(cout: int) -> int:
    """Persistent stage-fused blocks an H100 multiprocessor holds at ``cout``
    channels, from the larger of the two kernels' bytes (B11's,
    ``fused_ring_bytes``; B10's give the same count): 1 at 64 and 32, 2 at
    16 (128-thread blocks), 3 at 8 (64 threads)."""
    return ring_blocks_per_sm(fused_ring_bytes(cout, rgb=True))


def fused_split(bsz: int, cout: int, h: int, wd: int, sms: int) -> tuple[int, int, int]:
    """(blocks, per_block, extra): the split of the stage-fused walk that the
    wrappers pass to the kernels, whose C entries check it
    (csrc/fused_ring.cuh fused_checked_tiles). ``fused_blocks_per_sm``
    persistent blocks an SM; the walk's order (images, 32-column strips, tile
    rows down a strip) cut into the blocks' contiguous ranges, per_block
    tiles each and one more for the first ``extra`` blocks. A run, whose
    first tile computes conv1's whole halo and whose later tiles carry its
    two top rows from the tile above, is the part of a range inside one
    strip of one image. Neither a tile's sums nor the bits depend on the
    split."""
    n = fused_tile_count(bsz, cout, h, wd)
    blocks = persistent_blocks(n, sms, fused_blocks_per_sm(cout))
    return (blocks, *divmod(n, blocks))


def fused_tile_origin(t: int, split: tuple[int, int, int], cout: int, h: int,
                      wd: int) -> tuple[int, int, int, bool]:
    """(image, first output row, first output column, starts a run) of tile
    ``t`` = block + k * blocks of the stage-fused walk under ``split``
    (``fused_split``), as ``FusedRing::tile_of`` in csrc/fused_ring.cuh
    walks it: block k's tiles are the k-th range."""
    rows, cols = fused_tiling(cout)
    blocks, per, extra = split
    blk, k = t % blocks, t // blocks
    g, row = divmod(blk * per + min(blk, extra) + k, 2 * h // rows)
    b, strip = divmod(g, 2 * wd // cols)
    return b, row * rows, strip * cols, k == 0 or row == 0


def fused_runs(bsz: int, cout: int, h: int, wd: int, sms: int) -> list[list[tuple]]:
    """Each block's runs of the stage-fused walk on ``sms`` SMs, each a list
    of its tiles' (image, first row, first column), in the order the block
    walks them."""
    split = fused_split(bsz, cout, h, wd, sms)
    runs = [[] for _ in range(split[0])]
    for t in range(fused_tile_count(bsz, cout, h, wd)):
        b, y0, x0, first = fused_tile_origin(t, split, cout, h, wd)
        if first:
            runs[t % split[0]].append([])
        runs[t % split[0]][-1].append((b, y0, x0))
    return runs


def fused_conv1_per_output(bsz: int, cout: int, h: int, wd: int, sms: int) -> float:
    """conv1 pixels the stage-fused walk computes per conv2 output, from the
    tiling: 34 columns of each tile's rows, TH + 2 rows for a run's first
    tile and TH for the others (the clock-split probe counts what the kernel
    stores, utils/conv_clock_split.py)."""
    rows, cols = fused_tiling(cout)
    runs = [r for block in fused_runs(bsz, cout, h, wd, sms) for r in block]
    n = sum(len(r) for r in runs)
    return (cols + 2) * (rows * n + 2 * len(runs)) / (rows * cols * n)


def fused_c2(cout: int) -> int:
    """conv2 input channels a conv2 step of the stage-fused ring
    (FusedRing::kC2): FUSED_C2, or Cout below it (8)."""
    return min(FUSED_C2, cout)


def fused_ring_bytes(cout: int, rgb: bool) -> int:
    """Dynamic shared memory of a stage-fused block (FusedRing::kBytes):
    FUSED_STAGES stages, each the larger of a conv1 step (FUSED_C1 channels of
    tile rows / 2 + 2 input rows in rows of 28 floats, and both row parities'
    8 x Cout pre-summed taps) and a conv2 step (``fused_c2`` x 9 x Cout
    taps); conv1's map, Cout x (tile rows + 2) x 36; the previous stage's RGB
    under the tile, 3 x tile rows / 2 x 16 (``rgb``)."""
    rows, cols = fused_tiling(cout)
    stage = max(FUSED_C1 * (rows // 2 + 2) * 28 + 2 * FUSED_C1 * 8 * cout,
                fused_c2(cout) * 9 * cout)
    prev = 3 * (rows // 2) * (cols // 2) if rgb else 0
    return 4 * (FUSED_STAGES[cout] * stage + cout * (rows + 2) * (cols + 4) + prev)


def fused_bf16_bytes(cout: int, terms: int, rgb: bool) -> int:
    """Dynamic shared memory of a stage-fused block at a bf16 mode
    (csrc/fused_bf16.cuh FusedBf16::kBytes), 2 x 40 bytes a bf16 pixel or
    weight row: the larger of conv1's staging (its input, tile rows / 2 + 2
    x 24 pixels once a term, and both row parities' taps, 2 x 8 x Cout) and
    one chunk of conv2's weights (9 x Cout), which share one region; conv1's
    map, ``bf16_chunks(cout)`` chunks of (tile rows + 2) x 34 pixels once a
    term (one, partial, at 16 and 8); the previous stage's RGB under the
    tile, 3 x tile rows / 2 x 16 floats (``rgb``)."""
    rows = _tile_rows(cout)
    conv1 = terms * (rows // 2 + 2) * 24 + 2 * 8 * cout
    conv2 = 9 * cout
    fmap = terms * bf16_chunks(cout) * (rows + 2) * 34
    prev = 4 * 3 * (rows // 2) * 16 if rgb else 0
    return 2 * BF16_ROW * (max(conv1, conv2) + fmap) + prev


def _stage_fused_checks(name: str, x, w1, w2, **params) -> int:
    """The stage-fused kernels' shape rules: conv1 C -> Cout, conv2 Cout ->
    Cout with Cout 8, 16, 32 or 64 (below 8 is not ported yet: ROADMAP.md);
    C % 8; input rows a multiple of half the conv2 tile's rows, columns of
    16. Returns Cout."""
    cout = w1.shape[0]
    _check_cout(name, cout)
    if tuple(w2.shape) != (cout, cout, 3, 3):
        raise ValueError(f"{name}: w2 {tuple(w2.shape)} must be {(cout, cout, 3, 3)}")
    _check(name, x, w1.shape[1], _tile_rows(cout) // 2, 16, c8=True, w1=w1, w2=w2, **params)
    return cout


def _fused_bf16_launch(name: str, mode: str, x, w1, b1, w2, b2, out, *rgb_args,
                       tally: torch.Tensor | None = None) -> None:
    """Launch the bf16 kernel of stage-fused ``name`` (csrc/<name>_bf16.cu)
    at ``mode`` ("default" or "mid"): the pair's bf16 weight layouts,
    counted as "<name>_bf16" or "<name>_mid". ``rgb_args``: B11's toRGB
    weights (rounded to bf16 here) and biases, alpha and emit_uint8.
    ``tally`` (int64 [1] on x's device), when given, gains the conv1 pixels
    the blocks store."""
    _check_fused_bf16_channels(name, x, mode)
    if tally is not None and (tally.dtype != torch.int64 or tally.device != x.device
                              or tally.numel() < 1):
        raise ValueError(f"{name}: _tally must be an int64 tensor on {x.device}")
    terms = BF16_TERMS[mode]
    bsz, c, h, wd = x.shape
    cout = w1.shape[0]
    # named, so that nothing the kernel reads is freed before it runs
    wk1, wk2 = upconv_bf16_weights(w1), conv_bf16_weights(w2)
    b1, b2 = b1.contiguous(), b2.contiguous()
    ptrs = [_ptr(x), _ptr(wk1), _ptr(b1), _ptr(wk2), _ptr(b2)]
    if rgb_args:
        rgb_w, rgb_b, prev_w, prev_b, alpha, emit_uint8 = rgb_args
        rgb_w, prev_w = _bf16(rgb_w.reshape(3, cout)).contiguous(), _bf16(
            prev_w.reshape(3, c)).contiguous()
        rgb_b, prev_b = rgb_b.contiguous(), prev_b.contiguous()
        ptrs += [_ptr(rgb_w), _ptr(rgb_b), _ptr(prev_w), _ptr(prev_b), alpha, _ptr(out),
                 int(emit_uint8)]
    else:
        ptrs.append(_ptr(out))
    _bf16_launch(name, terms, x, *ptrs, _ptr(tally), bsz, c, h, wd, cout, terms,
                 fused_bf16_bytes(cout, terms, rgb=bool(rgb_args)), slab=cout)


def packed_upconv_conv(x, w1, b1, w2, b2, *, mode="high", _tally=None):
    """One whole non-final generator stage in one kernel: nearest-2x upsample
    -> conv3x3 + b1 -> LeakyReLU -> PixelNorm -> conv3x3 + b2 -> LeakyReLU ->
    PixelNorm. x [B, C, H, W] fp32, w1 [Cout, C, 3, 3] and w2 [Cout, Cout, 3,
    3] eq-LR scaled -> [B, Cout, 2H, 2W], equal bit for bit to
    ``packed_conv(packed_upconv(x, w1, b1, mode=mode), w2, b2, mode=mode)`` on
    the card. On CUDA, Cout is 8, 16, 32 or 64 and C % 8 == 0. ``mode``:
    "high"/"highest" (the fp32 ring, csrc/fused_ring.cuh), "default" (one
    bf16 pass) or "mid" (the 2-term split), both ``packed_upconv_conv_bf16``
    on the card.
    ``_tally`` (int64 [1] on the card, bf16 modes): gains the conv1 pixels
    the kernel stores, for the utilities that count them."""
    if x.device.type == "cpu":
        return packed_upconv_conv_plain(x, w1, b1, w2, b2, mode=mode)
    name = "packed_upconv_conv"
    terms = check_mode(name, mode)
    _refuse_grad(name, "upconv_lrelu_norm followed by conv_lrelu_norm", x, w1, b1, w2, b2)
    cout = _stage_fused_checks(name, x, w1, w2, b1=b1, b2=b2)
    bsz, c, h, wd = x.shape
    y = torch.empty((bsz, cout, 2 * h, 2 * wd), device=x.device, dtype=x.dtype)
    if terms:
        _fused_bf16_launch(name, mode, x, w1, b1, w2, b2, y, tally=_tally)
        return y
    wk1, wk2 = upconv_kernel_weights(w1), conv_kernel_weights(w2)
    b1, b2 = b1.contiguous(), b2.contiguous()
    x = _aligned16(x)
    split = fused_split(bsz, cout, h, wd, _sms(x.device))
    _launch(name, x, _ptr(x), _ptr(wk1), _ptr(b1), _ptr(wk2), _ptr(b2), _ptr(y), bsz, c, h,
            wd, cout, *split, fused_ring_bytes(cout, rgb=False), slab=cout)
    return y


def packed_upconv_conv_rgb(x, w1, b1, w2, b2, rgb_w, rgb_b, prev_rgb_w, prev_rgb_b, alpha, *,
                           emit_uint8=False, mode="high", _tally=None):
    """The whole final generator stage in one kernel: ``packed_upconv_conv``'s
    chain -> toRGB (``rgb_w`` [3, Cout], ``rgb_b`` [3]) -> ``prev + alpha *
    (rgb - prev)``, prev the nearest-2x of toRGB_{s-1}(x) (``prev_rgb_w``
    [3, C], ``prev_rgb_b`` [3]) -> (tanh -> round half to even((t+1)*127.5)
    -> clip -> uint8 when ``emit_uint8``). x [B, C, H, W] fp32 -> NHWC
    [B, 2H, 2W, 3], uint8 or fp32 pre-tanh RGB, equal bit for bit to
    ``packed_upconv(x, w1, b1, rgb_w=prev_rgb_w, rgb_b=prev_rgb_b, mode=mode)``
    then ``packed_conv_rgb(..., mode=mode)`` of its two outputs on the card.
    ``mode`` and ``_tally`` as ``packed_upconv_conv`` takes them (the bf16
    modes: ``packed_upconv_conv_rgb_bf16``, both toRGB dots at the mode)."""
    alpha = float(alpha)
    if x.device.type == "cpu":
        return packed_upconv_conv_rgb_plain(x, w1, b1, w2, b2, rgb_w, rgb_b, prev_rgb_w,
                                            prev_rgb_b, alpha, emit_uint8=emit_uint8,
                                            mode=mode)
    name = "packed_upconv_conv_rgb"
    terms = check_mode(name, mode)
    _refuse_grad(name, "upconv_lrelu_norm and conv_lrelu_norm followed by the toRGB convs "
                 "and the blend as torch ops, as models.pro_gan.generator_rgb(packed_mode=...) "
                 "does", x, w1, b1, w2, b2, rgb_w, rgb_b, prev_rgb_w, prev_rgb_b)
    cout = _stage_fused_checks(name, x, w1, w2, b1=b1, b2=b2, rgb_w=rgb_w, rgb_b=rgb_b,
                               prev_rgb_w=prev_rgb_w, prev_rgb_b=prev_rgb_b)
    bsz, c, h, wd = x.shape
    out = torch.empty((bsz, 2 * h, 2 * wd, 3), device=x.device,
                      dtype=torch.uint8 if emit_uint8 else torch.float32)
    if terms:
        _fused_bf16_launch(name, mode, x, w1, b1, w2, b2, out, rgb_w, rgb_b, prev_rgb_w,
                           prev_rgb_b, alpha, emit_uint8, tally=_tally)
        return out
    wk1, wk2 = upconv_kernel_weights(w1), conv_kernel_weights(w2)
    b1, b2 = b1.contiguous(), b2.contiguous()
    rgb_w, rgb_b = rgb_w.reshape(3, cout).contiguous(), rgb_b.contiguous()
    prev_rgb_w, prev_rgb_b = prev_rgb_w.reshape(3, c).contiguous(), prev_rgb_b.contiguous()
    x = _aligned16(x)
    split = fused_split(bsz, cout, h, wd, _sms(x.device))
    _launch(name, x, _ptr(x), _ptr(wk1), _ptr(b1), _ptr(wk2), _ptr(b2), _ptr(rgb_w),
            _ptr(rgb_b), _ptr(prev_rgb_w), _ptr(prev_rgb_b), alpha, _ptr(out), int(emit_uint8),
            bsz, c, h, wd, cout, *split, fused_ring_bytes(cout, rgb=True), slab=cout)
    return out
