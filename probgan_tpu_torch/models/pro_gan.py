"""Progressive image-synthesis GAN, generator and discriminator, in PyTorch.

The port of ``probgan_tpu/models/pro_gan.py``: latent -> PixelNorm ->
equalized-LR conv blocks -> progressive upsample + toRGB alpha blend ->
tanh/denorm to uint8, and the mirrored downsample/conv discriminator for
scoring. Parameters are plain dicts of tensors with the JAX package's tree
structure; conv weights are OIHW ``[Cout, Cin, kh, kw]`` (``core/convert.py``
turns the JAX package's HWIO trees into this), dense weights ``[in, out]``.

Internally activations are NCHW. The public functions keep the JAX shapes:
latents ``[B, L]`` in, ``generator_rgb`` -> ``[B, R, R, 3]`` fp32 and
``generator_apply`` -> ``[B, R, R, 3]`` uint8, both NHWC;
``discriminator_apply`` takes ``[B, R, R, 3]`` float images and returns
logits ``[B]``. The public functions take the JAX functions' parameters,
in their order and with their defaults; where the JAX functions take a
tuple of mesh axes (``minibatch_stddev``'s ``axis_name``,
``discriminator_apply``'s ``stddev_axis``), the port takes the process group
of those ranks (``parallel/mesh.py:mesh_group``).

Precision grades: ``precision`` is one of None, "default", "fast", "high",
"highest" (``_PRECISIONS``, ``resolve_precision``); what each means on the
card is set out in one place, above ``_PRECISIONS``. Every public function
runs inside ``precision_scope``, which sets PyTorch's two TF32 switches for
its grade and restores them on exit. ``dtype=torch.bfloat16`` runs the
unpacked convs in bf16 (weights cast to the activations' dtype); the
forward-only packed path declines it, as in the JAX package, and the
differentiable packed path (``packed_mode``) runs its kernels on fp32 casts
of the bf16 activations, casting their outputs back, as the JAX package's
does.

``remat=True`` checkpoints each unpacked stage block with
``torch.utils.checkpoint`` (non-reentrant, so a second-order term can pass
through it): the block's activations are dropped after the forward and the
whole block, its convs included, runs again in the backward. The JAX package's
policy keeps the conv outputs and recomputes only the elementwise chains
between them; the port recomputes more and stores less. No number changes.

Resolution of stage s is ``4 * 2**s``; channels ``nf(s) = min(fmap_base //
2**s, fmap_max)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import math
import os

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from probgan_tpu_torch.ops.fused_upconv import upsample2x_conv3x3

LRELU_SLOPE = 0.2
_PIXELNORM_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class ProGANConfig:
    resolution: int = 1024
    latent_dim: int = 512
    fmap_base: int = 8192
    fmap_max: int = 512
    num_channels: int = 3

    @property
    def num_stages(self) -> int:
        return int(math.log2(self.resolution // 4)) + 1

    def nf(self, stage: int) -> int:
        return min(self.fmap_base // (2**stage), self.fmap_max)


def stage_resolution(stage: int) -> int:
    return 4 * 2**stage


class Precision(enum.Enum):
    """The port's ``jax.lax.Precision``: what ``resolve_precision`` returns
    for a grade's name."""
    DEFAULT = 0
    HIGH = 1
    HIGHEST = 2


# The grades, and what each means on the card (Hopper). This is the one place
# that says so:
#
#   grade             unpacked convs and matmuls   G's packed stages    D's packed stages
#   None, "default"   TF32 (cuDNN, cuBLAS)         kernel mode          none: the gate
#                                                  "default"            declines (0)
#   "fast"            fp32, TF32 off               "default"            "mid"
#   "high","highest"  fp32, TF32 off               fp32 kernels         fp32 kernels
#
# TF32 (operands rounded to 10 mantissa bits, fp32 sums) is the card's
# counterpart of the TPU's one-pass bf16 Precision.DEFAULT for cuDNN's and
# cuBLAS's own ops; HIGH and HIGHEST keep fp32 (TF32 off, today's bits).
# Kernel mode "default" is the Pallas kernels' one bf16 pass: both operands
# rounded to bf16 (to nearest even), products summed in fp32, on the tensor
# cores (ops/packed.py). Kernel mode "mid" is their 2-term split: the weights
# rounded to bf16, the activations as bf16(x) + bf16(x - bf16(x)), two bf16
# products a dot. "fast" is the serving grade above the 50 dB bar: the early
# stages at HIGH and only the packed late stages in bf16, one pass in G and
# the split in D.
_PRECISIONS = {
    None: None,
    "default": Precision.DEFAULT,
    "fast": Precision.HIGH,
    "high": Precision.HIGH,
    "highest": Precision.HIGHEST,
}

# Kernel modes of the packed GENERATOR stages by grade: "high" takes the fp32
# kernels (the JAX package's fp32-exact "highest"), and "fast" one bf16 pass.
# A "base+final" mode would run the non-final packed stages in ``base`` and
# the final one in ``final`` (``_g_late_packed``); no grade maps to one.
_PACKED_MODES = {
    None: "default",
    "default": "default",
    Precision.DEFAULT: "default",
    "fast": "default",
    "high": "highest",
    Precision.HIGH: "highest",
    "highest": "highest",
    Precision.HIGHEST: "highest",
}

# Kernel modes of the packed DISCRIMINATOR stages by grade. The gate declines
# every other grade (packed_d_stage_count is 0), so None and "default" run D
# unpacked, as in the JAX package. The port's "high" is its fp32 kernels (the
# JAX package's is a 3-term bf16 split there): the closer of the two to fp32.
_PACKED_MODES_D = {
    "fast": "mid",
    "high": "high",
    Precision.HIGH: "high",
    "highest": "highest",
    Precision.HIGHEST: "highest",
}

# The fp32 kernel modes (one set of kernels and bits for both).
FP32_MODES = ("high", "highest")


def resolve_precision(precision):
    """A grade's name (or None) -> its ``Precision`` (or None); a
    ``Precision`` passes through."""
    if isinstance(precision, Precision):
        return precision
    if precision not in _PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {tuple(_PRECISIONS)}")
    return _PRECISIONS[precision]


def tf32_allowed(precision) -> bool:
    """Whether cuDNN's convs and cuBLAS's matmuls may take TF32 at this grade:
    at None and "default" (see ``_PRECISIONS``)."""
    return resolve_precision(precision) in (None, Precision.DEFAULT)


@contextlib.contextmanager
def precision_scope(precision):
    """Inside, ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` are set for the grade
    ``precision`` (``tf32_allowed``); on exit both are restored, so a grade
    holds for one call and no longer. A backward that autograd runs after the
    forward has returned must run inside the same scope (the train steps do)."""
    allow = tf32_allowed(precision)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# Kernel modes of the differentiable packed paths (the train step's
# ``packed_train_mode``) and of every kernel: one bf16 pass ("default", the
# JAX package's training default), the 2-term split "mid" and the fp32
# kernels; the backward runs at the forward's mode (ops/packed_vjp.py).
TRAIN_MODES = ("default", "mid", *FP32_MODES)


def require_train_mode(packed_mode) -> None:
    """``packed_mode`` (the differentiable packed path's kernel grade, the
    train step's ``packed_train_mode``): None or one of ``TRAIN_MODES``."""
    if packed_mode is not None and packed_mode not in TRAIN_MODES:
        raise ValueError(f"packed_mode {packed_mode!r} is not one of {TRAIN_MODES}")


def _block_fn(fn, remat: bool):
    """``fn`` or, with ``remat``, ``fn`` under activation checkpointing."""
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# equalized-LR primitives
# ---------------------------------------------------------------------------

def _he_scale(fan_in: int, gain: float = math.sqrt(2.0)) -> float:
    return gain / math.sqrt(fan_in)


def eq_scaled_conv_w(pr: dict) -> torch.Tensor:
    """Equalized-LR conv weights with the He scale baked in — the weight
    operand of the late-stage kernels. OIHW: fan-in is Cin*kh*kw, axes 1-3."""
    w = pr["w"]
    return w * _he_scale(w.shape[1] * w.shape[2] * w.shape[3])


def eq_conv(params: dict, x: torch.Tensor,
            gain: float = math.sqrt(2.0)) -> torch.Tensor:
    """3x3/1x1 SAME conv with runtime He scaling (equalized LR), NCHW."""
    w = params["w"]
    scale = _he_scale(w.shape[1] * w.shape[2] * w.shape[3], gain)
    out = F.conv2d(x, (w * scale).to(x.dtype), padding=w.shape[2] // 2)
    return out + params["b"].to(x.dtype)[:, None, None]


def eq_dense(params: dict, x: torch.Tensor,
             gain: float = math.sqrt(2.0)) -> torch.Tensor:
    w = params["w"]
    return x @ (w * _he_scale(w.shape[0], gain)).to(x.dtype) + params["b"].to(x.dtype)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=LRELU_SLOPE)


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    """Normalize each pixel's feature vector over dim 1 (channels of NCHW,
    features of [B, L]): x / sqrt(mean(x^2) + eps)."""
    return x * torch.rsqrt(torch.mean(x * x, dim=1, keepdim=True) + _PIXELNORM_EPS)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W] nearest-neighbor. Written as a
    broadcast, whose backward is a plain sum: ``repeat_interleave``'s is an
    ``index_add_`` with atomics on the card, and its bits change from run to
    run."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


def blend(prev: torch.Tensor, x: torch.Tensor, alpha) -> torch.Tensor:
    """The progressive fade-in ``prev + alpha * (x - prev)`` with ``alpha``
    rounded to ``x``'s dtype first, as the JAX package rounds it (a bf16
    step blends with bf16(alpha); fp32 is unchanged)."""
    return prev + torch.as_tensor(alpha, dtype=x.dtype) * (x - prev)


def downsample_avg_2x(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, H/2, W/2] 2x2 mean pool."""
    return F.avg_pool2d(x, 2)


def to_uint8(rgb: torch.Tensor) -> torch.Tensor:
    """tanh -> [0,255] denorm -> round (half to even, as jnp.round) -> clip
    -> uint8. Elementwise, so any layout."""
    x = (torch.tanh(rgb.float()) + 1.0) * 127.5
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Generator
# ---------------------------------------------------------------------------

def init_generator(config: ProGANConfig,
                   generator: torch.Generator | int = 0) -> dict:
    """Params: base dense + per-stage double-conv blocks + per-stage toRGB,
    weights ~N(0,1) from ``generator`` (or a seed), biases 0, on the CPU.
    The bits differ from the JAX package's ``jax.random`` init."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)

    def conv(kh, kw, cin, cout):
        return {"w": torch.randn((cout, cin, kh, kw), generator=generator),
                "b": torch.zeros(cout)}

    n = config.num_stages
    nf = config.nf
    return {
        "base_dense": {
            "w": torch.randn((config.latent_dim, nf(0) * 16), generator=generator),
            "b": torch.zeros(nf(0) * 16),
        },
        "base_conv": conv(3, 3, nf(0), nf(0)),
        "blocks": [
            {"conv1": conv(3, 3, nf(s - 1), nf(s)), "conv2": conv(3, 3, nf(s), nf(s))}
            for s in range(1, n)
        ],
        "to_rgb": [conv(1, 1, nf(s), config.num_channels) for s in range(n)],
    }


def _g_base(params: dict, z: torch.Tensor, config: ProGANConfig,
            dtype=torch.float32) -> torch.Tensor:
    z = pixel_norm(z.to(dtype))
    x = eq_dense(params["base_dense"], z)
    # The dense output is (4, 4, nf0) HWC in the JAX layout: reshape the same
    # way, then move channels first.
    x = x.reshape(z.shape[0], 4, 4, config.nf(0)).permute(0, 3, 1, 2).contiguous()
    x = pixel_norm(lrelu(x))
    return pixel_norm(lrelu(eq_conv(params["base_conv"], x)))


def _fuse_upsample_enabled() -> bool:
    """``PROBGAN_FUSE_UPCONV=0`` turns the fused upsample-into-conv of the
    stage blocks off, as in the JAX package. Read at each call."""
    return os.environ.get("PROBGAN_FUSE_UPCONV", "1") != "0"


def _fused_uint8_enabled() -> bool:
    """``PROBGAN_FUSED_UINT8=0`` makes the packed ``generator_apply`` emit
    fp32 RGB and denorm it with ``to_uint8``, as in the JAX package; the
    bytes are the fused epilogue's either way. Read at each call."""
    return os.environ.get("PROBGAN_FUSED_UINT8", "1") != "0"


def _g_block(block: dict, x: torch.Tensor) -> torch.Tensor:
    c1 = block["conv1"]
    if _fuse_upsample_enabled():
        # Fused upsample-into-conv (ops/fused_upconv.py): four parity convs
        # with pre-summed taps (summed in fp32, then cast to x's dtype); exact
        # up to float reassociation.
        x = upsample2x_conv3x3(eq_scaled_conv_w(c1), c1["b"], x)
    else:
        x = eq_conv(c1, upsample_nearest_2x(x))
    x = pixel_norm(lrelu(x))
    return pixel_norm(lrelu(eq_conv(block["conv2"], x)))


def generator_features(params: dict, z: torch.Tensor, config: ProGANConfig,
                       stage: int, dtype=torch.float32, precision=None,
                       remat: bool = False,
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Run the trunk to ``stage``; returns (x_stage, x_prev_or_None), NCHW,
    in ``dtype``. ``remat=True`` checkpoints each stage block (see the module
    docstring)."""
    with precision_scope(precision):
        block_fn = _block_fn(_g_block, remat)
        x = _g_base(params, z, config, dtype)
        prev = None
        for s in range(1, stage + 1):
            prev = x
            x = block_fn(params["blocks"][s - 1], x)
        return x, prev


def packed_start_stage(config: ProGANConfig, stage: int) -> int | None:
    """First stage the late-stage kernels (ops/packed.py) take over, or None:
    the trailing run of stages with nf <= 64, entered no earlier than stage 6.
    The same gate as the JAX package, so at 1024² exactly stages 7-8 run on
    the kernels."""
    s_min = stage
    while s_min >= 1 and config.nf(s_min) <= 64:
        s_min -= 1
    s_min += 1
    s0 = max(s_min, 6)
    if s0 > stage:
        return None
    return s0


def _rgb_w(p: dict) -> torch.Tensor:
    """toRGB 1x1 conv (gain 1) as a [3, C] matrix, eq-LR scaled."""
    w = p["w"]
    return (w * _he_scale(w.shape[1], gain=1.0)).reshape(w.shape[0], w.shape[1])


def _g_late_packed(params: dict, x_entry: torch.Tensor, config: ProGANConfig,
                   s0: int, stage: int, alpha, precision,
                   emit: str = "rgb") -> torch.Tensor:
    """Run stages [s0, stage] on the late-stage kernels and return the
    blended RGB in NHWC: fp32 pre-tanh (emit="rgb") or uint8 (emit="uint8").
    The final stage's conv1 also emits toRGB of its input, and its conv2
    fuses toRGB, the blend and the denorm, so its features never reach
    device memory. Forward-only.

    The kernels' mode is ``_PACKED_MODES[precision]``; a "base+final" mode
    runs the non-final stages in ``base`` and the final one in ``final``.

    ``PROBGAN_STAGE_FUSED=1`` runs ONE kernel per stage instead of two:
    ``packed_upconv_conv`` for a non-final stage and ``packed_upconv_conv_rgb``
    for the final one (alone when s0 == stage), so conv1's feature map never
    reaches device memory either; the bits are the two-kernel path's. The
    variable is read at each call (the JAX package reads it once, when the
    function is traced). The two-kernel path stays the default, as in JAX.
    The fused kernels take each stage's mode as the pair does. On the card
    they take stages of 8, 16, 32 or 64 channels from C % 8 == 0: any other
    width raises before the first launch (ROADMAP.md, B.a.2.4), where the
    two-kernel path (and the packed train step) takes any width up to 64."""
    from probgan_tpu_torch.ops import packed as pk

    mode = _PACKED_MODES[precision]
    base_mode, final_mode = mode.split("+") if "+" in mode else (mode, mode)
    stage_fused = os.environ.get("PROBGAN_STAGE_FUSED", "0") == "1"
    if stage_fused:
        pk.check_stage_widths("PROBGAN_STAGE_FUSED=1", x_entry,
                              [(config.nf(s - 1), config.nf(s)) for s in range(s0, stage + 1)])
    x = x_entry.float().contiguous()
    for s in range(s0, stage + 1):
        m = final_mode if s == stage else base_mode
        block = params["blocks"][s - 1]
        c1, c2 = block["conv1"], block["conv2"]
        w1, w2 = eq_scaled_conv_w(c1), eq_scaled_conv_w(c2)
        if s == stage:
            prev_rgb, to_rgb = params["to_rgb"][s - 1], params["to_rgb"][s]
            if stage_fused:
                return pk.packed_upconv_conv_rgb(
                    x, w1, c1["b"], w2, c2["b"], _rgb_w(to_rgb), to_rgb["b"],
                    _rgb_w(prev_rgb), prev_rgb["b"], alpha, emit_uint8=emit == "uint8",
                    mode=m)
            feats, rgb_prev = pk.packed_upconv(x, w1, c1["b"], rgb_w=_rgb_w(prev_rgb),
                                               rgb_b=prev_rgb["b"], mode=m)
            return pk.packed_conv_rgb(feats, w2, c2["b"], _rgb_w(to_rgb), to_rgb["b"],
                                      rgb_prev, alpha, emit_uint8=emit == "uint8", mode=m)
        if stage_fused:
            x = pk.packed_upconv_conv(x, w1, c1["b"], w2, c2["b"], mode=m)
        else:
            x = pk.packed_conv(pk.packed_upconv(x, w1, c1["b"], mode=m), w2, c2["b"],
                               mode=m)
    raise AssertionError("unreachable")


def _g_rgb_packed_train(params: dict, z: torch.Tensor, config: ProGANConfig,
                        s0: int, stage: int, alpha, dtype, mode: str,
                        remat: bool) -> torch.Tensor:
    """Differentiable packed generator: stages [s0, stage] run on the kernels
    through ops/packed_vjp.py (``upconv_lrelu_norm`` / ``conv_lrelu_norm``) at
    kernel ``mode``, forward and backward. The trunk before them runs at
    ``dtype``; the kernels take its features as fp32 and their output is
    cast back to ``dtype`` for toRGB and the progressive blend, which stay
    torch ops (1x1 convs to 3 channels), as in the JAX package. The grade of
    the unpacked convs is the caller's ``precision_scope``. The Functions
    save only their inputs and recompute activations in the backward, so the
    packed stages take no checkpointing. On the card the kernels, forward
    and backward, take every stage width the packed gate admits (up to 64
    channels)."""
    from probgan_tpu_torch.ops import packed_vjp

    block_fn = _block_fn(_g_block, remat)
    x = _g_base(params, z, config, dtype)
    for s in range(1, s0):
        x = block_fn(params["blocks"][s - 1], x)
    x = x.float()
    prev = x  # stage s0-1 features, the blend's operand when s0 == stage
    for s in range(s0, stage + 1):
        if s == stage:
            prev = x
        block = params["blocks"][s - 1]
        c1, c2 = block["conv1"], block["conv2"]
        x = packed_vjp.upconv_lrelu_norm(x, eq_scaled_conv_w(c1), c1["b"], mode)
        x = packed_vjp.conv_lrelu_norm(x, eq_scaled_conv_w(c2), c2["b"], mode)
    rgb = eq_conv(params["to_rgb"][stage], x.to(dtype), gain=1.0)
    rgb_prev = upsample_nearest_2x(eq_conv(params["to_rgb"][stage - 1], prev.to(dtype),
                                           gain=1.0))
    return blend(rgb_prev, rgb, alpha).permute(0, 2, 3, 1).contiguous()


def generator_rgb(params: dict, z: torch.Tensor, config: ProGANConfig,
                  stage: int, alpha: float = 1.0, dtype=torch.float32,
                  precision=None, remat: bool = False, packed: bool = False,
                  packed_mode: str | None = None) -> torch.Tensor:
    """Latent [B, L] -> pre-tanh RGB [B, R, R, 3] (NHWC) at resolution
    ``4 * 2**stage`` with progressive alpha blend:
    lerp(upsample(toRGB_{s-1}(x_{s-1})), toRGB_s(x_s), alpha).

    ``packed=True`` routes the eligible late stages (packed_start_stage)
    through ops/packed.py at the kernel mode of ``_PACKED_MODES[precision]``:
    the kernels for CUDA tensors, their plain twins for CPU tensors; fp32
    ``dtype`` only (bf16 takes the unpacked path). That path is forward-only:
    on the card it raises when a gradient is wanted. ``packed_mode`` (one of
    ``TRAIN_MODES``) instead selects the DIFFERENTIABLE packed path
    (``_g_rgb_packed_train``) at that kernel mode, at any ``dtype``: the train
    step's configuration.
    ``precision``: the grade (see ``_PRECISIONS``). ``remat``: see
    ``generator_features``."""
    require_train_mode(packed_mode)
    with precision_scope(precision):
        if packed_mode is not None and stage > 0:
            s0 = packed_start_stage(config, stage)
            if s0 is not None:
                return _g_rgb_packed_train(params, z, config, s0, stage, alpha, dtype,
                                           packed_mode, remat)
        s0 = packed_start_stage(config, stage) if packed and dtype == torch.float32 else None
        if s0 is not None:
            x = _g_trunk(params, z, config, s0)
            return _g_late_packed(params, x, config, s0, stage, alpha, precision)
        x, prev = generator_features(params, z, config, stage, dtype, precision, remat)
        rgb = eq_conv(params["to_rgb"][stage], x, gain=1.0)
        if stage > 0:
            rgb_prev = upsample_nearest_2x(
                eq_conv(params["to_rgb"][stage - 1], prev, gain=1.0)
            )
            rgb = blend(rgb_prev, rgb, alpha)
        return rgb.permute(0, 2, 3, 1).contiguous()


def _g_trunk(params: dict, z: torch.Tensor, config: ProGANConfig, s0: int) -> torch.Tensor:
    """fp32 features of stage s0 - 1, the packed path's entry."""
    x = _g_base(params, z, config)
    for s in range(1, s0):
        x = _g_block(params["blocks"][s - 1], x)
    return x


def generator_apply(params: dict, z: torch.Tensor, config: ProGANConfig,
                    stage: int, alpha: float = 1.0, dtype=torch.float32,
                    precision=None, packed: bool = False) -> torch.Tensor:
    """Full image path: latent [B, L] -> uint8 image [B, R, R, 3] (NHWC). On
    the packed path (fp32 ``dtype`` only) the denorm is fused into the final
    kernel unless ``PROBGAN_FUSED_UINT8=0``."""
    with precision_scope(precision):
        s0 = None
        if packed and dtype == torch.float32 and _fused_uint8_enabled():
            s0 = packed_start_stage(config, stage)
        if s0 is not None:
            x = _g_trunk(params, z, config, s0)
            return _g_late_packed(params, x, config, s0, stage, alpha, precision,
                                  emit="uint8")
        return to_uint8(generator_rgb(params, z, config, stage, alpha, dtype, precision,
                                      packed=packed))


# ---------------------------------------------------------------------------
# Discriminator
# ---------------------------------------------------------------------------

def init_discriminator(config: ProGANConfig,
                       generator: torch.Generator | int = 0) -> dict:
    """Params: per-stage fromRGB + per-stage double-conv blocks + the final
    4x4 block (its conv takes one more channel, the minibatch stddev) + two
    dense layers; weights ~N(0,1) from ``generator`` (or a seed), biases 0, on
    the CPU. The bits differ from the JAX package's ``jax.random`` init."""
    if isinstance(generator, int):
        generator = torch.Generator().manual_seed(generator)

    def conv(kh, kw, cin, cout):
        return {"w": torch.randn((cout, cin, kh, kw), generator=generator),
                "b": torch.zeros(cout)}

    def dense(fin, fout):
        return {"w": torch.randn((fin, fout), generator=generator),
                "b": torch.zeros(fout)}

    n = config.num_stages
    nf = config.nf
    return {
        "from_rgb": [conv(1, 1, config.num_channels, nf(s)) for s in range(n)],
        "blocks": [
            {"conv1": conv(3, 3, nf(s), nf(s)), "conv2": conv(3, 3, nf(s), nf(s - 1))}
            for s in range(1, n)
        ],
        "final_conv": conv(3, 3, nf(0) + 1, nf(0)),
        "final_dense": dense(nf(0) * 16, nf(0)),
        "out_dense": dense(nf(0), 1),
    }


class _MeanOverRanks(torch.autograd.Function):
    """The mean of a tensor over the ranks of a process group (a sum
    all-reduce over the group, then / its size: JAX's ``pmean``), on every
    rank. Its backward is the same mean of the cotangents, through this
    Function again, so a second-order use (the R1 penalty's gradient of a
    gradient) differentiates it too. Every rank must run the forward and
    the backward of the same graph, in the same order."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _MeanOverRanks.apply(grad, ctx.group), None


def minibatch_stddev(x: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Append one channel (NCHW: at dim 1) holding the batch-wide mean
    feature stddev. A batch statistic: the logits of a batch are not those of
    its images scored one by one.

    ``axis_name``: the process group over which the batch is split (each
    rank holds an equal share), or None. With a group, the mean over the
    whole batch is taken first, then the variance about it, each averaged
    over the ranks in JAX's order: the one-process statistics up to the
    order of float sums, and differentiable (``_MeanOverRanks``)."""
    mean = x.mean(dim=0, keepdim=True)
    if axis_name is not None:
        mean = _MeanOverRanks.apply(mean, axis_name)
    var = torch.square(x - mean).mean(dim=0, keepdim=True)
    if axis_name is not None:
        var = _MeanOverRanks.apply(var, axis_name)
    stddev = torch.sqrt(var + 1e-8).mean()
    feat = stddev.expand(x.shape[0], 1, x.shape[2], x.shape[3])
    return torch.cat([x, feat], dim=1)


def _d_block(block: dict, x: torch.Tensor) -> torch.Tensor:
    x = lrelu(eq_conv(block["conv1"], x))
    x = lrelu(eq_conv(block["conv2"], x))
    return downsample_avg_2x(x)


def packed_d_stage_count(config: ProGANConfig, stage: int,
                         precision="highest") -> int:
    """Number of leading discriminator stages (from ``stage`` down) the
    kernels of ops/packed.py take: consecutive stages with nf <= 64 and
    8-aligned channel counts at resolutions >= 256. 0 = none (always 0 for a
    precision outside ``_PACKED_MODES_D``: None and "default"). The same gate
    as the JAX package, so at 1024² exactly stages 8 and 7 run on the
    kernels."""
    if precision not in _PACKED_MODES_D:
        return 0
    n = 0
    s = stage
    while (
        s >= 1
        and config.nf(s) <= 64
        and config.nf(s) % 8 == 0
        and config.nf(s - 1) % 8 == 0
        and stage_resolution(s) >= 256
    ):
        n += 1
        s -= 1
    return n


def _from_rgb(params: dict, image: torch.Tensor, stage: int) -> torch.Tensor:
    return lrelu(eq_conv(params["from_rgb"][stage], image))


def _d_early_packed(params: dict, image: torch.Tensor, stage: int, alpha,
                    n: int, mode: str) -> torch.Tensor:
    """fromRGB + the first ``n`` discriminator blocks on the kernels of
    ops/packed.py (conv1: ``packed_conv`` with the "lrelu" epilogue; conv2
    and the pool: ``packed_convpool``, whose full-resolution output never
    reaches device memory), through their differentiable forms in
    ops/packed_vjp.py: this path serves scoring and the train step's
    discriminator, forward and backward. ``image`` is NCHW; returns NCHW
    features at stage ``stage - n``. The progressive blend sits after the
    first block, as in the unpacked loop. ``mode``: the kernels' grade, one
    of ``TRAIN_MODES`` ("high" and "highest" run the same fp32 kernels, "mid"
    the 2-term split of the "fast" grade, "default" one bf16 pass). The
    kernels take fromRGB's output as fp32 and return fp32 (the blend with
    the skip runs in fp32), whatever the image's dtype."""
    from probgan_tpu_torch.ops import packed_vjp

    x = _from_rgb(params, image, stage).float().contiguous()
    for s in range(stage, stage - n, -1):
        block = params["blocks"][s - 1]
        c1, c2 = block["conv1"], block["conv2"]
        x = packed_vjp.conv_lrelu(x, eq_scaled_conv_w(c1), c1["b"], mode)
        x = packed_vjp.convpool_lrelu(x, eq_scaled_conv_w(c2), c2["b"], mode)
        if s == stage and stage > 0:
            skip = _from_rgb(params, downsample_avg_2x(image), stage - 1)
            x = skip + alpha * (x - skip)
    return x


def discriminator_apply(params: dict, image: torch.Tensor, config: ProGANConfig,
                        stage: int, alpha: float = 1.0, dtype=torch.float32,
                        precision=None, remat: bool = False, packed: bool = False,
                        stddev_axis=None,
                        packed_mode: str | None = None) -> torch.Tensor:
    """Image [B, R, R, 3] (NHWC float, roughly [-1, 1]) -> realness logit
    [B], in ``dtype``. Mirrors the generator's progressive blend: after the
    first down block, lerp with fromRGB of the downsampled image.

    ``packed=True`` (fp32 ``dtype``) routes the leading stages
    (packed_d_stage_count) through ops/packed.py at the kernel mode of
    ``_PACKED_MODES_D[precision]``: the kernels for CUDA tensors, their plain
    twins for CPU tensors; the path is differentiable (ops/packed_vjp.py). The
    gate declines None and "default" (D runs unpacked, as in the JAX
    package); "fast" maps to mode "mid". ``packed_mode`` (one of
    ``TRAIN_MODES``; the train step passes it) makes the packed gate a matter
    of shapes alone, at any ``dtype``: the kernels' fp32 output is cast back
    to ``dtype`` for the stages after them, as in the JAX package.
    ``remat``: see ``generator_features``. ``stddev_axis``: the process
    group over which the batch is split (``minibatch_stddev``'s
    ``axis_name``), or None."""
    require_train_mode(packed_mode)
    with precision_scope(precision):
        image = image.to(dtype).permute(0, 3, 1, 2).contiguous()
        n, mode = 0, packed_mode
        if packed and packed_mode is not None:
            # Structure-only gate: which stages the kernels take is a property
            # of the shapes, not of the precision.
            n = packed_d_stage_count(config, stage, "highest")
        elif packed and dtype == torch.float32:
            n = packed_d_stage_count(config, stage, precision)
            mode = _PACKED_MODES_D.get(precision)
        block_fn = _block_fn(_d_block, remat)
        if n > 0:
            x = _d_early_packed(params, image, stage, alpha, n, mode).to(dtype)
        else:
            x = _from_rgb(params, image, stage)
        for s in range(stage - n, 0, -1):
            x = block_fn(params["blocks"][s - 1], x)
            if s == stage and stage > 0:
                skip = _from_rgb(params, downsample_avg_2x(image), stage - 1)
                x = blend(skip, x, alpha)
        x = minibatch_stddev(x, axis_name=stddev_axis)
        x = lrelu(eq_conv(params["final_conv"], x))
        # final_dense's rows are in the JAX layout: the 4x4 map flattened as HWC
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = lrelu(eq_dense(params["final_dense"], x))
        return eq_dense(params["out_dense"], x, gain=1.0)[..., 0]
