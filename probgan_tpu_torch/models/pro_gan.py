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
logits ``[B]``. Of the training-only arguments of the JAX functions,
``remat`` and ``packed_mode`` are ported; ``stddev_axis`` (a batch sharded
over a mesh) is not.

Precision grades: "high" and "highest" both mean fp32 with TF32 off
(``_require_fp32_grade``). The bf16 grades (None, "default", "fast") need a
bf16 kernel grade the port does not have yet and raise NotImplementedError;
so do the bf16 kernel grades "default" and "mid" of ``packed_mode``.

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

import dataclasses
import math
import os

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from probgan_tpu_torch.ops.fused_upconv import upsample2x_conv3x3

LRELU_SLOPE = 0.2
_PIXELNORM_EPS = 1e-8
_FP32_GRADES = ("high", "highest")


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


def _require_fp32_grade(precision) -> None:
    """Accept the fp32 grades and pin both TF32 switches off, process-wide.
    cuDNN convolutions default to TF32 (``torch.backends.cudnn.allow_tf32``
    is True), which keeps ~3 decimal digits and would silently drop parity
    with the fp32 reference; matmuls default to fp32 but are pinned too."""
    if precision not in _FP32_GRADES:
        raise NotImplementedError(
            f"precision grade {precision!r} needs a bf16 kernel grade, which "
            f"the port does not have yet; use one of {_FP32_GRADES}"
        )
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _require_fp32_packed_mode(packed_mode) -> None:
    """``packed_mode`` names the kernel grade of the differentiable packed
    path. The port's kernels have one grade, fp32, which serves "high" and
    "highest"; the JAX package's "default" and "mid" are bf16 grades."""
    if packed_mode is not None and packed_mode not in _FP32_GRADES:
        raise NotImplementedError(
            f"packed_mode {packed_mode!r} needs a bf16 kernel grade, which the "
            f"port does not have yet (ROADMAP \"Next, in order\": the bf16 / "
            f"TF32 grades); use one of {_FP32_GRADES}"
        )


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
    out = F.conv2d(x, w * scale, padding=w.shape[2] // 2)
    return out + params["b"][:, None, None]


def eq_dense(params: dict, x: torch.Tensor,
             gain: float = math.sqrt(2.0)) -> torch.Tensor:
    w = params["w"]
    return x @ (w * _he_scale(w.shape[0], gain)) + params["b"]


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


def _g_base(params: dict, z: torch.Tensor, config: ProGANConfig) -> torch.Tensor:
    z = pixel_norm(z.float())
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
        # with pre-summed taps; exact up to float reassociation.
        x = upsample2x_conv3x3(eq_scaled_conv_w(c1), c1["b"], x)
    else:
        x = eq_conv(c1, upsample_nearest_2x(x))
    x = pixel_norm(lrelu(x))
    return pixel_norm(lrelu(eq_conv(block["conv2"], x)))


def generator_features(params: dict, z: torch.Tensor, config: ProGANConfig,
                       stage: int, remat: bool = False,
                       ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Run the trunk to ``stage``; returns (x_stage, x_prev_or_None), NCHW.
    ``remat=True`` checkpoints each stage block (see the module docstring)."""
    block_fn = _block_fn(_g_block, remat)
    x = _g_base(params, z, config)
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
                   s0: int, stage: int, alpha, emit: str = "rgb") -> torch.Tensor:
    """Run stages [s0, stage] on the late-stage kernels and return the
    blended RGB in NHWC: fp32 pre-tanh (emit="rgb") or uint8 (emit="uint8").
    The final stage's conv1 also emits toRGB of its input, and its conv2
    fuses toRGB, the blend and the denorm, so its features never reach
    device memory. Forward-only.

    ``PROBGAN_STAGE_FUSED=1`` runs ONE kernel per stage instead of two:
    ``packed_upconv_conv`` for a non-final stage and ``packed_upconv_conv_rgb``
    for the final one (alone when s0 == stage), so conv1's feature map never
    reaches device memory either; the bits are the two-kernel path's. The
    variable is read at each call (the JAX package reads it once, when the
    function is traced). The two-kernel path stays the default, as in JAX."""
    from probgan_tpu_torch.ops import packed as pk

    stage_fused = os.environ.get("PROBGAN_STAGE_FUSED", "0") == "1"
    x = x_entry.float().contiguous()
    for s in range(s0, stage + 1):
        block = params["blocks"][s - 1]
        c1, c2 = block["conv1"], block["conv2"]
        w1, w2 = eq_scaled_conv_w(c1), eq_scaled_conv_w(c2)
        if s == stage:
            prev_rgb, to_rgb = params["to_rgb"][s - 1], params["to_rgb"][s]
            if stage_fused:
                return pk.packed_upconv_conv_rgb(
                    x, w1, c1["b"], w2, c2["b"], _rgb_w(to_rgb), to_rgb["b"],
                    _rgb_w(prev_rgb), prev_rgb["b"], alpha, emit_uint8=emit == "uint8")
            feats, rgb_prev = pk.packed_upconv(x, w1, c1["b"], rgb_w=_rgb_w(prev_rgb),
                                               rgb_b=prev_rgb["b"])
            return pk.packed_conv_rgb(feats, w2, c2["b"], _rgb_w(to_rgb), to_rgb["b"],
                                      rgb_prev, alpha, emit_uint8=emit == "uint8")
        if stage_fused:
            x = pk.packed_upconv_conv(x, w1, c1["b"], w2, c2["b"])
        else:
            x = pk.packed_conv(pk.packed_upconv(x, w1, c1["b"]), w2, c2["b"])
    raise AssertionError("unreachable")


def _g_rgb_packed_train(params: dict, z: torch.Tensor, config: ProGANConfig,
                        s0: int, stage: int, alpha, remat: bool) -> torch.Tensor:
    """Differentiable packed generator: stages [s0, stage] run on the kernels
    through ops/packed_vjp.py (``upconv_lrelu_norm`` / ``conv_lrelu_norm``),
    forward and backward. toRGB and the progressive blend stay torch ops (1x1
    convs to 3 channels). The Functions save only their inputs and recompute
    activations in the backward, so the packed stages take no checkpointing."""
    from probgan_tpu_torch.ops import packed_vjp

    block_fn = _block_fn(_g_block, remat)
    x = _g_base(params, z, config)
    for s in range(1, s0):
        x = block_fn(params["blocks"][s - 1], x)
    x = x.float()
    prev = x  # stage s0-1 features, the blend's operand when s0 == stage
    for s in range(s0, stage + 1):
        if s == stage:
            prev = x
        block = params["blocks"][s - 1]
        c1, c2 = block["conv1"], block["conv2"]
        x = packed_vjp.upconv_lrelu_norm(x, eq_scaled_conv_w(c1), c1["b"])
        x = packed_vjp.conv_lrelu_norm(x, eq_scaled_conv_w(c2), c2["b"])
    rgb = eq_conv(params["to_rgb"][stage], x, gain=1.0)
    rgb_prev = upsample_nearest_2x(eq_conv(params["to_rgb"][stage - 1], prev, gain=1.0))
    rgb = rgb_prev + alpha * (rgb - rgb_prev)
    return rgb.permute(0, 2, 3, 1).contiguous()


def generator_rgb(params: dict, z: torch.Tensor, config: ProGANConfig,
                  stage: int, alpha: float = 1.0, precision="high",
                  packed: bool = False, remat: bool = False,
                  packed_mode: str | None = None) -> torch.Tensor:
    """Latent [B, L] -> pre-tanh RGB [B, R, R, 3] (NHWC) at resolution
    ``4 * 2**stage`` with progressive alpha blend:
    lerp(upsample(toRGB_{s-1}(x_{s-1})), toRGB_s(x_s), alpha).

    ``packed=True`` routes the eligible late stages (packed_start_stage)
    through ops/packed.py: the kernels for CUDA tensors, their plain twins for
    CPU tensors. That path is forward-only: on the card it raises when a
    gradient is wanted. ``packed_mode`` ("high" or "highest") instead selects
    the DIFFERENTIABLE packed path (``_g_rgb_packed_train``), the train step's
    configuration. ``remat``: see ``generator_features``. ``precision``
    defaults to "high" (the JAX package's default None is a bf16 grade the
    port does not have)."""
    _require_fp32_grade(precision)
    _require_fp32_packed_mode(packed_mode)
    if packed_mode is not None and stage > 0:
        s0 = packed_start_stage(config, stage)
        if s0 is not None:
            return _g_rgb_packed_train(params, z, config, s0, stage, alpha, remat)
    s0 = packed_start_stage(config, stage) if packed else None
    if s0 is not None:
        x = _g_base(params, z, config)
        for s in range(1, s0):
            x = _g_block(params["blocks"][s - 1], x)
        return _g_late_packed(params, x, config, s0, stage, alpha)
    x, prev = generator_features(params, z, config, stage, remat)
    rgb = eq_conv(params["to_rgb"][stage], x, gain=1.0)
    if stage > 0:
        rgb_prev = upsample_nearest_2x(
            eq_conv(params["to_rgb"][stage - 1], prev, gain=1.0)
        )
        rgb = rgb_prev + alpha * (rgb - rgb_prev)
    return rgb.permute(0, 2, 3, 1).contiguous()


def generator_apply(params: dict, z: torch.Tensor, config: ProGANConfig,
                    stage: int, alpha: float = 1.0, precision="high",
                    packed: bool = False) -> torch.Tensor:
    """Full image path: latent [B, L] -> uint8 image [B, R, R, 3] (NHWC). On
    the packed path the denorm is fused into the final kernel unless
    ``PROBGAN_FUSED_UINT8=0``."""
    _require_fp32_grade(precision)
    s0 = packed_start_stage(config, stage) if packed and _fused_uint8_enabled() else None
    if s0 is not None:
        x = _g_base(params, z, config)
        for s in range(1, s0):
            x = _g_block(params["blocks"][s - 1], x)
        return _g_late_packed(params, x, config, s0, stage, alpha, emit="uint8")
    return to_uint8(generator_rgb(params, z, config, stage, alpha, precision,
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


def minibatch_stddev(x: torch.Tensor) -> torch.Tensor:
    """Append one channel (NCHW: at dim 1) holding the batch-wide mean
    feature stddev. A batch statistic: the logits of a batch are not those of
    its images scored one by one."""
    mean = x.mean(dim=0, keepdim=True)
    var = torch.square(x - mean).mean(dim=0, keepdim=True)
    stddev = torch.sqrt(var + 1e-8).mean()
    feat = stddev.expand(x.shape[0], 1, x.shape[2], x.shape[3])
    return torch.cat([x, feat], dim=1)


def _d_block(block: dict, x: torch.Tensor) -> torch.Tensor:
    x = lrelu(eq_conv(block["conv1"], x))
    x = lrelu(eq_conv(block["conv2"], x))
    return downsample_avg_2x(x)


# Precisions for which the packed discriminator path exists in the JAX
# package (its ladder maps them to kernel grades). The port's kernels have
# one grade, fp32, which serves "high" and "highest"; "fast" stays in the gate
# so that it answers as the JAX package's does.
_PACKED_MODES_D = ("fast", "high", "highest")


def packed_d_stage_count(config: ProGANConfig, stage: int,
                         precision="highest") -> int:
    """Number of leading discriminator stages (from ``stage`` down) the
    kernels of ops/packed.py take: consecutive stages with nf <= 64 and
    8-aligned channel counts at resolutions >= 256. 0 = none (always 0 for a
    precision outside ``_PACKED_MODES_D``). The same gate as the JAX package,
    so at 1024² exactly stages 8 and 7 run on the kernels."""
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
                    n: int) -> torch.Tensor:
    """fromRGB + the first ``n`` discriminator blocks on the kernels of
    ops/packed.py (conv1: ``packed_conv`` with the "lrelu" epilogue; conv2
    and the pool: ``packed_convpool``, whose full-resolution output never
    reaches device memory), through their differentiable forms in
    ops/packed_vjp.py: this path serves scoring and the train step's
    discriminator, forward and backward. ``image`` is NCHW; returns NCHW
    features at stage ``stage - n``. The progressive blend sits after the
    first block, as in the unpacked loop."""
    from probgan_tpu_torch.ops import packed_vjp

    x = _from_rgb(params, image, stage).float().contiguous()
    for s in range(stage, stage - n, -1):
        block = params["blocks"][s - 1]
        c1, c2 = block["conv1"], block["conv2"]
        x = packed_vjp.conv_lrelu(x, eq_scaled_conv_w(c1), c1["b"])
        x = packed_vjp.convpool_lrelu(x, eq_scaled_conv_w(c2), c2["b"])
        if s == stage and stage > 0:
            skip = _from_rgb(params, downsample_avg_2x(image), stage - 1)
            x = skip + alpha * (x - skip)
    return x


def discriminator_apply(params: dict, image: torch.Tensor, config: ProGANConfig,
                        stage: int, alpha: float = 1.0, precision="high",
                        packed: bool = False, remat: bool = False,
                        packed_mode: str | None = None) -> torch.Tensor:
    """Image [B, R, R, 3] (NHWC float, roughly [-1, 1]) -> realness logit
    [B]. Mirrors the generator's progressive blend: after the first down
    block, lerp with fromRGB of the downsampled image.

    ``packed=True`` routes the leading stages (packed_d_stage_count) through
    ops/packed.py: the kernels for CUDA tensors, their plain twins for CPU
    tensors; the path is differentiable (ops/packed_vjp.py). ``precision``:
    "high" or "highest", both fp32 with TF32 off (the JAX package's "high" is
    a 3-term bf16 split on this path, so the port's "high" is the closer of
    the two to the fp32 reference). ``packed_mode`` ("high" or "highest"; the
    train step passes it) makes the packed gate a matter of shapes alone.
    ``remat``: see ``generator_features``."""
    _require_fp32_grade(precision)
    _require_fp32_packed_mode(packed_mode)
    image = image.float().permute(0, 3, 1, 2).contiguous()
    n = 0
    if packed and packed_mode is not None:
        # Structure-only gate: which stages the kernels take is a property of
        # the shapes, not of the precision.
        n = packed_d_stage_count(config, stage, "highest")
    elif packed:
        n = packed_d_stage_count(config, stage, precision)
    block_fn = _block_fn(_d_block, remat)
    if n > 0:
        x = _d_early_packed(params, image, stage, alpha, n)
    else:
        x = _from_rgb(params, image, stage)
    for s in range(stage - n, 0, -1):
        x = block_fn(params["blocks"][s - 1], x)
        if s == stage and stage > 0:
            skip = _from_rgb(params, downsample_avg_2x(image), stage - 1)
            x = skip + alpha * (x - skip)
    x = minibatch_stddev(x)
    x = lrelu(eq_conv(params["final_conv"], x))
    # final_dense's rows are in the JAX layout: the 4x4 map flattened as HWC
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = lrelu(eq_dense(params["final_dense"], x))
    return eq_dense(params["out_dense"], x, gain=1.0)[..., 0]
