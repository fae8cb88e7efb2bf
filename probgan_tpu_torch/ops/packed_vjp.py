"""The late-stage conv kernels with a backward: training on the kernels.

The port of ``probgan_tpu/ops/packed_vjp.py``. The forward kernels of
``ops/packed.py`` record no autograd graph; here each is a
``torch.autograd.Function`` on dense NCHW fp32 tensors whose backward is
composed from the same kernels, because both backward convs of a 3x3 SAME
conv are 3x3 SAME convs:

- the input gradient is the conv of the cotangent with the spatially flipped,
  channel-transposed weights: ``packed_conv(..., epilogue="none")``;
- the weight gradient is the input x cotangent correlation:
  ``packed_conv_wgrad``;
- LeakyReLU's mask comes from the saved OUTPUT's sign (lrelu keeps the sign),
  so ``conv_lrelu`` stores no pre-activation;
- the 2x2 mean pool's transpose is a nearest-2x upsample times 1/4;
- ``convpool_lrelu`` never wrote its full-resolution pre-activation, so its
  backward recomputes the mask with one ``epilogue="lrelu"`` forward at the
  forward's mode: the kernel whose sums equal the forward's bit for bit (at
  the fp32 modes, the 3xTF32 "none" kernel differs from them by ~1e-6 and would flip the mask of
  pre-activations that close to zero: 7 to 15 a call at the 1024² train
  step's shapes, each moving dx by ~0.8 |g w|);
- PixelNorm's backward needs its INPUT: ``conv_lrelu_norm`` and
  ``upconv_lrelu_norm`` save only (x, w, b) and recompute the post-lrelu,
  pre-norm tensor with one norm-free forward. Recovering it from the normed
  output divides by (1 - mean(y^2)) ~ eps / (m + eps): catastrophic fp32
  cancellation;
- the fused upsample + conv's input gradient is the transposed conv
  SUM-pooled 2x2, which is 4 x ``packed_convpool`` with the "none" epilogue;
  its weight gradient correlates the transiently upsampled input with the
  cotangent.

Every Function takes the kernels' ``mode`` ("default", the default as in the
JAX package: one bf16 pass; "mid", "high" or "highest") and runs its
forward, every recompute and every input gradient at it, as the reference's
custom VJPs do: a mask recomputed at another mode than the forward's would
flip the signs of pre-activations near zero. ``packed_conv_wgrad`` takes the
mode too: one bf16 pass at "default", its fp32 kernel at the others (the
reference promotes its split modes to HIGHEST). At "default" and "mid" the
recompute is ``packed_conv`` "lrelu" at that mode, whose sums equal the
forward's ``packed_convpool`` at the same mode bit for bit (one order of sums
in both kernels).

The bias gradient and the elementwise masks are torch ops. ``backward`` honours
``ctx.needs_input_grad``: no wgrad launch where the weights need no gradient
(the generator step through the discriminator), no dgrad launch for an input
that needs none. Like a ``jax.custom_vjp``, a backward here is not itself
differentiable (``once_differentiable``): second-order terms such as the R1
penalty go through the unpacked path.

The wrappers of ``ops/packed.py`` are looked up at call time, so on CPU
tensors forward and backward run the plain twins through the same formulas,
and on CUDA tensors they launch the kernels or raise.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from probgan_tpu_torch.models.pro_gan import (
    _PIXELNORM_EPS,
    LRELU_SLOPE,
    upsample_nearest_2x,
)
from probgan_tpu_torch.ops import packed as pk


def _flip_w(w: torch.Tensor) -> torch.Tensor:
    """OIHW [Cout, Cin, 3, 3] -> the dgrad weights [Cin, Cout, 3, 3]: spatial
    flip + channel transpose (the transpose of a stride-1 SAME conv)."""
    return w.flip(2, 3).transpose(0, 1)


def _lrelu_bwd(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cotangent through lrelu given its OUTPUT y: lrelu keeps the sign
    (y >= 0 iff pre >= 0, the kernel's ``v >= 0`` branch)."""
    return torch.where(y >= 0, g, LRELU_SLOPE * g)


def _pixelnorm_bwd(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cotangent through PixelNorm given its INPUT u (post-lrelu, channels on
    dim 1): y = u*r with r = rsqrt(mean_c(u^2) + eps), so
    du = r * (g - u * r^2 * mean_c(g*u))."""
    r = torch.rsqrt(torch.mean(u * u, dim=1, keepdim=True) + _PIXELNORM_EPS)
    return r * (g - u * (r * r) * torch.mean(g * u, dim=1, keepdim=True))


def _unpool_quarter(g: torch.Tensor) -> torch.Tensor:
    """Transpose of the 2x2 mean pool: [B, C, H/2, W/2] -> [B, C, H, W], each
    cell's cotangent spread evenly over its 2x2 source window."""
    return upsample_nearest_2x(g) * 0.25


def _zero_bias(w: torch.Tensor) -> torch.Tensor:
    return torch.zeros(w.shape[1], device=w.device, dtype=w.dtype)


def _conv_grads(ctx, x, w, dpre, mode: str, pooled_dx: bool = False):
    """(dx, dw, db, None) of a conv3x3 SAME + bias with input ``x``, weights
    ``w`` and pre-activation cotangent ``dpre``, each only where it is needed,
    the input gradient at kernel ``mode`` (the trailing None: the mode's).
    ``pooled_dx``: the conv read the nearest-2x upsample of the Function's
    input, so dx is the 2x2 SUM pool of the transposed conv."""
    need_x, need_w, need_b = ctx.needs_input_grad[:3]
    dpre = dpre.contiguous()
    dx = dw = db = None
    if need_x:
        if pooled_dx:
            dx = 4.0 * pk.packed_convpool(dpre, _flip_w(w), _zero_bias(w), epilogue="none",
                                          mode=mode)
        else:
            dx = pk.packed_conv(dpre, _flip_w(w), _zero_bias(w), epilogue="none", mode=mode)
    if need_w:
        dw = pk.packed_conv_wgrad(upsample_nearest_2x(x) if pooled_dx else x, dpre, mode=mode)
    if need_b:
        db = dpre.sum(dim=(0, 2, 3))
    return dx, dw, db, None


class _ConvLrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, mode):
        x = x.contiguous()
        y = pk.packed_conv(x, w, b, epilogue="lrelu", mode=mode)
        ctx.save_for_backward(x, w, y)
        ctx.mode = mode
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        return _conv_grads(ctx, x, w, _lrelu_bwd(y, g), ctx.mode)


class _ConvPoolLrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, mode):
        x = x.contiguous()
        ctx.save_for_backward(x, w, b)
        ctx.mode = mode
        return pk.packed_convpool(x, w, b, epilogue="lrelu", mode=mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        # The fused kernel never wrote the full-resolution pre-activation:
        # recompute its lrelu (the same sign) in the forward's own sums.
        u = pk.packed_conv(x, w, b, epilogue="lrelu", mode=ctx.mode)
        return _conv_grads(ctx, x, w, _lrelu_bwd(u, _unpool_quarter(g)), ctx.mode)


class _ConvLreluNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, mode):
        x = x.contiguous()
        ctx.save_for_backward(x, w, b)
        ctx.mode = mode
        return pk.packed_conv(x, w, b, epilogue="lrelu_norm", mode=mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        # the post-lrelu, pre-norm tensor; its sign is also the lrelu mask
        u = pk.packed_conv(x, w, b, epilogue="lrelu", mode=ctx.mode)
        return _conv_grads(ctx, x, w, _lrelu_bwd(u, _pixelnorm_bwd(u, g)), ctx.mode)


class _UpconvLreluNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, mode):
        x = x.contiguous()
        ctx.save_for_backward(x, w, b)
        ctx.mode = mode
        return pk.packed_upconv(x, w, b, mode=mode)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        u = pk.packed_upconv(x, w, b, epilogue="lrelu", mode=ctx.mode)
        return _conv_grads(ctx, x, w, _lrelu_bwd(u, _pixelnorm_bwd(u, g)), ctx.mode,
                           pooled_dx=True)


def conv_lrelu(x, w, b, mode="default"):
    """Differentiable ``packed_conv(..., epilogue="lrelu")``: x [B, C, H, W]
    fp32, w [Cout, C, 3, 3] eq-LR scaled, b [Cout] -> [B, Cout, H, W], at
    kernel ``mode`` ("default" one bf16 pass, "mid", or "highest"/"high"
    fp32). A test aid as ``mode`` raises before any kernel runs."""
    pk.check_mode("conv_lrelu", mode)
    return _ConvLrelu.apply(x, w, b, mode)


def convpool_lrelu(x, w, b, mode="default"):
    """Differentiable ``packed_convpool``: -> [B, Cout, H/2, W/2]."""
    pk.check_mode("convpool_lrelu", mode)
    return _ConvPoolLrelu.apply(x, w, b, mode)


def conv_lrelu_norm(x, w, b, mode="default"):
    """Differentiable ``packed_conv(..., epilogue="lrelu_norm")`` (the
    generator block's second conv): -> [B, Cout, H, W]."""
    pk.check_mode("conv_lrelu_norm", mode)
    return _ConvLreluNorm.apply(x, w, b, mode)


def upconv_lrelu_norm(x, w, b, mode="default"):
    """Differentiable ``packed_upconv`` (nearest-2x upsample + conv3x3 + bias
    + LeakyReLU + PixelNorm, the generator block's first conv):
    -> [B, Cout, 2H, 2W]."""
    pk.check_mode("upconv_lrelu_norm", mode)
    return _UpconvLreluNorm.apply(x, w, b, mode)
