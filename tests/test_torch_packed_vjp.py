"""The port's training kernels (probgan_tpu_torch/ops/packed.py, packed_vjp.py)
on the CPU, where every wrapper runs its plain twin.

- ``packed_conv_wgrad_plain`` against the JAX package's Pallas kernel in
  interpret mode at mode "highest" (through ``nhwc_to_phase_blocked``, as
  tests/test_packed_vjp.py runs it) and against autograd of ``F.conv2d``:
  rtol = atol = 1e-4, the JAX test's own bound (the sums run in another
  order);
- ``packed_upconv_plain(epilogue="lrelu")`` against the JAX kernel
  (rtol = atol = 2e-5, float reassociation only);
- each of the four ``torch.autograd.Function``s: forward and (dx, dw, db)
  against ``jax.vjp`` of the JAX ``custom_vjp`` at mode "highest" and against
  autograd through the plain twin, rtol 5e-4 / atol 5e-5 (the tolerances of
  tests/test_packed_vjp.py), at mode "mid" against the JAX VJP at "mid", and
  ``torch.autograd.gradcheck`` in fp64;
- the rules around them: no wgrad or dgrad where none is asked for, no
  second derivative, and no silent zero gradient from a forward-only kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from probgan_tpu.ops import packed_vjp as jvjp
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.ops import packed as tpk
from probgan_tpu_torch.ops import packed_vjp as tvjp
from tests.test_torch_packed import TOL, _nchw, _nhwc, _oihw, _phase_blocked, _rand

VJP_TOL = dict(rtol=5e-4, atol=5e-5)


def _hwio(w_oihw: torch.Tensor) -> np.ndarray:
    return w_oihw.detach().numpy().transpose(2, 3, 1, 0)


@pytest.mark.parametrize("c,cout", [(8, 8), (8, 16), (16, 8)])
def test_wgrad_plain_matches_pallas_and_autograd(c, cout):
    p, b, h, w = 4, 2, 16, 32
    x = _rand((b, h, w, c), 12)
    g = _rand((b, h, w, cout), 13)
    want = pk.packed_conv_wgrad(_phase_blocked(x, p), _phase_blocked(g, p), p,
                                mode="highest", interpret=True)
    before = dict(tpk.launches)
    got = tpk.packed_conv_wgrad(_nchw(x), _nchw(g))
    assert tpk.launches == before  # CPU tensors take the plain twin
    assert tuple(got.shape) == (cout, c, 3, 3)
    np.testing.assert_allclose(_hwio(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    wgt = torch.zeros((cout, c, 3, 3), requires_grad=True)
    (auto,) = torch.autograd.grad(F.conv2d(_nchw(x), wgt, padding=1), wgt, _nchw(g))
    np.testing.assert_allclose(got.numpy(), auto.numpy(), rtol=1e-4, atol=1e-4)


def test_wgrad_keeps_images_apart_and_pads_with_zeros():
    """One input pixel in a corner of image 0 and one cotangent pixel at the
    same corner of image 1 must not meet; within an image, taps that would
    read outside it contribute nothing."""
    x = torch.zeros((2, 8, 8, 32))
    d = torch.zeros((2, 8, 8, 32))
    x[0, 0, 7, 31] = 1.0
    d[1, 0, 0, 0] = 1.0
    assert tpk.packed_conv_wgrad(x, d).abs().max().item() == 0.0
    d[0, 0, 7, 31] = 2.0  # same image, same pixel: the centre tap alone
    dw = tpk.packed_conv_wgrad(x, d)
    assert dw[0, 0, 1, 1].item() == 2.0 and dw.abs().sum().item() == 2.0
    with pytest.raises(ValueError, match="must be"):
        tpk.packed_conv_wgrad(x, d[:, :, :4])


def test_wgrad_split_covers_the_grid():
    """The pixel split of csrc/packed_conv_wgrad.cu at the train step's
    shapes: one wave of its tiling's blocks at most, never more blocks than
    there are tiles, at least one. The wrapper decides the tiling and hands
    it to the C entry, which launches that one (the check that the pair is
    an instantiated one runs on the card)."""
    for c, cout, h in ((32, 32, 1024), (32, 64, 1024), (64, 64, 512), (64, 128, 512),
                       (128, 64, 512), (64, 32, 1024)):
        o_slab, rows, blocks = tpk.wgrad_tiling(cout)
        k = tpk.wgrad_ksplit(2, c, cout, h, h)
        slabs = -(-c // 32) * -(-cout // o_slab)
        assert 1 <= k and slabs * k <= blocks < slabs * (k + 1)
    assert tpk.wgrad_tiling(128) == (64, 4, tpk.WGRAD_BLOCKS)
    assert tpk.wgrad_tiling(96) == (32, 2, 2 * tpk.WGRAD_BLOCKS)
    assert tpk.wgrad_ksplit(1, 8, 8, 2, 32) == 1  # one tile
    assert tpk.wgrad_ksplit(1, 1024, 512, 64, 64) == 1  # more slabs than blocks


def _tf32(v: torch.Tensor, truncate: bool = False) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits): the nearest value, ties away from
    zero, as csrc/packed_conv_wgrad.cu rounds a high part, or with
    ``truncate`` the low 13 bits dropped, as the tensor cores read a low part.
    A test-only emulation."""
    bits = v.contiguous().view(torch.int32)
    return ((bits if truncate else bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_wgrad_3xtf32_split_is_fp32_accurate():
    """The grade of csrc/packed_conv_wgrad.cu, emulated on the CPU: each
    operand split into hi = tf32(v) and lo = v - hi, read truncated to TF32,
    dW summed in fp32 from lo*hi + hi*lo + hi*hi, lies within 1e-5 of dW's
    largest entry of the float64 sum; one TF32 product (hi*hi alone) does
    not."""
    x = torch.from_numpy(_rand((2, 16, 16, 32), 30)).permute(0, 3, 1, 2).contiguous()
    d = torch.from_numpy(_rand((2, 16, 16, 16), 31)).permute(0, 3, 1, 2).contiguous()
    x = F.leaky_relu(x, 0.2)
    # a tie goes away from zero, less than half an ulp down; truncation down
    tie = torch.tensor([1.0 + 2**-11, 1.0 + 2**-12, -(1.0 + 2**-11)])
    assert _tf32(tie).tolist() == [1.0 + 2**-10, 1.0, -(1.0 + 2**-10)]
    assert _tf32(tie, truncate=True).tolist() == [1.0, 1.0, -1.0]
    xh, dh = _tf32(x), _tf32(d)
    xl, dl = _tf32(x - xh, truncate=True), _tf32(d - dh, truncate=True)
    assert (xh.view(torch.int32) & 0x1FFF).eq(0).all() and (xl.view(torch.int32) & 0x1FFF).eq(0).all()
    want = tpk.packed_conv_wgrad_plain(x.double(), d.double())
    three = (tpk.packed_conv_wgrad_plain(xh, dl) + tpk.packed_conv_wgrad_plain(xl, dh)
             + tpk.packed_conv_wgrad_plain(xh, dh))
    one = tpk.packed_conv_wgrad_plain(xh, dh)
    scale = want.abs().max().item()
    assert (three.double() - want).abs().max().item() <= 1e-5 * scale
    assert (one.double() - want).abs().max().item() > 1e-5 * scale


@pytest.mark.parametrize("p_in", [1, 2])
def test_packed_upconv_lrelu_plain_matches_pallas(p_in):
    b, c, cout, h, w = 2, 8, 4, 8, 16
    x, wgt, bias = _rand((b, h, w, c), 4), _rand((3, 3, c, cout), 5, 0.2), _rand((cout,), 6)
    want = pk.packed_upconv(_phase_blocked(x, p_in), jnp.asarray(wgt), jnp.asarray(bias),
                            p_in, mode="highest", rows_per_step=4, interpret=True,
                            epilogue="lrelu")
    got = tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), epilogue="lrelu")
    np.testing.assert_allclose(
        _nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 2 * p_in)), **TOL)
    normed = tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias))
    assert not np.allclose(_nhwc(normed), _nhwc(got), atol=1e-3)
    with pytest.raises(ValueError, match="epilogue"):
        tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), epilogue="none")
    with pytest.raises(ValueError, match="rgb_w"):
        tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), epilogue="lrelu",
                          rgb_w=torch.zeros(3, c), rgb_b=torch.zeros(3))


# name -> (JAX custom_vjp, plain twin, output scale, phase count out / in)
_OPS = {
    "conv_lrelu": (jvjp.conv_lrelu, lambda x, w, b: tpk.packed_conv_plain(x, w, b, "lrelu"),
                   1, 1.0),
    "convpool_lrelu": (jvjp.convpool_lrelu,
                       lambda x, w, b: tpk.packed_convpool_plain(x, w, b, "lrelu"), 0.5, 0.5),
    "conv_lrelu_norm": (jvjp.conv_lrelu_norm,
                        lambda x, w, b: tpk.packed_conv_plain(x, w, b, "lrelu_norm"), 1, 1.0),
    "upconv_lrelu_norm": (jvjp.upconv_lrelu_norm,
                          lambda x, w, b: tpk.packed_upconv_plain(x, w, b), 2, 2.0),
}


def _torch_vjp(fn, x, w, b, cot):
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = fn(x, w, b)
    return (y.detach(), *torch.autograd.grad(y, (x, w, b), cot))


def _function_vs_jax_vjp(name, c, cout, mode):
    """The Function's output and (dx, dw, db) at kernel ``mode`` against
    ``jax.vjp`` of the JAX custom_vjp at the same mode; returns the port's."""
    jax_fn, _, scale, p_ratio = _OPS[name]
    p, b, h, w = 2, 2, 16, 32
    p_out = int(p * p_ratio)
    x = _rand((b, h, w, c), 30)
    wgt, bias = _rand((3, 3, c, cout), 31, 0.2), _rand((cout,), 32)
    cot = _rand((b, int(h * scale), int(w * scale), cout), 33)

    y_j, vjp_fn = jax.vjp(lambda xp, wg, bi: jax_fn(xp, wg, bi, p, mode),
                          _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias))
    dx_j, dw_j, db_j = vjp_fn(_phase_blocked(cot, p_out))

    args = (_nchw(x), _oihw(wgt), torch.from_numpy(bias), _nchw(cot))
    before = dict(tpk.launches)
    y, dx, dw, db = _torch_vjp(lambda *a: getattr(tvjp, name)(*a, mode=mode), *args)
    assert tpk.launches == before
    np.testing.assert_allclose(_nhwc(y), np.asarray(pk.packed_rgb_to_nhwc(y_j, p_out)), **TOL)
    np.testing.assert_allclose(_nhwc(dx), np.asarray(pk.packed_rgb_to_nhwc(dx_j, p)),
                               **VJP_TOL)
    np.testing.assert_allclose(_hwio(dw), np.asarray(dw_j), **VJP_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j), **VJP_TOL)
    return args, (y, dx, dw, db)


@pytest.mark.parametrize("c,cout", [(8, 8), (8, 16)])
@pytest.mark.parametrize("name", list(_OPS))
def test_function_matches_jax_vjp_and_twin_autograd(name, c, cout):
    args, got = _function_vs_jax_vjp(name, c, cout, "highest")
    for g, want in zip(got, _torch_vjp(_OPS[name][1], *args)):
        np.testing.assert_allclose(g.numpy(), want.numpy(), **VJP_TOL)


@pytest.mark.parametrize("name", list(_OPS))
def test_function_matches_jax_vjp_at_mid(name):
    """Kernel mode "mid" (the 2-term split) forward and backward against the
    JAX custom VJPs at "mid": the recompute and the input gradient at the
    forward's mode, the weight gradient fp32 (both promote it). Autograd
    through the twin is no yardstick here: the backward's convs split the
    cotangent and round the weights, the twin's derivative does neither."""
    args, (y, dx, _, _) = _function_vs_jax_vjp(name, 8, 16, "mid")
    fp32 = _torch_vjp(lambda *a: getattr(tvjp, name)(*a, mode="highest"), *args)
    assert not torch.equal(y, fp32[0]) and not torch.equal(dx, fp32[1])


@pytest.mark.parametrize("name", list(_OPS))
def test_function_gradcheck_fp64(name):
    """The backward formulas (the lrelu mask from the output's sign, the
    PixelNorm cotangent, the pool's and the upsample's adjoints) against
    finite differences; the twins run in fp64."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((1, 3, 4, 6), dtype=torch.float64, generator=gen, requires_grad=True)
    w = (0.3 * torch.randn((2, 3, 3, 3), dtype=torch.float64, generator=gen)).requires_grad_()
    b = torch.randn(2, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(lambda *a: getattr(tvjp, name)(*a, mode="highest"),
                                    (x, w, b), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", list(_OPS))
def test_backward_launches_only_what_is_asked(name, monkeypatch):
    """No wgrad where the weights need no gradient (the generator step
    through the discriminator), no dgrad conv where the input needs none."""
    calls = []
    for fn in ("packed_conv_wgrad", "packed_conv", "packed_convpool", "packed_upconv"):
        real = getattr(tpk, fn)
        monkeypatch.setattr(
            tpk, fn, lambda *a, _fn=fn, _real=real, **k: (
                calls.append((_fn, k.get("epilogue", a[3] if len(a) > 3 else None))),
                _real(*a, **k))[1])
    x, w, b = torch.randn(1, 8, 8, 8), 0.2 * torch.randn(8, 8, 3, 3), torch.zeros(8)
    dgrad = ("packed_convpool" if name == "upconv_lrelu_norm" else "packed_conv", "none")

    def backward_calls(x_grad, w_grad):
        y = getattr(tvjp, name)(x.clone().requires_grad_(x_grad),
                                w.clone().requires_grad_(w_grad), b)
        calls.clear()
        y.sum().backward()
        return list(calls)

    only_x = backward_calls(True, False)
    assert ("packed_conv_wgrad", None) not in only_x and dgrad in only_x
    only_w = backward_calls(False, True)
    assert ("packed_conv_wgrad", None) in only_w
    assert only_w.count(dgrad) == 0
    # convpool_lrelu recomputes its lrelu mask and conv_lrelu_norm its
    # pre-norm tensor with the forward's fp32 sums: one "lrelu" conv whatever
    # the gradients asked for
    recompute = ("packed_conv", "lrelu")
    recomputes = 1 if name in ("convpool_lrelu", "conv_lrelu_norm") else 0
    assert only_w.count(recompute) == recomputes
    both = backward_calls(True, True)
    assert both.count(("packed_conv_wgrad", None)) == 1
    assert both.count(dgrad) == 1
    assert both.count(recompute) == recomputes


def test_backward_is_not_differentiable_twice():
    """Like a custom_vjp: a second-order term (R1) must go through the
    unpacked path, and asking for one here raises instead of giving zeros."""
    x = torch.randn(1, 8, 8, 8, requires_grad=True)
    w = (0.2 * torch.randn(8, 8, 3, 3)).requires_grad_()
    y = tvjp.conv_lrelu(x, w, torch.zeros(8))
    (gx,) = torch.autograd.grad(y.sum(), x, create_graph=True)
    # the backward's outputs carry no graph (or an error node, where the
    # cotangent itself required grad): either way autograd raises
    with pytest.raises(RuntimeError, match="does not require grad|differentiable twice"):
        gx.square().sum().backward()


_GUARDED = {
    "packed_upconv": "upconv_lrelu_norm", "packed_conv": "conv_lrelu",
    "packed_convpool": "convpool_lrelu", "packed_conv_rgb": "conv_lrelu_norm",
}


@pytest.mark.parametrize("kernel", list(_GUARDED))
def test_forward_kernels_refuse_to_swallow_gradients(kernel):
    """Off the CPU a forward wrapper launches a kernel whose output has no
    grad_fn. With grad mode on and an argument that requires grad it must
    raise and name the ops/packed_vjp.py function; under no_grad it goes on
    (here to the device check: ``meta`` tensors stand in for the card)."""
    from tests.test_torch_packed import _kernel_args

    args, kwargs = _kernel_args(kernel, "meta")
    args = (args[0], args[1].requires_grad_(True), *args[2:])
    before = dict(tpk.launches)
    with pytest.raises(RuntimeError, match=f"packed_vjp.{_GUARDED[kernel]}"):
        getattr(tpk, kernel)(*args, **kwargs)
    with torch.no_grad(), pytest.raises(RuntimeError, match="not supported"):
        getattr(tpk, kernel)(*args, **kwargs)
    assert tpk.launches == before
    # on the CPU the plain twin is ordinary differentiable torch code
    cpu_args, cpu_kwargs = _kernel_args(kernel, "cpu")
    cpu_args = (cpu_args[0], torch.randn_like(cpu_args[1]).requires_grad_(True), *cpu_args[2:])
    if kernel != "packed_conv_rgb" or not cpu_kwargs.get("emit_uint8"):
        out = getattr(tpk, kernel)(*cpu_args, **cpu_kwargs)
        assert (out[0] if isinstance(out, tuple) else out).grad_fn is not None


def test_packed_conv_takes_wide_outputs_without_pixelnorm():
    """The discriminator's 64 -> 128 conv is recomputed by convpool_lrelu's
    backward: "lrelu" and "none" take any output channel count in slabs (the
    largest of 64, 32, 16 and 8 that divides it rounded up to a multiple of
    8: 12 and 4 on slabs of 16 and 8), the fixed-tile check (the stage-fused
    kernels') only 8, 16, 32 or 64."""
    for cout in (128, 96, 48, 12, 4):
        tpk._check_cout("packed_conv", cout, sliced=True)
    assert [tpk._pool_slab(tpk.sliced_cout(c)) for c in (12, 4, 2)] == [16, 8, 8]
    for bad, sliced in ((128, False), (48, False), (12, False), (0, True)):
        with pytest.raises(ValueError, match="Cout"):
            tpk._check_cout("packed_conv", bad, sliced=sliced)
    # "none" has no check of its own: the slabs of "lrelu" at every Cout
    assert not hasattr(tpk, "_check_none_slab")
    assert [tpk.conv_tiling(c)[0] for c in (96, 48, 16, 8, 24)] == [32, 16, 16, 8, 8]
    for cout in (48, 16, 8):
        tpk._check_cout("packed_conv", cout, sliced=True)
    # one slab: the sliced weight layout is packed_conv's own
    w = torch.randn(64, 8, 3, 3)
    assert torch.equal(tpk.convpool_kernel_weights(w)[0], tpk.conv_kernel_weights(w))
