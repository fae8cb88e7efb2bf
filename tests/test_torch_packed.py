"""The port's late-stage kernels (probgan_tpu_torch/ops/packed.py) on the CPU.

Each plain twin is held against the JAX package's Pallas kernel, run in
interpret mode as tests/test_pallas_packed.py runs it, on the same numpy
inputs: fp32 to rtol = atol = 2e-5 (float reassociation only), uint8 within
+-1 on at most 0.1% of bytes (tanh landing on a rounding boundary). The JAX
layout helpers convert between the phase-blocked layout and NHWC; the port
takes dense NCHW and OIHW weights.

The CUDA wrappers' weight layouts are checked here too, by evaluating the
kernels' index formulas (csrc/*.cu) in numpy on the prepared weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.ops import packed as tpk

TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(
        np.float32
    )


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _phase_blocked(x_nhwc, p):
    if p == 1:
        return pk.nhwc_to_packed(jnp.asarray(x_nhwc))
    return pk.nhwc_to_phase_blocked(jnp.asarray(x_nhwc), p)


def _assert_uint8_close(got, want, max_share=1e-3):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d != 0) <= max_share, np.mean(d != 0)


@pytest.mark.parametrize("with_rgb", [False, True])
@pytest.mark.parametrize("p_in", [1, 2])
def test_packed_upconv_plain_matches_pallas(p_in, with_rgb):
    b, c, cout, h, w = 2, 8, 4, 8, 16
    x = _rand((b, h, w, c), 4)
    wgt = _rand((3, 3, c, cout), 5, 0.2)
    bias = _rand((cout,), 6)
    rgb_w = _rand((c, 3), 7, 0.3)
    rgb_b = _rand((3,), 8)
    jax_rgb = {"rgb_w": jnp.asarray(rgb_w), "rgb_b": jnp.asarray(rgb_b)} if with_rgb else {}
    want = pk.packed_upconv(
        _phase_blocked(x, p_in), jnp.asarray(wgt), jnp.asarray(bias), p_in,
        mode="highest", rows_per_step=4, interpret=True, **jax_rgb,
    )
    port_rgb = ({"rgb_w": torch.from_numpy(rgb_w.T.copy()),
                 "rgb_b": torch.from_numpy(rgb_b)} if with_rgb else {})
    before = dict(tpk.launches)
    got = tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), **port_rgb)
    assert tpk.launches == before  # CPU tensors take the plain twin
    if with_rgb:
        want, want_rgb = want
        got, got_rgb = got
        np.testing.assert_allclose(
            _nhwc(got_rgb), np.asarray(pk.packed_rgb_to_nhwc(want_rgb, p_in))[..., :3],
            **TOL)
    np.testing.assert_allclose(
        _nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 2 * p_in)), **TOL)


@pytest.mark.parametrize("p", [1, 2])
def test_packed_conv_plain_matches_pallas(p):
    b, c, cout, h, w = 2, 8, 8, 16, 32
    x = _rand((b, h, w, c), 0)
    wgt = _rand((3, 3, c, cout), 1, 0.2)
    bias = _rand((cout,), 2)
    want = pk.packed_conv(_phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias),
                          p, mode="highest", interpret=True)
    got = tpk.packed_conv(_nchw(x), _oihw(wgt), torch.from_numpy(bias))
    np.testing.assert_allclose(
        _nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, p)), **TOL)


@pytest.mark.parametrize("cout", [8, 64, 72])
def test_packed_conv_lrelu_plain_matches_pallas(cout):
    """The discriminator's conv1: conv + bias + LeakyReLU, no PixelNorm. Cout
    that is and is not a multiple of the CUDA kernels' 64-channel slab."""
    b, c, h, w = 1, 8, 16, 32
    x = _rand((b, h, w, c), 60)
    wgt = _rand((3, 3, c, cout), 61, 0.2)
    bias = _rand((cout,), 62)
    want = pk.packed_conv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias),
                          2, mode="highest", epilogue="lrelu", interpret=True)
    got = tpk.packed_conv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), epilogue="lrelu")
    np.testing.assert_allclose(
        _nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 2)), **TOL)
    # and it is not the generator's epilogue
    normed = tpk.packed_conv(_nchw(x), _oihw(wgt), torch.from_numpy(bias))
    assert not np.allclose(_nhwc(normed), _nhwc(got), atol=1e-3)


def test_packed_conv_none_epilogue_is_conv_plus_bias():
    """epilogue="none" (the training dgrad conv): against the JAX kernel."""
    b, c, cout, h, w = 1, 8, 8, 16, 32
    x, wgt, bias = _rand((b, h, w, c), 70), _rand((3, 3, c, cout), 71, 0.2), _rand((cout,), 72)
    want = pk.packed_conv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias),
                          2, mode="highest", epilogue="none", interpret=True)
    got = tpk.packed_conv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), epilogue="none")
    np.testing.assert_allclose(
        _nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 2)), **TOL)
    with pytest.raises(ValueError, match="epilogue"):
        tpk.packed_conv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), epilogue="relu")


@pytest.mark.parametrize("epilogue", ["lrelu", "none"])
@pytest.mark.parametrize("p,cout", [(2, 8), (4, 8), (2, 64), (2, 72)])
def test_packed_convpool_plain_matches_pallas(p, cout, epilogue):
    """conv + bias + LeakyReLU (or nothing) + 2x2 mean pool, activation before
    the pool; the JAX kernel's phase count halves at the pool."""
    b, c, h, w = 2, 8, 16, 32
    x = _rand((b, h, w, c), 63)
    wgt = _rand((3, 3, c, cout), 64, 0.2)
    bias = _rand((cout,), 65)
    want = pk.packed_convpool(_phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias),
                              p, mode="highest", epilogue=epilogue, rows_per_step=8,
                              interpret=True)
    before = dict(tpk.launches)
    got = tpk.packed_convpool(_nchw(x), _oihw(wgt), torch.from_numpy(bias),
                              epilogue=epilogue)
    assert tpk.launches == before  # CPU tensors take the plain twin
    assert tuple(got.shape) == (b, cout, h // 2, w // 2)
    np.testing.assert_allclose(
        _nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, p // 2)), **TOL)


def test_packed_convpool_activates_before_the_pool():
    """A window of +1, +1, -1, -1 pools to 0 if pooled first, to 0.4 if
    activated first."""
    x = torch.zeros((1, 8, 2, 2))
    x[0, 0] = torch.tensor([[1.0, 1.0], [-1.0, -1.0]])
    w = torch.zeros((32, 8, 3, 3))
    w[:, 0, 1, 1] = 1.0  # identity tap on channel 0
    got = tpk.packed_convpool(x, w, torch.zeros(32))
    assert tuple(got.shape) == (1, 32, 1, 1)
    np.testing.assert_allclose(got.numpy().ravel(), np.full(32, 0.4, np.float32), atol=1e-7)
    with pytest.raises(ValueError, match="epilogue"):
        tpk.packed_convpool(x, w, torch.zeros(32), epilogue="lrelu_norm")


@pytest.mark.parametrize("emit_uint8", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_packed_conv_rgb_plain_matches_pallas(alpha, emit_uint8):
    b, c, cout, h, w = 1, 8, 8, 32, 64  # H a multiple of the kernel's 16 rows
    p = 4
    x = _rand((b, h, w, c), 12)
    wgt = _rand((3, 3, c, cout), 13, 0.2)
    bias = _rand((cout,), 14)
    rgb_w = _rand((cout, 3), 15, 0.3)
    rgb_b = _rand((3,), 16)
    prev = _rand((b, h // 2, w // 2, 3), 17)
    prev8 = np.pad(prev, ((0, 0), (0, 0), (0, 0), (0, 5)))  # the kernel's 8 rows
    want = pk.packed_conv_rgb(
        _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias),
        jnp.asarray(rgb_w), jnp.asarray(rgb_b), _phase_blocked(prev8, p // 2),
        jnp.float32(alpha), p, mode="highest", interpret=True, emit_uint8=emit_uint8,
    )
    got = tpk.packed_conv_rgb(
        _nchw(x), _oihw(wgt), torch.from_numpy(bias), torch.from_numpy(rgb_w.T.copy()),
        torch.from_numpy(rgb_b), _nchw(prev), alpha, emit_uint8=emit_uint8,
    ).numpy()
    assert got.shape == (b, h, w, 3)
    if emit_uint8:
        assert got.dtype == np.uint8
        _assert_uint8_close(got, np.asarray(pk.packed_u32_to_nhwc_uint8(want, p)))
    else:
        np.testing.assert_allclose(got, np.asarray(pk.packed_rgb_to_nhwc(want, p)),
                                   **TOL)


def _kernel_args(kernel, device):
    """Arguments at shapes the CUDA kernels take (C % 8, H, W tile multiples)."""
    def t(*shape):
        return torch.zeros(shape, device=device)

    if kernel == "packed_upconv":
        return (t(1, 32, 16, 16), t(32, 32, 3, 3), t(32)), {"rgb_w": t(3, 32), "rgb_b": t(3)}
    if kernel == "packed_conv":
        return (t(1, 32, 16, 32), t(32, 32, 3, 3), t(32)), {"epilogue": "lrelu"}
    if kernel == "packed_convpool":
        return (t(1, 32, 16, 32), t(64, 32, 3, 3), t(64)), {}
    return ((t(1, 32, 16, 32), t(32, 32, 3, 3), t(32), t(3, 32), t(3), t(1, 3, 8, 16), 1.0),
            {"emit_uint8": True})


@pytest.mark.parametrize("kernel", ["packed_upconv", "packed_conv", "packed_conv_rgb",
                                    "packed_convpool"])
def test_wrapper_raises_off_cpu_without_cuda(kernel):
    """A tensor on neither the CPU nor CUDA (here ``meta``) must raise, not
    fall back to the plain twin, and count no launch."""
    args, kwargs = _kernel_args(kernel, "meta")
    before = dict(tpk.launches)
    with pytest.raises(RuntimeError, match="not supported"):
        getattr(tpk, kernel)(*args, **kwargs)
    assert tpk.launches == before


def test_cuda_weight_layouts_match_plain_twins():
    """The CUDA wrappers' prepared weights, read with the kernels' index
    formulas: packed_upconv's wk[py][c][px][dy][dx][co] against input row
    i+py+dy-1 and column j+px+dx-1 of output (2i+py, 2j+px); packed_conv's
    w[c][ky][kx][co] against row y+ky-1, column x+kx-1."""
    rng = np.random.RandomState(3)
    b, c, cout, h, w = 2, 8, 4, 6, 10
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    wgt = torch.from_numpy(rng.standard_normal((cout, c, 3, 3)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    xpad = np.pad(x.numpy(), ((0, 0), (0, 0), (1, 1), (1, 1)))

    wk = tpk.upconv_kernel_weights(wgt).numpy()
    assert wk.shape == (2, c, 2, 2, 2, cout)
    pre = np.zeros((b, cout, 2 * h, 2 * w), np.float32)
    for py in range(2):
        for px in range(2):
            for dy in range(2):
                for dx in range(2):
                    win = xpad[:, :, py + dy: py + dy + h, px + dx: px + dx + w]
                    pre[:, :, py::2, px::2] += np.einsum(
                        "bchw,co->bohw", win, wk[py, :, px, dy, dx])
    want = tpk.packed_upconv_plain(x, wgt, bias)
    got = tpk._lrelu_norm(torch.from_numpy(pre) + bias[:, None, None])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)

    wk = tpk.conv_kernel_weights(wgt).numpy()
    assert wk.shape == (c, 3, 3, cout)
    pre = sum(
        np.einsum("bchw,co->bohw", xpad[:, :, ky: ky + h, kx: kx + w], wk[:, ky, kx])
        for ky in range(3) for kx in range(3)
    )
    want = tpk.packed_conv_plain(x, wgt, bias)
    got = tpk._lrelu_norm(torch.from_numpy(pre) + bias[:, None, None])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def test_convpool_weight_layout_matches_plain_twin():
    """packed_convpool's prepared weights, read with the kernel's index
    formula: slab s = co // CT holds w[s][c][ky][kx][co % CT] against input
    row y+ky-1, column x+kx-1; the 2x2 mean of act(conv + bias) follows."""
    rng = np.random.RandomState(4)
    b, c, h, w = 2, 8, 6, 10
    x = torch.from_numpy(rng.standard_normal((b, c, h, w)).astype(np.float32))
    xpad = np.pad(x.numpy(), ((0, 0), (0, 0), (1, 1), (1, 1)))
    for cout, ct in ((128, 64), (96, 32), (64, 64)):
        wgt = torch.from_numpy(rng.standard_normal((cout, c, 3, 3)).astype(np.float32))
        bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
        wk = tpk.convpool_kernel_weights(wgt).numpy()
        assert wk.shape == (cout // ct, c, 3, 3, ct)
        pre = np.concatenate([
            sum(np.einsum("bchw,co->bohw", xpad[:, :, ky: ky + h, kx: kx + w],
                          wk[s, :, ky, kx]) for ky in range(3) for kx in range(3))
            for s in range(cout // ct)], axis=1) + bias.numpy()[:, None, None]
        act = np.where(pre >= 0, pre, 0.2 * pre)
        # rows first, then columns, as the kernel sums them
        rows = 0.5 * (act[:, :, 0::2] + act[:, :, 1::2])
        pooled = 0.5 * (rows[..., 0::2] + rows[..., 1::2])
        want = tpk.packed_convpool_plain(x, wgt, bias)
        np.testing.assert_allclose(pooled, want.numpy(), rtol=1e-4, atol=1e-4)
