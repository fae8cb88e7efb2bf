"""The late-stage kernels at 16 and 8 channels (a narrow generator, e.g.
fmap_base 2048 at 1024²: packed stages at 32, 16 and 8 channels) on the CPU,
against the JAX package on the same numpy inputs.

- The plain twins of B1 "lrelu_norm" with the toRGB of its input, B2
  "lrelu_norm" and "lrelu", B3 and B5 "lrelu" at the input and output
  channel counts (C, Cout) in PAIRS against the JAX Pallas kernel in
  interpret mode, each at one or two of the kernel modes "highest", "mid"
  and "default" ("default" against JAX's "emulate_bf16": JAX's own
  "default" is exact fp32 on the CPU). One JAX call a case, about 1.5 s on
  the CPU, seven in all: the kernels without
  PixelNorm take every pair at once, their weights block-diagonal (zero
  products leave each block's sums as they are); a PixelNorm kernel takes
  the pairs of one Cout, a batch item each, C padded with zero channels, and
  its two cases take Cout 8 and 16. Tolerances: the kernels' own tests' (fp32 2e-5,
  tests/test_torch_packed.py; "mid" 2e-5 of the largest entry,
  tests/test_torch_mid.py; "default", B3's fp32 RGB and uint8 as
  tests/test_torch_grades.py).
- What the CUDA wrappers hand the kernels at these widths (meta tensors, no
  card): the bf16 weight layouts with zeros past C, the shared-memory bytes
  against the kernels' own arithmetic (csrc/conv_ring.cuh,
  csrc/bf16_ring.cuh), two ring blocks an SM, the launches counted under
  ``narrow_launches``; what still raises ValueError before any launch,
  naming ROADMAP.md B.a.2.4: Cout 24 and 4 in the stage-fused B10 and
  PixelNorm at 128 channels. B1 "lrelu_norm" at Cout 4 and B2
  "lrelu_norm" at Cout 24, refused before B.a.2.3, launch now (on the tiles
  of 8 and 32; tests/test_torch_any_width.py holds them at every width of
  that item), and so do Cout 4 in B2 "lrelu"/"none", B5 and B1 "lrelu" and
  B1 "lrelu" at Cout 12, refused before the training half of B.a.2.4
  (tests/test_torch_any_width_backward.py holds them at every width of the
  generators it trains). "none" at slabs of 16 and 8 is held in
  tests/test_torch_narrow_backward.py, the stage-fused kernels at 16 and 8
  in tests/test_torch_stage_fused_narrow.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.ops import packed as tpk
from tests.test_torch_packed import _assert_uint8_close, _nchw, _nhwc, _oihw, _phase_blocked, _rand

PAIRS = ((16, 8), (8, 8), (16, 16), (32, 16), (8, 16))  # (C, Cout)
JAX_MODE = {"highest": "highest", "mid": "mid", "default": "emulate_bf16"}
TOL = 2e-5  # fp32 and "default" absolute, "mid" of the largest entry
# (mode, kernel, form, Cout or None for every pair); a PixelNorm kernel's two
# cases take Cout 8 and 16. The repo's other twin tests hold B1 "lrelu" at
# C 8 -> 4 ("highest", "mid"), B2 "lrelu_norm" and B3 at 8 -> 8 ("highest",
# "default") and B5 at 8 -> 8 ("highest") against the same JAX kernels.
CASES = [
    ("mid", "upconv", "lrelu_norm+rgb", 16), ("default", "upconv", "lrelu_norm+rgb", 8),
    ("highest", "conv", "lrelu_norm", 16), ("mid", "conv", "lrelu_norm", 8),
    ("default", "conv", "lrelu", None), ("default", "conv_rgb", "fp32", 16),
    ("mid", "convpool", "lrelu", None),
]


def _check(got, want, mode, kernel, form):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if got.dtype == np.uint8:
        _assert_uint8_close(got, want, {"highest": 1e-3, "mid": 5e-3, "default": 5e-3}[mode])
    elif mode == "mid":
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    elif mode == "default" and kernel == "conv_rgb":  # a feature on a bf16 boundary
        d = np.abs(got - want)
        assert np.mean(d > TOL) <= 0.02 and d.max() <= 2e-2, (np.mean(d > TOL), d.max())
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _block_diagonal(seed):
    """x [1, h, w, sum C] and HWIO weights [3, 3, sum C, sum Cout] with one
    block a pair; the (C, Cout) slices of each pair."""
    cs, cos = [c for c, _ in PAIRS], [co for _, co in PAIRS]
    w = np.zeros((3, 3, sum(cs), sum(cos)), np.float32)
    slices = []
    for k, (c, co) in enumerate(PAIRS):
        ci, oi = sum(cs[:k]), sum(cos[:k])
        w[:, :, ci:ci + c, oi:oi + co] = _rand((3, 3, c, co), seed + k, 0.2)
        slices.append((slice(ci, ci + c), slice(oi, oi + co)))
    return w, slices


def _stacked(cout, seed, h, w):
    """One batch item a pair of Cout ``cout``: x [n, h, w, C max] with the
    item's channels past its C zero, shared HWIO weights [3, 3, C max,
    Cout]; the items' C."""
    cs = [c for c, co in PAIRS if co == cout]
    x = _rand((len(cs), h, w, max(cs)), seed)
    for k, c in enumerate(cs):
        x[k, :, :, c:] = 0.0
    return x, _rand((3, 3, max(cs), cout), seed + 1, 0.2), cs


@pytest.mark.parametrize("mode,kernel,form,cout", CASES)
def test_narrow_twins_match_pallas(mode, kernel, form, cout):
    jmode = JAX_MODE[mode]
    epilogue = form.split("+")[0]
    rgb = form.endswith("+rgb")
    if cout is None:  # every pair in one call, block-diagonal weights
        h, w = (16, 32) if kernel == "convpool" else (8, 16)
        wgt, slices = _block_diagonal(10)
        x = _rand((1, h, w, wgt.shape[2]), 20)
        bias = _rand((wgt.shape[3],), 21)
        xj, wj, bj = _phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias)
        if kernel == "upconv":
            want = pk.packed_upconv(xj, wj, bj, 2, mode=jmode, rows_per_step=4, interpret=True,
                                    epilogue=epilogue)
            want, fn = np.asarray(pk.packed_rgb_to_nhwc(want, 4)), tpk.packed_upconv
        elif kernel == "conv":
            want = pk.packed_conv(xj, wj, bj, 2, mode=jmode, epilogue=epilogue, interpret=True)
            want, fn = np.asarray(pk.packed_rgb_to_nhwc(want, 2)), tpk.packed_conv
        else:
            want = pk.packed_convpool(xj, wj, bj, 2, mode=jmode, epilogue=epilogue,
                                      rows_per_step=8, interpret=True)
            want, fn = np.asarray(pk.packed_rgb_to_nhwc(want, 1)), tpk.packed_convpool
        for cs, os in slices:
            got = fn(_nchw(x[..., cs]), _oihw(wgt[:, :, cs, os]), torch.from_numpy(bias[os]),
                     epilogue=epilogue, mode=mode)
            _check(_nhwc(got), want[..., os], mode, kernel, form)
        return
    if kernel == "conv_rgb":
        u8 = form == "uint8"
        h, w, p = 32, 64, 4  # H a multiple of the JAX kernel's 16 rows
        x, wgt, cs = _stacked(cout, 30, h, w)
        bias, rgb_w, rgb_b = _rand((cout,), 32), _rand((cout, 3), 33, 0.3), _rand((3,), 34)
        prev = _rand((len(cs), h // 2, w // 2, 3), 35)
        prev8 = np.pad(prev, ((0, 0), (0, 0), (0, 0), (0, 5)))
        alpha = 1.0 if u8 else 0.3
        want = pk.packed_conv_rgb(
            _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias), jnp.asarray(rgb_w),
            jnp.asarray(rgb_b), _phase_blocked(prev8, p // 2), jnp.float32(alpha), p,
            mode=jmode, interpret=True, emit_uint8=u8)
        want = np.asarray(pk.packed_u32_to_nhwc_uint8(want, p) if u8
                          else pk.packed_rgb_to_nhwc(want, p))
        for k, c in enumerate(cs):
            got = tpk.packed_conv_rgb(
                _nchw(x[k:k + 1, ..., :c]), _oihw(wgt[:, :, :c]), torch.from_numpy(bias),
                torch.from_numpy(rgb_w.T.copy()), torch.from_numpy(rgb_b),
                _nchw(prev[k:k + 1]), alpha, emit_uint8=u8, mode=mode).numpy()
            _check(got, want[k:k + 1], mode, kernel, form)
        return
    # PixelNorm: the pairs of one Cout, a batch item each
    h, w = (8, 16) if kernel == "upconv" else (16, 32)
    x, wgt, cs = _stacked(cout, 40, h, w)
    bias = _rand((cout,), 42)
    xj, wj, bj = _phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias)
    if kernel == "upconv":
        rgb_w, rgb_b = _rand((x.shape[-1], 3), 43, 0.3), _rand((3,), 44)
        kw = dict(rgb_w=jnp.asarray(rgb_w), rgb_b=jnp.asarray(rgb_b)) if rgb else {}
        want = pk.packed_upconv(xj, wj, bj, 2, mode=jmode, rows_per_step=4, interpret=True,
                                epilogue=epilogue, **kw)
        want, want_rgb = want if rgb else (want, None)
        want = np.asarray(pk.packed_rgb_to_nhwc(want, 4))
        for k, c in enumerate(cs):
            tkw = dict(rgb_w=torch.from_numpy(rgb_w[:c].T.copy()),
                       rgb_b=torch.from_numpy(rgb_b)) if rgb else {}
            got = tpk.packed_upconv(_nchw(x[k:k + 1, ..., :c]), _oihw(wgt[:, :, :c]),
                                    torch.from_numpy(bias), epilogue=epilogue, mode=mode, **tkw)
            if rgb:
                got, got_rgb = got
                _check(_nhwc(got_rgb),
                       np.asarray(pk.packed_rgb_to_nhwc(want_rgb, 2))[k:k + 1, ..., :3],
                       mode, kernel, form)
            _check(_nhwc(got), want[k:k + 1], mode, kernel, form)
        return
    want = pk.packed_conv(xj, wj, bj, 2, mode=jmode, epilogue=epilogue, interpret=True)
    want = np.asarray(pk.packed_rgb_to_nhwc(want, 2))
    for k, c in enumerate(cs):
        got = tpk.packed_conv(_nchw(x[k:k + 1, ..., :c]), _oihw(wgt[:, :, :c]),
                              torch.from_numpy(bias), epilogue=epilogue, mode=mode)
        _check(_nhwc(got), want[k:k + 1], mode, kernel, form)


# -- what the wrappers hand the kernels at 16 and 8 channels ------------------


def _meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers on meta tensors as on the card: the device check passes,
    an H100's 132 SMs, and the C launch records (name, args) instead of
    running; the launches are counted as the card counts them."""
    calls = []
    monkeypatch.setattr(tpk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tpk, "_sms", lambda device: 132)
    monkeypatch.setattr(tpk, "_aligned16", lambda x: x)
    monkeypatch.setattr(tpk, "_ptr", lambda t: None)
    monkeypatch.setattr(tpk._build, "launch", lambda name, argtypes, device, *args:
                        calls.append((name, args)))
    tpk.reset_launches()
    yield calls
    tpk.reset_launches()


def test_narrow_wrappers_launch_the_narrow_kernels(recorded):
    """N's launches (batch 8): the fp32 rings with their bytes and two blocks
    an SM, the bf16 kernels with theirs, each counted under its counter and
    under narrow_launches; Cout 32 is not a narrow launch."""
    with torch.no_grad():
        tpk.packed_upconv(_meta(8, 16, 512, 512), _meta(8, 16, 3, 3), _meta(8),
                          rgb_w=_meta(3, 16), rgb_b=_meta(3))
        tpk.packed_conv(_meta(8, 16, 512, 512), _meta(16, 16, 3, 3), _meta(16))
        tpk.packed_conv_rgb(_meta(8, 8, 1024, 1024), _meta(8, 8, 3, 3), _meta(8), _meta(3, 8),
                            _meta(3), _meta(8, 3, 512, 512), 1.0, emit_uint8=True)
        tpk.packed_convpool(_meta(8, 8, 1024, 1024), _meta(16, 8, 3, 3), _meta(16))
        tpk.packed_convpool(_meta(8, 16, 512, 512), _meta(32, 16, 3, 3), _meta(32))
        tpk.packed_conv(_meta(8, 8, 1024, 1024), _meta(8, 8, 3, 3), _meta(8), "lrelu",
                        mode="mid")
        tpk.packed_upconv(_meta(8, 32, 256, 256), _meta(16, 32, 3, 3), _meta(16),
                          mode="default")
        tpk.packed_conv_rgb(_meta(8, 8, 1024, 1024), _meta(8, 8, 3, 3), _meta(8), _meta(3, 8),
                            _meta(3), _meta(8, 3, 512, 512), 1.0, emit_uint8=True, mode="mid")
    names = [n for n, _ in recorded]
    assert names == ["packed_upconv", "packed_conv", "packed_conv_rgb", "packed_convpool",
                     "packed_convpool", "packed_conv_bf16", "packed_upconv_bf16",
                     "packed_conv_rgb_bf16"]
    up, conv, rgb = (args for _, args in recorded[:3])
    # packed_upconv: (..., cout, epilogue, blocks, smem); 2 x 32 x 32 x 8 tiles
    assert up[-4:] == (8, 0, 264, tpk.upconv_ring_bytes(8))
    # packed_conv: (..., cout, epilogue, o_slab, rows, blocks, smem)
    assert conv[-6:] == (16, 0, 16, 16, 264, tpk.conv_ring_bytes(16))
    assert rgb[-2:] == (264, tpk.conv_ring_bytes(8))
    bf16 = recorded[6][1]
    assert bf16[-5:] == (16, 1, 0, 132, tpk.bf16_upconv_ring_bytes(16))
    # packed_conv_rgb_bf16: (..., cout, terms, blocks, smem) on B2's ring
    assert recorded[7][1][-4:] == (8, 2, 132, tpk.bf16_ring_bytes(8))
    assert tpk.narrow_launches == {
        "packed_upconv[cout8]": 1, "packed_conv[cout16]": 1, "packed_conv_rgb[cout8]": 1,
        "packed_convpool[cout16]": 1, "packed_conv_mid[cout8]": 1,
        "packed_upconv_bf16[cout16]": 1, "packed_conv_rgb_mid[cout8]": 1}
    assert tpk.launches["packed_convpool"] == 2 and tpk.launches["packed_conv_mid"] == 1
    assert tpk.launches["packed_conv_rgb_mid"] == 1


@pytest.mark.parametrize("call,match", [
    (lambda: tpk.packed_upconv_conv(_meta(1, 16, 8, 16), _meta(24, 16, 3, 3), _meta(24),
                                    _meta(24, 24, 3, 3), _meta(24)),
     r"Cout=24 not in \(8, 16, 32, 64\)"),
    (lambda: tpk.packed_upconv_conv(_meta(1, 8, 8, 16), _meta(4, 8, 3, 3), _meta(4),
                                    _meta(4, 4, 3, 3), _meta(4)), "ROADMAP.md"),
    (lambda: tpk.packed_conv(_meta(1, 16, 8, 32), _meta(128, 16, 3, 3), _meta(128)),
     "PixelNorm above 64"),
])
def test_narrow_wrappers_refuse_what_is_not_ported(recorded, call, match):
    """Each refusal raises before any launch and names B.a.2.4."""
    with torch.no_grad(), pytest.raises(ValueError, match=match) as refused:
        call()
    assert "ROADMAP.md, B.a.2.4" in str(refused.value)
    assert not recorded


@pytest.mark.parametrize("call,cout,tile,key", [
    (lambda: tpk.packed_upconv(_meta(1, 16, 16, 16), _meta(4, 16, 3, 3), _meta(4)),
     4, 8, "packed_upconv[cout4]"),
    (lambda: tpk.packed_conv(_meta(1, 16, 16, 32), _meta(24, 16, 3, 3), _meta(24)),
     24, 32, "packed_conv[cout24]"),
    # refused before the training half of B.a.2.4: the sliced kernels on the
    # slab of Cout rounded up to 8, B1 "lrelu" on the tile above Cout
    (lambda: tpk.packed_conv(_meta(1, 16, 16, 32), _meta(4, 16, 3, 3), _meta(4), "lrelu"),
     4, 8, "packed_conv[cout4]"),
    (lambda: tpk.packed_convpool(_meta(1, 16, 16, 32), _meta(4, 16, 3, 3), _meta(4)),
     4, 8, "packed_convpool[cout4]"),
    (lambda: tpk.packed_upconv(_meta(1, 16, 16, 16), _meta(4, 16, 3, 3), _meta(4),
                               epilogue="lrelu"),
     4, 8, "packed_upconv[cout4]"),
    (lambda: tpk.packed_conv(_meta(1, 16, 16, 32), _meta(4, 16, 3, 3), _meta(4), "none"),
     4, 8, "packed_conv[cout4]"),
    (lambda: tpk.packed_convpool(_meta(1, 16, 16, 32), _meta(4, 16, 3, 3), _meta(4), "none",
                                 mode="mid"), 4, 8, "packed_convpool_mid[cout4]"),
    (lambda: tpk.packed_upconv(_meta(1, 16, 16, 16), _meta(12, 16, 3, 3), _meta(12),
                               epilogue="lrelu"), 12, 16, "packed_upconv[cout12]"),
])
def test_narrow_wrappers_launch_what_was_refused(recorded, call, cout, tile, key):
    """B1 "lrelu_norm" at Cout 4 and B2 "lrelu_norm" at Cout 24 (refused
    before B.a.2.3), and Cout 4 in B2 "lrelu"/"none", B5 and B1 "lrelu" and
    B1 "lrelu" at Cout 12 (refused before the training half of B.a.2.4),
    launch on the tile or slab ``tile`` with the true Cout, counted under
    narrow_launches by it."""
    with torch.no_grad():
        y = call()
    assert y.shape[1] == cout
    ((name, args),) = recorded
    assert name.removesuffix("_bf16") in ("packed_upconv", "packed_conv", "packed_convpool")
    epilogue = {"packed_upconv": tpk.UPCONV_EPILOGUES, "packed_conv": tpk.CONV_EPILOGUES}
    if name == "packed_upconv":  # (..., cout, epilogue, blocks, smem)
        assert args[-4] == cout and args[-3] in epilogue[name].values()
        assert args[-1] == tpk.upconv_ring_bytes(tile)
    elif name == "packed_conv":  # (..., cout, epilogue, o_slab, rows, blocks, smem)
        assert args[-6] == cout and args[-4:-2] == (tile, 16)
        assert args[-1] == (tpk.none_ring_bytes(tile) if args[-5] == 2
                            else tpk.conv_ring_bytes(tile))
    elif name == "packed_convpool":  # (..., cout, act, blocks, smem)
        assert args[-4] == cout and args[-1] == tpk.conv_ring_bytes(tile)
    else:  # packed_convpool_bf16 (..., cout, terms, act, blocks, smem)
        assert args[-5] == cout and args[-1] == tpk.bf16_ring_bytes(tile)
    assert tpk.narrow_launches == {key: 1}


def test_narrow_layouts_and_shared_memory(recorded):
    """The bf16 weights of C 8 and 16: one chunk, the channels past C zero;
    a chunk of 32 is laid out as before. The bytes the wrappers pass are the
    kernels' (ConvRing / UpconvRing::kBytes: 3 stages of 8 channels, 16-row
    tiles, the figures csrc/conv_ring.cuh states; the bf16 rings of B1 and
    of B2, bf16_ring.cuh, at 16 rows, B2's launched by B3's wrapper at one
    slab of all Cout); the narrow fp32 rings fit two blocks an SM."""
    w = torch.randn(8, 16, 3, 3)
    cw = tpk.conv_bf16_weights(w).float()
    assert tuple(cw.shape) == (1, 9, 8, 40) and not cw[..., 16:].any()
    assert torch.equal(cw[0, 4, :, :16], w[:, :, 1, 1].to(torch.bfloat16).float())
    up = tpk.upconv_bf16_weights(w).float()
    assert tuple(up.shape) == (2, 1, 2, 4, 8, 40) and not up[..., 16:].any()
    wide = torch.randn(8, 40, 3, 3)  # a full chunk and a partial one of 8
    ww = tpk.conv_bf16_weights(wide).float()
    assert tuple(ww.shape) == (2, 9, 8, 40) and not ww[1, ..., 8:].any()
    assert torch.equal(ww[0, ..., :32], tpk.conv_bf16_weights(wide[:, :32]).float()[0, ..., :32])
    assert tuple(tpk.conv_bf16_weights(torch.randn(48, 8, 3, 3), 16).shape) == (3, 1, 9, 16, 40)
    src = (tpk.__file__.rsplit("/ops/", 1)[0] + "/csrc/conv_ring.cuh")
    text = open(src).read()
    for cout, conv, upconv in ((16, 89_856, 90_624), (8, 82_944, 84_480)):
        assert tpk.conv_ring_bytes(cout) == 4 * 3 * 8 * (18 * 44 + 9 * cout) == conv
        assert tpk.upconv_ring_bytes(cout) == 4 * 3 * 8 * (17 * 48 + 8 * cout) == upconv
        assert f"{conv:,}" in text and f"{upconv:,}" in text
        for smem in (conv, upconv):
            assert tpk.ring_blocks_per_sm(smem) == 2
            assert 2 * (smem + tpk.SMEM_RESERVED) <= tpk.SMEM_PER_SM
        with torch.no_grad():
            tpk.packed_conv_rgb(_meta(2, cout, 64, 64), _meta(cout, cout, 3, 3), _meta(cout),
                                _meta(3, cout), _meta(3), _meta(2, 3, 32, 32), 1.0,
                                emit_uint8=True, mode="default")
        assert recorded[-1][0] == "packed_conv_rgb_bf16"
        assert recorded[-1][1][-1] == tpk.bf16_ring_bytes(cout)
        assert tpk.bf16_upconv_ring_bytes(cout) == 4 * 3 * (32 * (17 * 24 + 4) + 8 * cout * 20)
        assert tpk.bf16_ring_bytes(cout) == 4 * 2 * (32 * (18 * 40 + 4) + 9 * cout * 20)
    assert [tpk.ring_blocks_per_sm(tpk.conv_ring_bytes(c)) for c in (32, 64)] == [1, 1]
    assert [tpk.conv_tiling(c) for c in (8, 16, 24, 48, 96)] == [(8, 16), (16, 16), (8, 16),
                                                                (16, 16), (32, 16)]
    assert tpk.upconv_tiling(8) == tpk.upconv_tiling(16) == (16, 16)
