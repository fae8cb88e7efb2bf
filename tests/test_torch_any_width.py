"""The serving path's PixelNorm kernels at any width up to 64 (ROADMAP.md
B.a.2.3): B1 ``packed_upconv`` "lrelu_norm" with the toRGB of its input, B2
``packed_conv`` "lrelu_norm" and B3 ``packed_conv_rgb`` at the Cout and C
that generators of fmap_base 512, 1024 and 3072 give them (2, 4, 12, 24, 48
channels; C 4 and 12 too), on the CPU, against the JAX package.

- The plain twins against the JAX Pallas kernels in interpret mode, one JAX
  call a case on the same numpy inputs, each at one kernel mode so that
  every kernel meets "highest", "mid" and "default" ("default" against
  JAX's "emulate_bf16"; JAX's own "default" is exact fp32 on the CPU), with
  tests/test_torch_narrow.py's tolerances (fp32 2e-5; "mid" 2e-5 of the
  largest entry; "default" 2e-5 but B3's fp32 RGB, on all but 2% of values,
  a feature on a bf16 rounding boundary; uint8 +-1 on 0.1-0.5% of bytes).
- Whole generators: the port's ``generator_rgb(packed=True)`` and
  ``generator_apply`` (uint8) against JAX's ``generator_rgb(packed=True)``
  on the same weights (carried over by core/convert.py) and latents, for
  ``ProGANConfig(resolution=512, latent_dim=16, fmap_max=64)`` at fmap_base
  512 (packed stages 16 -> 8, 8 -> 8; 8 -> 4 with toRGB, 4 -> 4) and 1536
  (48 -> 24, 24 -> 24; 24 -> 12, 12 -> 12): "highest" to rtol = atol = 2e-4
  (tests/test_pallas_packed.py's bound) and the uint8 images within +-1 of
  JAX's RGB denormed, on 0.5% of bytes; "fast" (JAX's packed mode
  "emulate_bf16") to a relative L2 of 5e-3 and the images to >= 50 dB
  (``FAST_PSNR_DB`` says why). The converted weights of the 1024² configurations T (fmap_base
  1024), T2 (512) and O (3072) have the port's shapes at every stage.
- What the CUDA wrappers hand the kernels at these widths, on meta inputs
  (a CUDA kernel has no CPU form) with the weights on the CPU so that their
  layouts can be read: the tile above Cout, the weights, bias and B3's
  toRGB weights zero-padded to it, B1's toRGB weights as they are, the true
  C and Cout, the shared-memory bytes against the kernels' own arithmetic
  (csrc/conv_ring.cuh, csrc/bf16_ring.cuh), the launches counted under
  ``narrow_launches`` by the true Cout; the training backward's kernels at
  widths they refused before the training half of B.a.2.4 (B2 "lrelu"
  and "none", B5, B1 "lrelu"), launched; and what still raises before any
  launch, naming ROADMAP.md B.a.2.4: the stage-fused kernels at these
  widths and PixelNorm above 64 channels. On the card, T, T2 and O's
  packed stages run the packed train step's G forward and backward, and
  refuse PROBGAN_STAGE_FUSED=1 up front.
On the card chip_smoke.py phase 22 holds the kernels against these twins,
phase 23 the backward's (tests/test_torch_any_width_backward.py on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.models import pro_gan as jpg
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.core.convert import convert_generator_params
from probgan_tpu_torch.core.tree import tree_map
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk
from tests.test_torch_narrow import JAX_MODE, TOL, _check
from tests.test_torch_packed import _nchw, _nhwc, _oihw, _phase_blocked, _rand

H100_SMS = 132
# (mode, kernel, form, C, Cout): each kernel at every mode, each width of
# the issue's list once
CASES = [
    ("highest", "upconv", "rgb", 8, 4), ("default", "upconv", "rgb", 4, 2),
    ("mid", "upconv", "rgb", 24, 12), ("default", "upconv", "rgb", 96, 48),
    ("mid", "conv", "features", 4, 4), ("highest", "conv", "features", 24, 24),
    ("default", "conv", "features", 48, 48),
    ("default", "conv_rgb", "fp32", 4, 4), ("highest", "conv_rgb", "fp32", 2, 2),
    ("mid", "conv_rgb", "fp32", 12, 12), ("highest", "conv_rgb", "uint8", 4, 4),
    ("mid", "conv_rgb", "uint8", 2, 2), ("default", "conv_rgb", "uint8", 12, 12),
]
GEN_TOL = dict(rtol=2e-4, atol=2e-4)
UINT8_SHARE = 0.005
# "fast": the packed stages round their operands to bf16, and the trunk's
# fp32 sums (XLA's and torch's, ~1e-5 apart at stage 5) put some of them on
# the other side of a rounding boundary, which the next stages carry on: from
# the same stage-5 features the packed stages agree with JAX's to 2e-4 on all
# but ~1% of values (5e-2 at most), from the latent the RGB to a relative L2
# of ~2e-3 and the images to >= 55 dB. Held to the grade's own floor against
# "high" (PERF.md §2: 50 dB) and 5e-3.
FAST_REL_L2, FAST_PSNR_DB = 5e-3, 50.0
# 512² generators (latent 16, fmap_max 64) and their packed stages' widths
GENERATORS = {512: [(16, 8), (8, 4)], 1536: [(48, 24), (24, 12)]}
# the 1024² configurations of this item: T, T2 and O
CARD_CONFIGS = {"T": 1024, "T2": 512, "O": 3072}


@pytest.mark.parametrize("mode,kernel,form,c,cout", CASES)
def test_any_width_twins_match_pallas(mode, kernel, form, c, cout):
    jmode = JAX_MODE[mode]
    seed = 7 * c + cout
    bias = _rand((cout,), seed + 2)
    if kernel == "upconv":
        h, w = 8, 16
        x, wgt = _rand((1, h, w, c), seed), _rand((3, 3, c, cout), seed + 1, 0.2)
        rgb_w, rgb_b = _rand((c, 3), seed + 3, 0.3), _rand((3,), seed + 4)
        want, want_rgb = pk.packed_upconv(
            _phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2, mode=jmode,
            rows_per_step=4, interpret=True, rgb_w=jnp.asarray(rgb_w), rgb_b=jnp.asarray(rgb_b))
        got, got_rgb = tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias),
                                         rgb_w=torch.from_numpy(rgb_w.T.copy()),
                                         rgb_b=torch.from_numpy(rgb_b), mode=mode)
        _check(_nhwc(got_rgb), np.asarray(pk.packed_rgb_to_nhwc(want_rgb, 2))[..., :3],
               mode, kernel, form)
        _check(_nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 4)), mode, kernel, form)
    elif kernel == "conv":
        h, w = 16, 32
        x, wgt = _rand((1, h, w, c), seed), _rand((3, 3, c, cout), seed + 1, 0.2)
        want = pk.packed_conv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2,
                              mode=jmode, epilogue="lrelu_norm", interpret=True)
        got = tpk.packed_conv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), mode=mode)
        _check(_nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 2)), mode, kernel, form)
    else:
        u8 = form == "uint8"
        h, w, p = 32, 64, 4  # H a multiple of the JAX kernel's 16 rows
        x, wgt = _rand((1, h, w, c), seed), _rand((3, 3, c, cout), seed + 1, 0.2)
        rgb_w, rgb_b = _rand((cout, 3), seed + 3, 0.3), _rand((3,), seed + 4)
        prev = _rand((1, h // 2, w // 2, 3), seed + 5)
        prev8 = np.pad(prev, ((0, 0), (0, 0), (0, 0), (0, 5)))
        alpha = 1.0 if u8 else 0.3
        want = pk.packed_conv_rgb(
            _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias), jnp.asarray(rgb_w),
            jnp.asarray(rgb_b), _phase_blocked(prev8, p // 2), jnp.float32(alpha), p,
            mode=jmode, interpret=True, emit_uint8=u8)
        want = np.asarray(pk.packed_u32_to_nhwc_uint8(want, p) if u8
                          else pk.packed_rgb_to_nhwc(want, p))
        got = tpk.packed_conv_rgb(_nchw(x), _oihw(wgt), torch.from_numpy(bias),
                                  torch.from_numpy(rgb_w.T.copy()), torch.from_numpy(rgb_b),
                                  _nchw(prev), alpha, emit_uint8=u8, mode=mode).numpy()
        _check(got, want, mode, kernel, form)


def _jax_params(cfg, seed):
    """JAX generator parameters of ``cfg`` from numpy (weights ~ N(0, 1),
    biases ~ N(0, 0.01)), as the JAX initializer shapes them."""
    shapes = jax.eval_shape(lambda key: jpg.init_generator(key, cfg), jax.random.key(0))
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * (1.0 if len(s.shape) > 1 else 0.1))
        .astype(np.float32), shapes)


@pytest.mark.parametrize("grade", ["highest", "fast"])
@pytest.mark.parametrize("fmap_base", sorted(GENERATORS))
def test_any_width_generator_matches_jax(fmap_base, grade, monkeypatch):
    """The whole 512² generator, packed stages 6-7 at the item's widths: the
    port's RGB (its twins on the CPU) against JAX's packed generator on the
    converted weights and the same latent, and its uint8 images
    (generator_apply, the denorm fused into B3's twin) against JAX's RGB
    denormed."""
    jcfg = jpg.ProGANConfig(resolution=512, latent_dim=16, fmap_base=fmap_base, fmap_max=64)
    tcfg = tpg.ProGANConfig(resolution=512, latent_dim=16, fmap_base=fmap_base, fmap_max=64)
    stage = jcfg.num_stages - 1
    assert jpg.packed_start_stage(jcfg, stage) == tpg.packed_start_stage(tcfg, stage) == 6
    assert [(tcfg.nf(s - 1), tcfg.nf(s)) for s in (6, 7)] == GENERATORS[fmap_base]
    jparams = _jax_params(jcfg, fmap_base)
    z = _rand((1, jcfg.latent_dim), 5)
    with monkeypatch.context() as mp:  # JAX reads the mode at trace time
        if grade == "fast":
            mp.setitem(jpg._PACKED_MODES, grade, "emulate_bf16")
        want = np.asarray(jpg.generator_rgb(jparams, jnp.asarray(z), jcfg, stage, 1.0,
                                            precision=grade, packed=True))
    tparams = convert_generator_params(jparams)
    tz = torch.from_numpy(z)
    rgb = tpg.generator_rgb(tparams, tz, tcfg, stage, 1.0, precision=grade, packed=True).numpy()
    img = tpg.generator_apply(tparams, tz, tcfg, stage, 1.0, precision=grade, packed=True)
    assert rgb.shape == want.shape == (1, 512, 512, 3)
    want_u8 = tpg.to_uint8(torch.from_numpy(want.copy())).numpy()
    d8 = np.abs(img.numpy().astype(np.int16) - want_u8.astype(np.int16))
    assert img.dtype == torch.uint8 and img.shape == want_u8.shape
    if grade == "highest":
        np.testing.assert_allclose(rgb, want, **GEN_TOL)
        assert d8.max() <= 1 and np.mean(d8 != 0) <= UINT8_SHARE, (d8.max(), np.mean(d8 != 0))
    else:
        rel = np.linalg.norm(rgb - want) / np.linalg.norm(want)
        psnr = 10 * np.log10(255.0**2 / np.mean(d8.astype(np.float64) ** 2))
        assert rel <= FAST_REL_L2 and psnr >= FAST_PSNR_DB, (rel, psnr)


@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_converted_weights_fit_the_card_configs(name):
    """core/convert.py carries JAX's parameters of T, T2 and O (1024²) over
    with the port's shapes at every stage, and the packed gate takes stages
    6-8 at the item's widths."""
    base = CARD_CONFIGS[name]
    jcfg = jpg.ProGANConfig(resolution=1024, fmap_base=base)
    tcfg = tpg.ProGANConfig(resolution=1024, fmap_base=base)
    shapes = jax.eval_shape(lambda key: jpg.init_generator(key, jcfg), jax.random.key(0))
    jparams = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    got = convert_generator_params(jparams)
    want = tpg.init_generator(tcfg, 0)
    flat_got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: tuple(t.shape), got))
    flat_want = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: tuple(t.shape), want))
    assert flat_got == flat_want
    assert tpg.packed_start_stage(tcfg, 8) == jpg.packed_start_stage(jcfg, 8) == 6
    widths = [tcfg.nf(s) for s in range(5, 9)]
    assert widths == {"T": [32, 16, 8, 4], "T2": [16, 8, 4, 2], "O": [96, 48, 24, 12]}[name]


# -- what the wrappers hand the kernels at these widths ------------------------


def _meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers with a meta input as on the card: the device check
    passes, an H100's 132 SMs, and the C launch records (name, args) with
    the tensors themselves in the pointers' places instead of running."""
    calls = []
    monkeypatch.setattr(tpk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tpk, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(tpk, "_aligned16", lambda x: x)
    monkeypatch.setattr(tpk, "_ptr", lambda t: t)
    monkeypatch.setattr(tpk._build, "launch", lambda name, argtypes, device, *args:
                        calls.append((name, args)))
    tpk.reset_launches()
    yield calls
    tpk.reset_launches()


def _conv_ring_bytes(tile):
    """csrc/conv_ring.cuh ConvRing::kBytes: 3 stages of kCC input channels
    (16 at 32 and 64, 8 below), each a (TH + 2) x 44 patch and 9 x tile
    weights a channel."""
    th, cc = (8 if tile == 64 else 16), (16 if tile >= 32 else 8)
    return 4 * 3 * cc * ((th + 2) * 44 + 9 * tile)


def _upconv_ring_bytes(tile):
    """UpconvRing::kBytes: (TH + 1) rows of 24 floats at 64, 48 below, and
    8 x tile pre-summed taps a channel."""
    th, cc = (8 if tile == 64 else 16), (16 if tile >= 32 else 8)
    return 4 * 3 * cc * ((th + 1) * (24 if tile == 64 else 48) + 8 * tile)


def _bf16_ring_bytes(tile, upconv):
    """bf16_ring.cuh ConvBf16Ring / UpconvBf16Ring::kBytes: 2 (B1: 3) stages
    of a 32-channel fp32 patch and the chunk's bf16 weights, 20 words a
    row."""
    th = 8 if tile == 64 else 16
    if upconv:
        return 4 * 3 * (32 * ((th + 1) * 24 + 4) + 8 * tile * 20)
    return 4 * 2 * (32 * ((th + 2) * 40 + 4) + 9 * tile * 20)


# (C, Cout, input H) of T, T2 and O's new B1, B2 and B3 launches, batch 2
# (B1 also at a C that is no multiple of 4)
UPCONV = [(8, 4, 512), (4, 2, 512), (24, 12, 512), (96, 48, 128), (48, 24, 256), (3, 5, 64)]
CONV = [(4, 4, 512), (24, 24, 512), (48, 48, 256)]
CONV_RGB = [(4, 4, 1024), (2, 2, 1024), (12, 12, 1024)]


@pytest.mark.parametrize("mode", ["high", "default", "mid"])
def test_wrappers_pad_to_the_tile_and_pass_the_true_widths(recorded, mode):
    """Each new width on the tile above it: zero-padded weights (the kernels'
    layouts of the padded OIHW weights), bias and B3 toRGB weights, B1's
    toRGB weights [3, C] as they are (fp32) or in rows of C rounded up to 4
    (bf16: the kernel's float4 reads), the true C and Cout, the tile's
    bytes, its blocks, and narrow_launches by the true Cout."""
    terms = tpk.BF16_TERMS.get(mode, 0)
    gen = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=gen)

    keys = {}
    for c, cout, h in UPCONV:
        tile = tpk.norm_tile(cout)
        w, b, rgb_w, rgb_b = rnd(cout, c, 3, 3), rnd(cout), rnd(3, c), rnd(3)
        with torch.no_grad():
            y, rgb = tpk.packed_upconv(_meta(2, c, h, h), w, b, rgb_w=rgb_w, rgb_b=rgb_b,
                                       mode=mode)
        assert tuple(y.shape) == (2, cout, 2 * h, 2 * h) and tuple(rgb.shape) == (2, 3, h, h)
        name, args = recorded[-1]
        wp = torch.cat([w, torch.zeros(tile - cout, c, 3, 3)])
        if terms:
            assert name == "packed_upconv_bf16"
            assert torch.equal(args[1], tpk.upconv_bf16_weights(wp))
            assert not args[1][..., cout:, :].float().any()
            c4 = -(-c // 4) * 4
            assert torch.equal(args[3], tpk._bf16(torch.cat([rgb_w, torch.zeros(3, c4 - c)], 1)))
            assert args[7:12] == (2, c, h, h, cout) and args[12:14] == (terms, 0)
            smem = _bf16_ring_bytes(tile, upconv=True)
        else:
            assert name == "packed_upconv"
            assert torch.equal(args[1], tpk.upconv_kernel_weights(wp))
            assert torch.equal(args[3], rgb_w)
            assert args[7:13] == (2, c, h, h, cout, 0)
            smem = _upconv_ring_bytes(tile)
        assert torch.equal(args[2], torch.cat([b, torch.zeros(tile - cout)]))
        tiles = tpk.upconv_tile_count(2, tile, h, h)
        assert args[-2:] == (tpk.persistent_blocks(tiles, H100_SMS, tpk.ring_blocks_per_sm(smem)),
                             smem)
        keys[f"packed_upconv{'' if not terms else '_bf16' if terms == 1 else '_mid'}"
             f"[cout{cout}]"] = 1
    for c, cout, h in CONV:
        tile = tpk.norm_tile(cout)
        w, b = rnd(cout, c, 3, 3), rnd(cout)
        with torch.no_grad():
            y = tpk.packed_conv(_meta(2, c, h, h), w, b, mode=mode)
        assert tuple(y.shape) == (2, cout, h, h)
        name, args = recorded[-1]
        wp = torch.cat([w, torch.zeros(tile - cout, c, 3, 3)])
        if terms:
            assert name == "packed_conv_bf16"
            assert torch.equal(args[1], tpk.conv_bf16_weights(wp, tile))
            assert args[4:11] == (2, c, h, h, cout, terms, 0)
            smem = _bf16_ring_bytes(tile, upconv=False)
        else:
            assert name == "packed_conv"
            assert torch.equal(args[1][0], tpk.conv_kernel_weights(wp))  # one slab
            assert args[4:12] == (2, c, h, h, cout, 0, tile, 8 if tile == 64 else 16)
            smem = _conv_ring_bytes(tile)
        assert torch.equal(args[2], torch.cat([b, torch.zeros(tile - cout)]))
        tiles = tpk.conv_tile_count(2, tile, h, h)
        assert args[-2:] == (tpk.persistent_blocks(tiles, H100_SMS, tpk.ring_blocks_per_sm(smem)),
                             smem)
        keys[f"packed_conv{'' if not terms else '_bf16' if terms == 1 else '_mid'}"
             f"[cout{cout}]"] = 1
    for c, cout, h in CONV_RGB:
        tile = tpk.norm_tile(cout)
        w, b, rgb_w, rgb_b = rnd(cout, c, 3, 3), rnd(cout), rnd(3, cout), rnd(3)
        with torch.no_grad():
            out = tpk.packed_conv_rgb(_meta(2, c, h, h), w, b, rgb_w, rgb_b,
                                      _meta(2, 3, h // 2, h // 2), 1.0, emit_uint8=True,
                                      mode=mode)
        assert tuple(out.shape) == (2, h, h, 3) and out.dtype == torch.uint8
        name, args = recorded[-1]
        wp = torch.cat([w, torch.zeros(tile - cout, c, 3, 3)])
        rgb_wp = torch.cat([rgb_w, torch.zeros(3, tile - cout)], dim=1)
        if terms:
            assert name == "packed_conv_rgb_bf16"
            assert torch.equal(args[1], tpk.conv_bf16_weights(wp))
            assert torch.equal(args[3], tpk._bf16(rgb_wp))
            smem = _bf16_ring_bytes(tile, upconv=False)
            assert args[-6:-2] == (h, h, cout, terms)
        else:
            assert name == "packed_conv_rgb"
            assert torch.equal(args[1], tpk.conv_kernel_weights(wp))
            assert torch.equal(args[3], rgb_wp)
            smem = _conv_ring_bytes(tile)
            assert args[-5:-2] == (h, h, cout)
        assert args[9:13] == (2, c, h, h)
        assert torch.equal(args[2], torch.cat([b, torch.zeros(tile - cout)]))
        tiles = tpk.conv_tile_count(2, tile, h, h)
        assert args[-2:] == (tpk.persistent_blocks(tiles, H100_SMS, tpk.ring_blocks_per_sm(smem)),
                             smem)
        keys[f"packed_conv_rgb{'' if not terms else '_bf16' if terms == 1 else '_mid'}"
             f"[cout{cout}]"] = 1
    assert tpk.narrow_launches == keys
    assert [tpk.norm_tile(n) for n in (1, 2, 4, 8, 9, 12, 16, 17, 24, 32, 33, 48, 64)] == [
        8, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64]


@pytest.mark.parametrize("call,cout,key", [
    (lambda: tpk.packed_conv(_meta(1, 16, 16, 32), _meta(12, 16, 3, 3), _meta(12), "lrelu"),
     12, "packed_conv[cout12]"),
    (lambda: tpk.packed_conv(_meta(1, 16, 16, 32), _meta(4, 16, 3, 3), _meta(4), "none",
                             mode="default"), 4, "packed_conv_bf16[cout4]"),
    (lambda: tpk.packed_convpool(_meta(1, 16, 16, 32), _meta(12, 16, 3, 3), _meta(12),
                                 mode="mid"), 12, "packed_convpool_mid[cout12]"),
    (lambda: tpk.packed_upconv(_meta(1, 8, 16, 16), _meta(4, 8, 3, 3), _meta(4),
                               epilogue="lrelu", mode="default"), 4, "packed_upconv_bf16[cout4]"),
])
def test_what_the_training_half_of_b_a_2_4_took_launches(recorded, call, cout, key):
    """Refused before the training half of B.a.2.4: one launch each with the
    true Cout, the weights and bias zero-padded to the slab or tile, counted
    under narrow_launches by the true Cout."""
    with torch.no_grad():
        y = call()
    ((name, args),) = recorded
    assert y.shape[1] == cout and name == key.split("[")[0].replace("_mid", "_bf16")
    at = 11 if name.startswith("packed_upconv") else 8  # the Cout argument
    assert args[at] == cout and args[2].shape[0] == (
        tpk.norm_tile(cout) if name.startswith("packed_upconv") else tpk.sliced_cout(cout))
    assert tpk.narrow_launches == {key: 1}


@pytest.mark.parametrize("call,needle", [
    (lambda: tpk.packed_upconv_conv(_meta(1, 8, 8, 16), _meta(4, 8, 3, 3), _meta(4),
                                    _meta(4, 4, 3, 3), _meta(4), mode="mid"), "Cout=4"),
    (lambda: tpk.packed_upconv_conv_rgb(_meta(1, 48, 8, 16), _meta(24, 48, 3, 3), _meta(24),
                                        _meta(24, 24, 3, 3), _meta(24), _meta(3, 24), _meta(3),
                                        _meta(3, 48), _meta(3), 1.0), "Cout=24"),
    (lambda: tpk.packed_upconv(_meta(1, 64, 8, 16), _meta(96, 64, 3, 3), _meta(96)),
     "PixelNorm above 64"),
    (lambda: tpk.packed_conv_rgb(_meta(1, 128, 8, 32), _meta(128, 128, 3, 3), _meta(128),
                                 _meta(3, 128), _meta(3), _meta(1, 3, 4, 16), 1.0),
     "PixelNorm above 64"),
])
def test_what_b_a_2_4_keeps_raises_before_any_launch(recorded, call, needle):
    with torch.no_grad(), pytest.raises(ValueError, match=needle) as refused:
        call()
    assert "ROADMAP.md, B.a.2.4" in str(refused.value)
    assert not recorded and not any(tpk.launches.values())


@pytest.mark.parametrize("name", sorted(CARD_CONFIGS))
def test_card_routes_refuse_the_item_s_widths_up_front(recorded, name, monkeypatch):
    """On the card, T, T2 and O's stages 6-8 under PROBGAN_STAGE_FUSED=1
    raise before the first launch, naming B.a.2.4 (the stage-fused kernels
    take Cout 8, 16, 32 and 64 from C % 8 == 0); without the variable the
    two-kernel path launches 3 B1, 2 B2 and 1 B3, counted by the true Cout
    where it is no tile's width. The packed train step's G (packed_g) runs
    its three stages forward and backward: per stage B1 and B2
    "lrelu_norm", then B2 "lrelu" and "none", B6, B1 "lrelu", B5 "none" and
    B6."""
    cfg = tpg.ProGANConfig(resolution=1024, fmap_base=CARD_CONFIGS[name])
    stage = cfg.num_stages - 1
    s0 = tpg.packed_start_stage(cfg, stage)

    params = {"blocks": [None] * (s0 - 1) + [
        {n: {"w": _meta(cfg.nf(s), cfg.nf(s - 1) if n == "conv1" else cfg.nf(s), 3, 3),
             "b": _meta(cfg.nf(s))} for n in ("conv1", "conv2")} for s in (6, 7, 8)],
        "to_rgb": [None] * 5 + [{"w": _meta(3, cfg.nf(s), 1, 1), "b": _meta(3)}
                                for s in (5, 6, 7, 8)]}
    x = _meta(2, cfg.nf(s0 - 1), 128, 128)
    monkeypatch.setenv("PROBGAN_STAGE_FUSED", "1")
    with torch.no_grad(), pytest.raises(ValueError, match="B.a.2.4"):
        tpg._g_late_packed(params, x, cfg, s0, stage, 1.0, "high", emit="uint8")
    assert not recorded
    monkeypatch.setenv("PROBGAN_STAGE_FUSED", "0")
    with torch.no_grad():
        out = tpg._g_late_packed(params, x, cfg, s0, stage, 1.0, "high", emit="uint8")
    assert tuple(out.shape) == (2, 1024, 1024, 3) and out.dtype == torch.uint8
    assert [n for n, _ in recorded] == ["packed_upconv", "packed_conv"] * 2 + [
        "packed_upconv", "packed_conv_rgb"]
    widths = [cfg.nf(s) for s in (6, 7, 8)]
    want = {}
    for kernel, cout in (("packed_upconv", widths[0]), ("packed_conv", widths[0]),
                         ("packed_upconv", widths[1]), ("packed_conv", widths[1]),
                         ("packed_upconv", widths[2]), ("packed_conv_rgb", widths[2])):
        if cout < 32 or cout not in tpk.SUPPORTED_COUT:
            want[f"{kernel}[cout{cout}]"] = want.get(f"{kernel}[cout{cout}]", 0) + 1
    assert tpk.narrow_launches == want

    # the packed train step's G on the kernels, forward and backward
    g = tree_map(lambda t: t.to("meta").requires_grad_(True),
                 tpg.init_generator(cfg, 0))
    recorded.clear()
    tpk.reset_launches()
    rgb = tpg._g_rgb_packed_train(g, _meta(2, cfg.latent_dim), cfg, s0, stage, 1.0,
                                  torch.float32, "default", remat=False)
    assert tuple(rgb.shape) == (2, 1024, 1024, 3)
    rgb.sum().backward()
    stage_calls = ["packed_upconv_bf16", "packed_conv_bf16"] * 3
    backward = ["packed_conv_bf16", "packed_conv_bf16", "packed_conv_wgrad_bf16",
                "packed_upconv_bf16", "packed_convpool_bf16", "packed_conv_wgrad_bf16"] * 3
    assert [n for n, _ in recorded] == stage_calls + backward
    assert all(leaf.grad is not None and leaf.grad.shape == leaf.shape
               for block in g["blocks"][s0 - 1:] for conv in block.values()
               for leaf in conv.values())
