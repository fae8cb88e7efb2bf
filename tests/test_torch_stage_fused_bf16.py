"""The stage-fused kernels B10 ``packed_upconv_conv`` and B11
``packed_upconv_conv_rgb`` at the bf16 kernel modes "default" (one bf16
pass) and "mid" (the 2-term split), on the CPU.

- Each plain twin against the JAX package's fused Pallas kernel in interpret
  mode on the same numpy inputs, at the shapes of
  tests/test_pallas_packed.py's stage-fused tests: "default" against JAX's
  "emulate_bf16" (JAX's own "default" is exact fp32 on the CPU, no model of
  the pass), "mid" against "mid". Both round (split) the same operands, and
  the fused chain rounds conv1's map where the pair's conv2 would, so only
  the order of the fp32 sums differs: features within 2e-5 (the
  single-kernel bound of tests/test_torch_grades.py). The RGB rounds the
  PixelNorm'd features, which the two compute in another order: a feature
  within that noise of a bf16 rounding boundary rounds the other way and
  moves its RGB by |rgb_w| x one bf16 step, so fp32 RGB is held to 2e-5 on
  all but 2% of values and 2e-2 on the rest (test_torch_grades.py's B3
  bound), uint8 to +-1 on 0.5% of bytes.
- Each twin equals the pair's twins composed at its mode, bit for bit.
- An unknown mode or a test aid of the TPU kernels raises.
- The route on the card, on meta tensors (a CUDA kernel has no CPU form):
  under ``PROBGAN_STAGE_FUSED=1`` at a bf16 grade, ``_g_late_packed`` hands
  the stage-fused bf16 kernels their mode and never reaches the pair or a
  plain twin; the wrappers pass the bf16 layouts and ``fused_bf16_bytes``.
The generator as a whole under the variable at "fast" and None against
JAX's is in tests/test_torch_stage_fused.py. On the card the kernels must
equal the bf16 pair bit for bit; chip_smoke.py phase 15 checks that.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk

TOL = dict(rtol=2e-5, atol=2e-5)
RGB_FLIP_SHARE, RGB_FLIP_ATOL = 0.02, 2e-2
UINT8_MAX_SHARE = 0.005
# the port's bf16 modes and the JAX kernel modes that model them on the CPU
MODES = (("default", "emulate_bf16"), ("mid", "mid"))
PAIR = ("packed_upconv", "packed_conv", "packed_conv_rgb")
TWINS = ("packed_upconv_plain", "packed_conv_plain", "packed_conv_rgb_plain",
         "packed_upconv_conv_plain", "packed_upconv_conv_rgb_plain")


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mode,jax_mode", MODES)
def test_upconv_conv_bf16_twin_matches_pallas(mode, jax_mode):
    """B10's twin at ``mode`` against pk.packed_upconv_conv (batch 1, 8
    channels, 8 x 16 input, phase-blocked P = 2), and against the pair's
    twins at the mode, bit for bit."""
    b, c, c1, c2, h, w = 1, 8, 8, 8, 8, 16
    x = _rand((b, h, w, c), 40)
    w1, b1 = _rand((3, 3, c, c1), 41, 0.2), _rand((c1,), 42)
    w2, b2 = _rand((3, 3, c1, c2), 43, 0.2), _rand((c2,), 44)
    want = pk.packed_upconv_conv(
        pk.nhwc_to_phase_blocked(jnp.asarray(x), 2), jnp.asarray(w1), jnp.asarray(b1),
        jnp.asarray(w2), jnp.asarray(b2), 2, mode=jax_mode, rows_per_step=4, interpret=True)
    args = (_nchw(x), _oihw(w1), _t(b1), _oihw(w2), _t(b2))
    before = dict(tpk.launches)
    got = tpk.packed_upconv_conv(*args, mode=mode)
    assert tpk.launches == before  # CPU tensors take the plain twin
    assert tuple(got.shape) == (b, c2, 2 * h, 2 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(pk.packed_rgb_to_nhwc(want, 4)), **TOL)
    pair = tpk.packed_conv(tpk.packed_upconv(*args[:3], mode=mode), *args[3:], mode=mode)
    assert torch.equal(got, pair)
    # the mode reaches both convs: neither fp32 nor the other bf16 mode
    for other in ("high", *(m for m, _ in MODES if m != mode)):
        assert not torch.equal(got, tpk.packed_upconv_conv_plain(*args, mode=other))


@pytest.fixture(scope="module")
def rgb_case():
    """The inputs of tests/test_pallas_packed.py's stage-fused RGB test."""
    b, c, c1, c2, h, w = 1, 8, 8, 8, 16, 32
    return dict(
        x=_rand((b, h, w, c), 50), w1=_rand((3, 3, c, c1), 51, 0.2), b1=_rand((c1,), 52),
        w2=_rand((3, 3, c1, c2), 53, 0.2), b2=_rand((c2,), 54),
        rgb_w=_rand((c2, 3), 55, 0.3), rgb_b=_rand((3,), 56),
        prev_w=_rand((c, 3), 57, 0.3), prev_b=_rand((3,), 58))


@pytest.mark.parametrize("emit_uint8,alpha", [(False, 0.4), (True, 1.0)])
@pytest.mark.parametrize("mode,jax_mode", MODES)
def test_upconv_conv_rgb_bf16_twin_matches_pallas(rgb_case, mode, jax_mode, emit_uint8, alpha):
    """B11's twin at ``mode`` against pk.packed_upconv_conv_rgb, fp32 and
    uint8 out, and against the pair's twins at the mode, bit for bit."""
    k = rgb_case
    b, h, w, _ = k["x"].shape
    want = pk.packed_upconv_conv_rgb(
        pk.nhwc_to_phase_blocked(jnp.asarray(k["x"]), 2),
        *(jnp.asarray(k[n]) for n in ("w1", "b1", "w2", "b2", "rgb_w", "rgb_b",
                                       "prev_w", "prev_b")),
        jnp.float32(alpha), 2, mode=jax_mode, rows_per_step=8, interpret=True,
        emit_uint8=emit_uint8)
    args = (_nchw(k["x"]), _oihw(k["w1"]), _t(k["b1"]), _oihw(k["w2"]), _t(k["b2"]),
            _t(k["rgb_w"].T), _t(k["rgb_b"]), _t(k["prev_w"].T), _t(k["prev_b"]))
    got = tpk.packed_upconv_conv_rgb(*args, alpha, emit_uint8=emit_uint8, mode=mode).numpy()
    assert got.shape == (b, 2 * h, 2 * w, 3)
    if emit_uint8:
        want = np.asarray(pk.packed_u32_to_nhwc_uint8(want, 4))
        assert got.dtype == want.dtype == np.uint8
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert d.max() <= 1 and np.mean(d != 0) <= UINT8_MAX_SHARE, (d.max(), np.mean(d != 0))
    else:
        want = np.asarray(pk.packed_rgb_to_nhwc(want, 4))
        d = np.abs(got - want)
        beyond = d > TOL["atol"] + TOL["rtol"] * np.abs(want)
        assert np.mean(beyond) <= RGB_FLIP_SHARE and d.max() <= RGB_FLIP_ATOL, (
            np.mean(beyond), d.max())
    feats, rgb_prev = tpk.packed_upconv(*args[:3], rgb_w=args[7], rgb_b=args[8], mode=mode)
    pair = tpk.packed_conv_rgb(feats, *args[3:7], rgb_prev, alpha, emit_uint8=emit_uint8,
                               mode=mode).numpy()
    np.testing.assert_array_equal(got, pair)


@pytest.mark.parametrize("mode", ["exact6", "emulate_bf16", "bf16", None])
def test_unknown_modes_raise(mode):
    """The wrappers and their twins take TRAIN_MODES only: the TPU kernels'
    test aids and any other name raise ValueError, on the CPU and before
    any launch on the card (meta stands in for it)."""
    x, w1, b1 = torch.zeros(1, 32, 8, 16), torch.zeros(32, 32, 3, 3), torch.zeros(32)
    rgb = (torch.zeros(3, 32), torch.zeros(3), torch.zeros(3, 32), torch.zeros(3), 1.0)
    for dev in ("cpu", "meta"):
        xd, w1d, b1d = x.to(dev), w1.to(dev), b1.to(dev)
        rgbd = tuple(t.to(dev) if isinstance(t, torch.Tensor) else t for t in rgb)
        with pytest.raises(ValueError, match="mode"):
            tpk.packed_upconv_conv(xd, w1d, b1d, w1d, b1d, mode=mode)
        with pytest.raises(ValueError, match="mode"):
            tpk.packed_upconv_conv_rgb(xd, w1d, b1d, w1d, b1d, *rgbd, mode=mode)
    with pytest.raises(ValueError, match="mode"):
        tpk.packed_upconv_conv_plain(x, w1, b1, w1, b1, mode=mode)
    with pytest.raises(ValueError, match="mode"):
        tpk.packed_upconv_conv_rgb_plain(x, w1, b1, w1, b1, *rgb, mode=mode)


def test_fused_bf16_bytes_fit_one_block():
    """fused_bf16_bytes, the kernel's FusedBf16::kBytes (csrc/fused_bf16.cuh):
    at "mid" with 64 channels conv1's staging and conv2's weights share one
    region, or the block would not fit the 232,448 bytes it may have. At 16
    and 8 channels the map is one partial chunk of 32 channels; the figures
    are the ones the source note states."""
    got = {(cout, terms, rgb): tpk.fused_bf16_bytes(cout, terms, rgb)
           for cout in (64, 32, 16, 8) for terms in (1, 2) for rgb in (False, True)}
    assert got == {(64, 1, False): 147_840, (64, 1, True): 148_608,
                   (64, 2, False): 213_760, (64, 2, True): 214_528,
                   (32, 1, False): 109_120, (32, 1, True): 110_656,
                   (32, 2, False): 177_280, (32, 2, True): 178_816,
                   (16, 1, False): 88_640, (16, 1, True): 90_176,
                   (16, 2, False): 156_800, (16, 2, True): 158_336,
                   (8, 1, False): 78_400, (8, 1, True): 79_936,
                   (8, 2, False): 146_560, (8, 2, True): 148_096}
    assert max(got.values()) <= tpk.SMEM_PER_BLOCK
    src = (Path(tpk.__file__).resolve().parent.parent / "csrc" / "fused_bf16.cuh").read_text()
    for cout in (16, 8):
        assert f"{got[(cout, 1, True)]:,} and {got[(cout, 2, True)]:,}" in src
    # conv1's staging alone at Cout 64 "mid": input planes and both parities' taps
    assert 2 * tpk.BF16_ROW * (2 * 6 * 24 + 2 * 8 * 64) == 104_960


def _record_launches(monkeypatch):
    """Replace the device check and the launch by a recorder that counts as
    ``_launch`` does; returns the list of (kernel, counter, args)."""
    launched = []

    def launch(name, x, *args, epilogue=None, counter=None, slab=None):
        launched.append((name, counter or name, args))
        tpk.launches[counter or name] += 1
        if slab is not None and slab < 32:
            key = f"{counter or name}[cout{slab}]"
            tpk.narrow_launches[key] = tpk.narrow_launches.get(key, 0) + 1

    monkeypatch.setattr(tpk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tpk, "_launch", launch)
    return launched


def _spy_pair_and_twins(monkeypatch):
    calls = dict.fromkeys(PAIR + TWINS, 0)
    for name in calls:
        fn = getattr(tpk, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tpk, name, spy)
    return calls


@pytest.mark.parametrize("grade,mode", [("fast", "default"), (None, "default"),
                                        ("fast", "mid"), ("fast", "default+mid")])
def test_stage_fused_bf16_route_on_the_card(grade, mode, monkeypatch):
    """The 1024² generator's stages 7-8 from stage-6 features on meta tensors
    under PROBGAN_STAGE_FUSED=1: one B10 launch at the non-final stage's
    mode and one B11 launch at the final stage's, counted under their bf16
    names; the pair, the plain twins and the fp32 fused kernels never run,
    and nothing raises (the old NotImplementedError is gone)."""
    cfg = tpg.ProGANConfig()
    stage = cfg.num_stages - 1
    s0 = tpg.packed_start_stage(cfg, stage)
    assert (s0, stage) == (7, 8)
    # the default config's stage-7 and stage-8 blocks and toRGBs, on meta
    full = {"blocks": [None] * (s0 - 1) + [
        {n: {"w": torch.empty(cfg.nf(s), cfg.nf(s - 1) if n == "conv1" else cfg.nf(s), 3, 3,
                              device="meta"),
             "b": torch.empty(cfg.nf(s), device="meta")} for n in ("conv1", "conv2")}
        for s in (7, 8)],
        "to_rgb": [None] * 6 + [{"w": torch.empty(3, cfg.nf(s), 1, 1, device="meta"),
                                 "b": torch.empty(3, device="meta")} for s in (6, 7, 8)]}
    monkeypatch.setitem(tpg._PACKED_MODES, grade, mode)
    monkeypatch.setenv("PROBGAN_STAGE_FUSED", "1")
    launched = _record_launches(monkeypatch)
    calls = _spy_pair_and_twins(monkeypatch)
    tpk.reset_launches()
    x = torch.empty(2, cfg.nf(6), 256, 256, device="meta")
    with torch.no_grad():
        out = tpg._g_late_packed(full, x, cfg, s0, stage, 0.5, grade, emit="uint8")
    assert tuple(out.shape) == (2, 1024, 1024, 3) and out.dtype == torch.uint8
    base, final = mode.split("+") if "+" in mode else (mode, mode)
    suffix = {"default": "bf16", "mid": "mid"}
    assert [(n, c) for n, c, _ in launched] == [
        ("packed_upconv_conv_bf16", f"packed_upconv_conv_{suffix[base]}"),
        ("packed_upconv_conv_rgb_bf16", f"packed_upconv_conv_rgb_{suffix[final]}")]
    assert not any(calls.values()), calls
    assert {k: v for k, v in tpk.launches.items() if v} == {
        f"packed_upconv_conv_{suffix[base]}": 1, f"packed_upconv_conv_rgb_{suffix[final]}": 1}
    # each C entry gets its bf16 terms and the bytes of its instantiation
    (_, _, b10), (_, _, b11) = launched
    terms = {"default": 1, "mid": 2}
    assert b10[-7:] == (2, 128, 256, 256, 64, terms[base], tpk.fused_bf16_bytes(64, terms[base],
                                                                             False))
    assert b11[-7:] == (2, 64, 512, 512, 32, terms[final], tpk.fused_bf16_bytes(32, terms[final],
                                                                              True))
    assert len(b10) + 1 == len(tpk._ARGTYPES["packed_upconv_conv_bf16"])
    assert len(b11) + 1 == len(tpk._ARGTYPES["packed_upconv_conv_rgb_bf16"])
    assert b11[11] == 1  # emit_uint8
    tpk.reset_launches()


def test_fused_bf16_wrapper_arguments(monkeypatch):
    """What B11's bf16 wrapper hands its launch (meta stands in for the
    card): alpha, emit_uint8, no tally, then the shapes, the terms and the
    bytes; B10 on a tensor with C % 8 != 0 raises before any launch (C % 32
    is no longer needed: a last chunk of C % 32 channels is staged with
    zeros)."""
    captured = []
    monkeypatch.setattr(tpk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tpk, "_bf16_launch",
                        lambda name, terms, x, *args, **kw: captured.append((name, terms, args)))

    def meta(*shape):
        return torch.zeros(shape, device="meta")

    with torch.no_grad():
        out = tpk.packed_upconv_conv_rgb(meta(1, 64, 8, 16), meta(32, 64, 3, 3), meta(32),
                                         meta(32, 32, 3, 3), meta(32), meta(3, 32), meta(3),
                                         meta(3, 64), meta(3), 0.5, mode="mid")
    assert tuple(out.shape) == (1, 16, 32, 3) and out.dtype == torch.float32
    (name, terms, args), = captured
    assert (name, terms) == ("packed_upconv_conv_rgb", 2)
    assert args[9] == 0.5 and args[11] == 0 and args[12] is None  # alpha, fp32 out, tally
    assert args[13:] == (1, 64, 8, 16, 32, 2, tpk.fused_bf16_bytes(32, 2, True))
    with pytest.raises(ValueError, match="C % 8"):
        tpk.packed_upconv_conv(meta(1, 12, 8, 16), meta(32, 12, 3, 3), meta(32),
                               meta(32, 32, 3, 3), meta(32), mode="default")
    assert len(captured) == 1
