"""The stage-fused kernels B10 ``packed_upconv_conv`` and B11
``packed_upconv_conv_rgb`` at 16 and 8 output channels, the widths of a
narrow generator's late stages (N: ``ProGANConfig(fmap_base=2048,
fmap_max=256)`` at 1024², packed stages 6-8 at 32, 16 and 8 channels), on
the CPU.

- Each plain twin against the JAX package's fused Pallas kernel in interpret
  mode on the same numpy inputs: B10 at C 32 -> Cout 16 and B11 at C 16 ->
  Cout 8 (N's stages 7 and 8), "highest" to rtol = atol = 2e-5 and
  "default" against JAX's "emulate_bf16" to tests/test_torch_stage_fused_bf16.py's
  bounds; each twin equals the pair's twins composed, bit for bit.
- A generator whose packed stages are 16 and 8 channels from C 32
  (``ProGANConfig(resolution=512, latent_dim=16, fmap_base=1024,
  fmap_max=64)``) under ``PROBGAN_STAGE_FUSED=1`` against JAX's at "highest"
  and "fast": the packed stages from the same stage-5 features, with the
  weights carried across by core/convert.py.
- The route on the card at N, on meta tensors (a CUDA kernel has no CPU
  form): stages 6-8 from stage-5 features launch one B10 at 32, one B10 at
  16 and one B11 at 8 at each kernel mode, counted by width, no kernel of
  the pair and no twin; each launch gets the split and the bytes of its
  width.
On the card the kernels must equal the pair bit for bit at every mode;
chip_smoke.py phase 18 checks that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.models import pro_gan as jpg
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.core.convert import convert_generator_params
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk

TOL = dict(rtol=2e-5, atol=2e-5)
# "default" against "emulate_bf16": tests/test_torch_stage_fused_bf16.py's
# bounds (a feature within fp32 reassociation noise of a bf16 rounding
# boundary rounds the other way and moves its RGB by |rgb_w| x one bf16 step)
RGB_FLIP_SHARE, RGB_FLIP_ATOL = 0.02, 2e-2
UINT8_MAX_SHARE = 0.005
# tests/test_torch_stage_fused.py's bounds of the packed stages at a bf16 grade
BF16_FLIP_SHARE, BF16_FLIP_ATOL = 0.02, 5e-2
NARROW_GEN = dict(resolution=512, latent_dim=16, fmap_base=1024, fmap_max=64)
N_CONFIG = dict(fmap_base=2048, fmap_max=256)
H100_SMS = 132
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


def _assert_rgb(got, want, bf16, share=RGB_FLIP_SHARE, atol=RGB_FLIP_ATOL):
    if not bf16:
        np.testing.assert_allclose(got, want, **TOL)
        return
    d = np.abs(got - want)
    beyond = np.mean(d > TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert beyond <= share and d.max() <= atol, (beyond, d.max())


@pytest.mark.parametrize("mode,jax_mode", [("highest", "highest"), ("default", "emulate_bf16")])
def test_narrow_upconv_conv_twin_matches_pallas(mode, jax_mode):
    """B10 at N's stage 7, C 32 -> Cout 16 (batch 1, 8 x 16 input, P = 2),
    against pk.packed_upconv_conv, and against the pair's twins at the mode,
    bit for bit."""
    b, c, cout, h, w = 1, 32, 16, 8, 16
    x = _rand((b, h, w, c), 170)
    w1, b1 = _rand((3, 3, c, cout), 171, 0.15), _rand((cout,), 172)
    w2, b2 = _rand((3, 3, cout, cout), 173, 0.2), _rand((cout,), 174)
    want = pk.packed_upconv_conv(
        pk.nhwc_to_phase_blocked(jnp.asarray(x), 2), jnp.asarray(w1), jnp.asarray(b1),
        jnp.asarray(w2), jnp.asarray(b2), 2, mode=jax_mode, rows_per_step=4, interpret=True)
    args = (_nchw(x), _oihw(w1), _t(b1), _oihw(w2), _t(b2))
    before = dict(tpk.launches)
    got = tpk.packed_upconv_conv(*args, mode=mode)
    assert tpk.launches == before  # CPU tensors take the plain twin
    assert tuple(got.shape) == (b, cout, 2 * h, 2 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(pk.packed_rgb_to_nhwc(want, 4)), **TOL)
    pair = tpk.packed_conv(tpk.packed_upconv(*args[:3], mode=mode), *args[3:], mode=mode)
    assert torch.equal(got, pair)


@pytest.mark.parametrize("mode,jax_mode,emit_uint8,alpha", [
    ("highest", "highest", True, 1.0), ("default", "emulate_bf16", False, 0.4)])
def test_narrow_upconv_conv_rgb_twin_matches_pallas(mode, jax_mode, emit_uint8, alpha):
    """B11 at N's stage 8, C 16 -> Cout 8 (batch 1, 8 x 16 input, P = 2),
    uint8 at "highest" and fp32 RGB at "default", against
    pk.packed_upconv_conv_rgb, and against the pair's twins, bit for bit."""
    b, c, cout, h, w = 1, 16, 8, 8, 16
    k = dict(x=_rand((b, h, w, c), 180), w1=_rand((3, 3, c, cout), 181, 0.2),
             b1=_rand((cout,), 182), w2=_rand((3, 3, cout, cout), 183, 0.25),
             b2=_rand((cout,), 184), rgb_w=_rand((cout, 3), 185, 0.3), rgb_b=_rand((3,), 186),
             prev_w=_rand((c, 3), 187, 0.3), prev_b=_rand((3,), 188))
    want = pk.packed_upconv_conv_rgb(
        pk.nhwc_to_phase_blocked(jnp.asarray(k["x"]), 2),
        *(jnp.asarray(k[n]) for n in ("w1", "b1", "w2", "b2", "rgb_w", "rgb_b",
                                       "prev_w", "prev_b")),
        jnp.float32(alpha), 2, mode=jax_mode, rows_per_step=4, interpret=True,
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
        _assert_rgb(got, np.asarray(pk.packed_rgb_to_nhwc(want, 4)), bf16=True)
    feats, rgb_prev = tpk.packed_upconv(*args[:3], rgb_w=args[7], rgb_b=args[8], mode=mode)
    pair = tpk.packed_conv_rgb(feats, *args[3:7], rgb_prev, alpha, emit_uint8=emit_uint8,
                               mode=mode).numpy()
    np.testing.assert_array_equal(got, pair)


@pytest.mark.parametrize("grade", ["highest", "fast"])
def test_narrow_fused_generator_matches_jax(grade, monkeypatch):
    """Under PROBGAN_STAGE_FUSED=1, the packed stages 6-7 (16 and 8 channels
    from C 32) of NARROW_GEN from the same stage-5 features: the port's
    twins against JAX's fused path (JAX's kernel mode "emulate_bf16" at
    "fast", as in tests/test_torch_stage_fused.py): fp32 RGB within 2e-5
    ("fast": on all but BF16_FLIP_SHARE of values); and the port's RGB and
    uint8 images equal its two-kernel path's, bit for bit."""
    jcfg, tcfg = jpg.ProGANConfig(**NARROW_GEN), tpg.ProGANConfig(**NARROW_GEN)
    stage = jcfg.num_stages - 1
    s0 = jpg.packed_start_stage(jcfg, stage)
    assert (s0, stage) == (6, 7) == (tpg.packed_start_stage(tcfg, stage), stage)
    assert [tcfg.nf(s) for s in (5, 6, 7)] == [32, 16, 8]
    shapes = jax.eval_shape(lambda key: jpg.init_generator(key, jcfg), jax.random.key(0))
    rng = np.random.RandomState(17)
    jparams = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * (1.0 if len(s.shape) > 1 else 0.1))
        .astype(np.float32), shapes)
    # stage-5 features at 32 x 32 (the stage's own 128 x 128 cut for time)
    entry = np.asarray(jpg.pixel_norm(_rand((1, 32, 32, jcfg.nf(s0 - 1)), 19)))
    alpha = 0.5

    with monkeypatch.context() as mp:  # JAX reads both at trace time
        mp.setenv("PROBGAN_STAGE_FUSED", "1")
        if grade != "highest":
            mp.setitem(jpg._PACKED_MODES, grade, "emulate_bf16")
        want_rgb = np.asarray(jax.jit(
            lambda p, x, a: jpg._g_late_packed(p, x, jcfg, s0, stage, a, grade, emit="rgb"))(
                jparams, jnp.asarray(entry), jnp.float32(alpha)))
    tparams = convert_generator_params(jparams)
    x = _nchw(entry)
    got = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("PROBGAN_STAGE_FUSED", flag)
        got[flag] = (tpg._g_late_packed(tparams, x, tcfg, s0, stage, alpha, grade).numpy(),
                     tpg._g_late_packed(tparams, x, tcfg, s0, stage, alpha, grade,
                                        emit="uint8").numpy())
    rgb, u8 = got["1"]
    assert rgb.shape == want_rgb.shape == (1, 128, 128, 3)
    _assert_rgb(rgb, want_rgb, bf16=grade != "highest", share=BF16_FLIP_SHARE,
                atol=BF16_FLIP_ATOL)
    # the uint8 emit is B11's denorm of that RGB (held against JAX's above)
    assert u8.dtype == np.uint8 and u8.shape == rgb.shape
    np.testing.assert_array_equal(rgb, got["0"][0])
    np.testing.assert_array_equal(u8, got["0"][1])


def _record_launches(monkeypatch):
    """Replace the device check and the launch by a recorder that counts as
    ``_launch`` does (by width too); returns the list of (kernel, counter,
    args, slab)."""
    launched = []

    def launch(name, x, *args, epilogue=None, counter=None, slab=None):
        launched.append((name, counter or name, args, slab))
        tpk.launches[counter or name] += 1
        if slab is not None and slab < 32:
            key = f"{counter or name}[cout{slab}]"
            tpk.narrow_launches[key] = tpk.narrow_launches.get(key, 0) + 1

    monkeypatch.setattr(tpk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tpk, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(tpk, "_launch", launch)
    return launched


@pytest.mark.parametrize("grade,mode", [("high", "highest"), ("fast", "default"),
                                        ("fast", "mid")])
def test_narrow_stage_fused_route_on_the_card(grade, mode, monkeypatch):
    """N's stages 6-8 from stage-5 features on meta tensors under
    PROBGAN_STAGE_FUSED=1 at each kernel mode: one B10 at 32 channels (C 64),
    one B10 at 16 (C 32), one B11 at 8 (C 16), counted under the mode's
    names and at 16 and 8 in narrow_launches; no kernel of the pair and no
    plain twin runs, nothing raises. Each C entry gets its width's split and
    bytes (fp32: fused_split, fused_ring_bytes) or terms and bytes (bf16:
    fused_bf16_bytes)."""
    cfg = tpg.ProGANConfig(**N_CONFIG)
    stage = cfg.num_stages - 1
    s0 = tpg.packed_start_stage(cfg, stage)
    assert (s0, stage) == (6, 8)
    assert [cfg.nf(s) for s in range(5, 9)] == [64, 32, 16, 8]

    def meta(*shape):
        return torch.empty(shape, device="meta")

    params = {"blocks": [None] * (s0 - 1) + [
        {n: {"w": meta(cfg.nf(s), cfg.nf(s - 1) if n == "conv1" else cfg.nf(s), 3, 3),
             "b": meta(cfg.nf(s))} for n in ("conv1", "conv2")} for s in (6, 7, 8)],
        "to_rgb": [None] * 5 + [{"w": meta(3, cfg.nf(s), 1, 1), "b": meta(3)}
                                for s in (5, 6, 7, 8)]}
    monkeypatch.setitem(tpg._PACKED_MODES, grade, mode)
    monkeypatch.setenv("PROBGAN_STAGE_FUSED", "1")
    launched = _record_launches(monkeypatch)
    calls = dict.fromkeys(PAIR + TWINS, 0)
    for name in calls:
        def spy(*args, _fn=getattr(tpk, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tpk, name, spy)
    tpk.reset_launches()
    with torch.no_grad():
        out = tpg._g_late_packed(params, meta(2, 64, 128, 128), cfg, s0, stage, 0.5, grade,
                                 emit="uint8")
    assert tuple(out.shape) == (2, 1024, 1024, 3) and out.dtype == torch.uint8
    assert not any(calls.values()), calls
    terms = tpk.BF16_TERMS.get(mode, 0)
    suffix = {0: "", 1: "_bf16", 2: "_mid"}[terms]
    kernel = "_bf16" if terms else ""
    assert [(n, c, s) for n, c, _, s in launched] == [
        (f"packed_upconv_conv{kernel}", f"packed_upconv_conv{suffix}", 32),
        (f"packed_upconv_conv{kernel}", f"packed_upconv_conv{suffix}", 16),
        (f"packed_upconv_conv_rgb{kernel}", f"packed_upconv_conv_rgb{suffix}", 8)]
    assert {k: v for k, v in tpk.launches.items() if v} == {
        f"packed_upconv_conv{suffix}": 2, f"packed_upconv_conv_rgb{suffix}": 1}
    assert tpk.narrow_launches == {f"packed_upconv_conv{suffix}[cout16]": 1,
                                   f"packed_upconv_conv_rgb{suffix}[cout8]": 1}
    for (name, _, args, _), (c, cout, h, rgb) in zip(
            launched, ((64, 32, 128, False), (32, 16, 256, False), (16, 8, 512, True))):
        assert len(args) + 1 == len(tpk._ARGTYPES[name])  # the stream follows
        if terms:
            assert args[-7:] == (2, c, h, h, cout, terms, tpk.fused_bf16_bytes(cout, terms, rgb))
        else:
            assert args[-9:] == (2, c, h, h, cout, *tpk.fused_split(2, cout, h, h, H100_SMS),
                                 tpk.fused_ring_bytes(cout, rgb))
    tpk.reset_launches()
