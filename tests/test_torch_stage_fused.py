"""The port's stage-fused generator kernels on the CPU: B10
``packed_upconv_conv`` and B11 ``packed_upconv_conv_rgb`` (ops/packed.py),
the ``PROBGAN_STAGE_FUSED`` route of models/pro_gan.py and the engine's
``packed_default`` gate.

Each plain twin is held against the JAX package's Pallas kernel in interpret
mode on the same numpy inputs, as tests/test_pallas_packed.py runs it: fp32 to
rtol = atol = 2e-5 (float reassociation only, the JAX test's own bound
against its reference), uint8 within +-1 on at most 0.5% of bytes (tanh
landing on a rounding boundary). The generator as a whole is held against
JAX's under the same variable at the packed-gate config of
tests/test_pallas_packed.py. On the card the kernels must equal the pair they
replace bit for bit; chip_smoke.py checks that, since a CUDA kernel has no
CPU form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.models import pro_gan as jpg
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.core.convert import convert_generator_params
from probgan_tpu_torch.engine import image as timage
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk

TOL = dict(rtol=2e-5, atol=2e-5)
UINT8_MAX_SHARE = 0.005
# At the bf16 grades (kernel mode "default" against JAX's "emulate_bf16"),
# a value the two packages sum in another order can round to the other bf16
# neighbour, and the RGB then moves by |w| x one bf16 step of it: fp32 RGB is
# held to its fp32 bound on all but BF16_FLIP_SHARE of values and to
# BF16_FLIP_ATOL on the rest (tests/test_torch_grades.py's B3 bound; the
# packed stages alone reached 0.06% and 6.7e-3 here, the whole generator,
# whose stage-5 features already differ by fp32 reassociation, 1.4% and
# 3.2e-2). The whole generator's uint8 images may then differ by more than
# one level where such a flip lands: they are held as tests/test_torch_mid.py
# holds a bf16 mix, >= BF16_PSNR_DB with at most BF16_UINT8_SHARE of bytes
# apart (reached: 3 levels at most, 0.25% of bytes).
BF16_FLIP_SHARE, BF16_FLIP_ATOL = 0.02, 5e-2
BF16_PSNR_DB, BF16_UINT8_SHARE = 60.0, 0.01
# The packed-gate config of tests/test_pallas_packed.py: stages 6-7 packed.
PACKED = dict(resolution=512, latent_dim=16, fmap_base=512, fmap_max=64)
FUSED = ("packed_upconv_conv", "packed_upconv_conv_rgb")
UNFUSED = ("packed_upconv", "packed_conv", "packed_conv_rgb")


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_uint8_close(got, want):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d != 0) <= UINT8_MAX_SHARE, np.mean(d != 0)


def test_upconv_conv_twin_matches_pallas():
    """B10's twin against pk.packed_upconv_conv at the shapes of
    tests/test_pallas_packed.py's stage-fused test (phase-blocked input,
    P = 2)."""
    b, c, c1, c2, h, w = 1, 8, 8, 8, 8, 16
    p_in = 2
    x = _rand((b, h, w, c), 40)
    w1, b1 = _rand((3, 3, c, c1), 41, 0.2), _rand((c1,), 42)
    w2, b2 = _rand((3, 3, c1, c2), 43, 0.2), _rand((c2,), 44)
    want = pk.packed_upconv_conv(
        pk.nhwc_to_phase_blocked(jnp.asarray(x), p_in), jnp.asarray(w1), jnp.asarray(b1),
        jnp.asarray(w2), jnp.asarray(b2), p_in, mode="highest", rows_per_step=4,
        interpret=True)
    before = dict(tpk.launches)
    got = tpk.packed_upconv_conv(_nchw(x), _oihw(w1), _t(b1), _oihw(w2), _t(b2))
    assert tpk.launches == before  # CPU tensors take the plain twin
    assert tuple(got.shape) == (b, c2, 2 * h, 2 * w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(pk.packed_rgb_to_nhwc(want, 2 * p_in)), **TOL)
    # the twin is the pair's twins composed, to the bit
    pair = tpk.packed_conv(tpk.packed_upconv(_nchw(x), _oihw(w1), _t(b1)), _oihw(w2), _t(b2))
    assert torch.equal(got, pair)


@pytest.fixture(scope="module")
def rgb_case():
    """The inputs of tests/test_pallas_packed.py's stage-fused RGB test."""
    b, c, c1, c2, h, w = 1, 8, 8, 8, 16, 32
    x = _rand((b, h, w, c), 50)
    return dict(
        x=x, w1=_rand((3, 3, c, c1), 51, 0.2), b1=_rand((c1,), 52),
        w2=_rand((3, 3, c1, c2), 53, 0.2), b2=_rand((c2,), 54),
        rgb_w=_rand((c2, 3), 55, 0.3), rgb_b=_rand((3,), 56),
        prev_w=_rand((c, 3), 57, 0.3), prev_b=_rand((3,), 58))


@pytest.mark.parametrize("emit_uint8", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 0.4])
def test_upconv_conv_rgb_twin_matches_pallas(rgb_case, alpha, emit_uint8):
    """B11's twin against pk.packed_upconv_conv_rgb, fp32 and uint8 out."""
    k, p_in = rgb_case, 2
    b, h, w, _ = k["x"].shape
    want = pk.packed_upconv_conv_rgb(
        pk.nhwc_to_phase_blocked(jnp.asarray(k["x"]), p_in),
        *(jnp.asarray(k[n]) for n in ("w1", "b1", "w2", "b2", "rgb_w", "rgb_b",
                                       "prev_w", "prev_b")),
        jnp.float32(alpha), p_in, mode="highest", rows_per_step=8, interpret=True,
        emit_uint8=emit_uint8)
    args = (_nchw(k["x"]), _oihw(k["w1"]), _t(k["b1"]), _oihw(k["w2"]), _t(k["b2"]),
            _t(k["rgb_w"].T), _t(k["rgb_b"]), _t(k["prev_w"].T), _t(k["prev_b"]))
    got = tpk.packed_upconv_conv_rgb(*args, alpha, emit_uint8=emit_uint8).numpy()
    assert got.shape == (b, 2 * h, 2 * w, 3)
    if emit_uint8:
        _assert_uint8_close(got, np.asarray(pk.packed_u32_to_nhwc_uint8(want, 2 * p_in)))
    else:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(pk.packed_rgb_to_nhwc(want, 2 * p_in)),
                                   **TOL)
    feats, rgb_prev = tpk.packed_upconv(args[0], args[1], args[2], rgb_w=args[7],
                                        rgb_b=args[8])
    pair = tpk.packed_conv_rgb(feats, args[3], args[4], args[5], args[6], rgb_prev, alpha,
                               emit_uint8=emit_uint8).numpy()
    np.testing.assert_array_equal(got, pair)


@pytest.fixture(scope="module")
def packed_gen():
    """JAX and port generators on the same numpy weights at the packed-gate
    config (the weights and latent of tests/test_torch_pro_gan.py's packed
    slice test), and JAX's fused results by grade with PROBGAN_STAGE_FUSED=1
    set while they trace (JAX reads it at trace time): the packed stages
    alone from the same stage-5 features, and the whole generator. At the
    bf16 grades JAX's kernel mode is set to "emulate_bf16" while it traces
    (its own "default" is exact fp32 on the CPU, no model of the pass)."""
    jcfg, tcfg = jpg.ProGANConfig(**PACKED), tpg.ProGANConfig(**PACKED)
    shapes = jax.eval_shape(lambda k: jpg.init_generator(k, jcfg), jax.random.key(0))
    rng = np.random.RandomState(0)
    jparams = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * (1.0 if len(s.shape) > 1 else 0.1))
        .astype(np.float32), shapes)
    stage = jcfg.num_stages - 1
    s0 = jpg.packed_start_stage(jcfg, stage)
    z = _rand((1, 16), 1)
    entry = np.asarray(jpg.pixel_norm(_rand((1, 128, 128, jcfg.nf(s0 - 1)), 2)))
    want = {}

    def jax_fused(grade):
        """{alpha: (late {"rgb", "uint8"}, (whole rgb, whole uint8))} at
        ``grade``, one jit with alpha traced."""
        if grade in want:
            return want[grade]
        kw = dict(config=jcfg, stage=stage, precision=grade, packed=True)

        def outputs(p, x, zz, a):
            return (jpg._g_late_packed(p, x, jcfg, s0, stage, a, grade, emit="rgb"),
                    jpg._g_late_packed(p, x, jcfg, s0, stage, a, grade, emit="uint8"),
                    jpg.generator_rgb(p, zz, alpha=a, **kw),
                    jpg.generator_apply(p, zz, alpha=a, **kw))

        fn = jax.jit(outputs)
        mp = pytest.MonkeyPatch()
        mp.setenv("PROBGAN_STAGE_FUSED", "1")
        if grade not in ("high", "highest"):
            mp.setitem(jpg._PACKED_MODES, grade, "emulate_bf16")
        try:
            want[grade] = {}
            for alpha in (1.0, 0.5):
                late_rgb, late_u8, rgb, u8 = (np.asarray(o) for o in fn(
                    jparams, jnp.asarray(entry), jnp.asarray(z), jnp.float32(alpha)))
                want[grade][alpha] = {"rgb": late_rgb, "uint8": late_u8}, (rgb, u8)
        finally:
            mp.undo()
        return want[grade]

    return (tcfg, convert_generator_params(jparams), s0, stage, _nchw(entry),
            torch.from_numpy(z), jax_fused)


@pytest.mark.parametrize("alpha", [1.0, 0.5])
@pytest.mark.parametrize("grade", ["highest", "fast", None])
def test_fused_generator_matches_jax(packed_gen, grade, alpha, monkeypatch):
    """Under PROBGAN_STAGE_FUSED=1, the port on the CPU against JAX's fused
    path at each grade. The packed stages from the same stage-5 features:
    fp32 within 2e-5, uint8 within +-1 on 0.5% of bytes. The whole
    generator_rgb / generator_apply(packed=True): its stages 0-5 run XLA's
    convs in JAX and torch's in the port, so it is held to the bound of the
    unfused packed slice in tests/test_torch_pro_gan.py (2e-4) on the same
    weights. At the bf16 grades ("fast" and None) the RGB is held to those
    bounds on all but BF16_FLIP_SHARE of values, the whole generator's uint8
    images by BF16_PSNR_DB and BF16_UINT8_SHARE (see their note)."""
    tcfg, tparams, s0, stage, entry, z, jax_fused = packed_gen
    late, (whole_rgb, whole_u8) = jax_fused(grade)[alpha]
    bf16 = grade not in ("high", "highest")
    monkeypatch.setenv("PROBGAN_STAGE_FUSED", "1")

    def assert_rgb(got, want, tol):
        if not bf16:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
            return
        d = np.abs(got - want)
        beyond = np.mean(d > tol + tol * np.abs(want))
        assert beyond <= BF16_FLIP_SHARE and d.max() <= BF16_FLIP_ATOL, (beyond, d.max())

    got = tpg._g_late_packed(tparams, entry, tcfg, s0, stage, alpha, grade).numpy()
    assert_rgb(got, late["rgb"], TOL["atol"])
    got_u8 = tpg._g_late_packed(tparams, entry, tcfg, s0, stage, alpha, grade,
                                emit="uint8").numpy()
    _assert_uint8_close(got_u8, late["uint8"])
    got = tpg.generator_rgb(tparams, z, tcfg, stage, alpha, precision=grade,
                            packed=True).numpy()
    assert_rgb(got, whole_rgb, 2e-4)
    got_u8 = tpg.generator_apply(tparams, z, tcfg, stage, alpha, precision=grade,
                                 packed=True).numpy()
    if not bf16:
        _assert_uint8_close(got_u8, whole_u8)
        return
    d = got_u8.astype(np.float64) - whole_u8
    assert np.mean(d != 0) <= BF16_UINT8_SHARE, np.mean(d != 0)
    assert 10 * np.log10(255.0**2 / max(np.mean(d**2), 1e-12)) >= BF16_PSNR_DB


def _spy(monkeypatch):
    """Count the calls of the six forward wrappers, twins untouched."""
    calls = dict.fromkeys(FUSED + UNFUSED, 0)
    for name in calls:
        fn = getattr(tpk, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(tpk, name, spy)
    return calls


@pytest.mark.parametrize("grade", ["high", "fast", None])
@pytest.mark.parametrize("stage", [6, 7])
def test_stage_fused_route_is_bit_equal(stage, grade, monkeypatch):
    """"1" and "0" give equal bits on the CPU; "1" calls the fused pair, "0"
    the unfused kernels. At stage 6 (s0 == stage) the fused path is B11
    alone; at stage 7 B10 then B11. The variable is read at each call. At
    the bf16 grades too: "1" no longer raises there."""
    cfg = tpg.ProGANConfig(**PACKED)
    assert tpg.packed_start_stage(cfg, 7) == 6
    params = tpg.init_generator(cfg, 3)
    z = torch.from_numpy(_rand((2, 16), 7))
    calls = _spy(monkeypatch)
    out = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("PROBGAN_STAGE_FUSED", flag)
        before = dict(calls)
        out[flag] = (tpg.generator_rgb(params, z, cfg, stage, 0.7, precision=grade,
                                       packed=True),
                     tpg.generator_apply(params, z, cfg, stage, 0.7, precision=grade,
                                         packed=True))
        out[flag + "calls"] = {k: calls[k] - before[k] for k in calls}
    assert torch.equal(out["1"][0], out["0"][0]) and torch.equal(out["1"][1], out["0"][1])
    n_early = stage - 6  # non-final packed stages
    assert out["1calls"] == {"packed_upconv_conv": 2 * n_early, "packed_upconv_conv_rgb": 2,
                             "packed_upconv": 0, "packed_conv": 0, "packed_conv_rgb": 0}
    assert out["0calls"] == {"packed_upconv_conv": 0, "packed_upconv_conv_rgb": 0,
                             "packed_upconv": 2 * (n_early + 1), "packed_conv": 2 * n_early,
                             "packed_conv_rgb": 2}


def test_fused_wrappers_refuse_gradients_off_the_cpu():
    """Like the other forward wrappers: on a tensor that is not on the CPU
    (meta stands in for the card) a wrapper raises when a gradient is wanted
    instead of returning a result whose gradient would be zero."""
    def t(*shape, grad=False):
        return torch.zeros(shape, device="meta", requires_grad=grad)

    x = t(1, 64, 8, 16, grad=True)
    w1, b1, w2, b2 = t(32, 64, 3, 3), t(32), t(32, 32, 3, 3), t(32)
    with pytest.raises(RuntimeError, match="forward-only"):
        tpk.packed_upconv_conv(x, w1, b1, w2, b2)
    with pytest.raises(RuntimeError, match="forward-only"):
        tpk.packed_upconv_conv_rgb(x, w1, b1, w2, b2, t(3, 32), t(3), t(3, 64), t(3), 1.0)


def test_fused_wrappers_check_shapes():
    """The CUDA-side checks run before any launch: conv2 must be Cout ->
    Cout, and a device other than the CPU or the card is refused."""
    def t(*shape):
        return torch.zeros(shape, device="meta")

    with pytest.raises(ValueError, match="w2"):
        tpk.packed_upconv_conv(t(1, 64, 8, 16), t(32, 64, 3, 3), t(32), t(64, 32, 3, 3), t(32))
    with pytest.raises(RuntimeError, match="meta"):
        tpk.packed_upconv_conv(t(1, 64, 8, 16), t(32, 64, 3, 3), t(32), t(32, 32, 3, 3), t(32))


def test_packed_default_and_escape_hatch(monkeypatch):
    """packed_default: on for a CUDA device unless PROBGAN_PACKED=0, off on
    the CPU; the engine on the CPU takes the unpacked path."""
    monkeypatch.delenv("PROBGAN_PACKED", raising=False)
    assert timage.packed_default(torch.device("cuda", 0)) is True
    assert timage.packed_default("cuda") is True
    assert timage.packed_default(torch.device("cpu")) is False
    monkeypatch.setenv("PROBGAN_PACKED", "0")
    assert timage.packed_default(torch.device("cuda", 0)) is False
    monkeypatch.setenv("PROBGAN_PACKED", "1")
    assert timage.packed_default("cuda") is True
    engine = timage.ImageGANEngine(tpg.ProGANConfig(**PACKED), device="cpu", seed=1)
    assert engine.packed is False


def test_engine_passes_its_gate_to_every_task(monkeypatch):
    """generate, latent_walk and score hand the engine's gate to the model:
    with the gate off no packed wrapper is called, with it on (as on the card,
    here through the CPU twins) the packed wrappers are."""
    cfg = tpg.ProGANConfig(**PACKED)
    engine = timage.ImageGANEngine(cfg, device="cpu", seed=2)
    z = engine.sample_latents(1)
    img = np.random.RandomState(0).uniform(-1, 1, (2, 512, 512, 3)).astype(np.float32)
    calls = _spy(monkeypatch)
    d_packed = []
    real_d = tpg.discriminator_apply

    def d_spy(*args, **kwargs):
        d_packed.append(kwargs.get("packed"))
        return real_d(*args, **kwargs)

    monkeypatch.setattr(tpg, "discriminator_apply", d_spy)
    for packed in (False, True):
        engine.packed = packed
        before = dict(calls)
        engine.generate(z)
        engine.latent_walk(z[0], z[0], frames=2)
        engine.score(img)
        used = sum(calls[k] - before[k] for k in calls)
        assert (used > 0) == packed and d_packed[-1] is packed


def test_fn_helpers_take_the_gate_by_default(monkeypatch):
    """generate_fn, latent_walk_fn and score_fn called without ``packed``
    decide by packed_default of their input's device: on the CPU no packed
    wrapper runs; ``packed=True`` still asks for the packed path."""
    cfg = tpg.ProGANConfig(**PACKED)
    engine = timage.ImageGANEngine(cfg, device="cpu", seed=2)
    z = engine.sample_latents(1)
    img = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (2, 512, 512, 3))
                           .astype(np.float32))
    calls = _spy(monkeypatch)
    stage = cfg.num_stages - 1
    timage.generate_fn(engine.g_params, z, 1.0, cfg, stage)
    timage.latent_walk_fn(engine.g_params, z[0], z[0], 1.0, cfg, stage, frames=2)
    timage.score_fn(engine.d_params, img, 1.0, cfg, stage)
    assert not any(calls.values())
    timage.generate_fn(engine.g_params, z, 1.0, cfg, stage, packed=True)
    assert sum(calls.values()) > 0
