"""The port's generator (probgan_tpu_torch/models/pro_gan.py) against the JAX
package's, on the CPU, from the same numpy inputs and converted weights.

Tolerances: primitives and fp32 features to float reassociation (1e-5 to
2e-4, stated per test); uint8 images within +-1 on at most 0.1% of bytes
(tanh landing on a rounding boundary). JAX runs its fp32 grade
("highest"), its Pallas kernels in interpret mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.models import pro_gan as jpg
from probgan_tpu_torch.core.convert import convert_generator_params
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops.fused_upconv import upsample2x_conv3x3

SMALL = dict(resolution=64, latent_dim=16, fmap_base=64, fmap_max=32)
# The packed-gate config of tests/test_pallas_packed.py: stages 6-7 packed.
PACKED = dict(resolution=512, latent_dim=16, fmap_base=512, fmap_max=64)


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(
        np.float32
    )


def _assert_uint8_close(got, want, max_share=1e-3):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d != 0) <= max_share, np.mean(d != 0)


def _both(kw, seed=0):
    """(JAX config, port config, JAX params, port params): numpy N(0,1)
    weights and N(0, 0.1) biases in the JAX package's tree (shapes from
    jpg.init_generator), converted for the port."""
    jcfg, tcfg = jpg.ProGANConfig(**kw), tpg.ProGANConfig(**kw)
    shapes = jax.eval_shape(lambda k: jpg.init_generator(k, jcfg), jax.random.key(0))
    rng = np.random.RandomState(seed)
    jparams = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * (1.0 if len(s.shape) > 1 else 0.1))
        .astype(np.float32), shapes)
    return jcfg, tcfg, jparams, convert_generator_params(jparams)


@pytest.fixture(scope="module")
def small_case():
    return _both(SMALL, seed=1)


# -- primitives ---------------------------------------------------------------

def test_primitives_match_jax():
    x = _rand((2, 5, 6, 8), 0, 2.0)  # NHWC for JAX, NCHW for the port
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    np.testing.assert_allclose(
        tpg.lrelu(xt).numpy().transpose(0, 2, 3, 1), np.asarray(jpg.lrelu(x)), atol=0)
    np.testing.assert_allclose(
        tpg.pixel_norm(xt).numpy().transpose(0, 2, 3, 1),
        np.asarray(jpg.pixel_norm(x)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tpg.upsample_nearest_2x(xt).numpy().transpose(0, 2, 3, 1),
        np.asarray(jpg.upsample_nearest_2x(x)))
    _assert_uint8_close(tpg.to_uint8(torch.from_numpy(x)).numpy(),
                        np.asarray(jpg.to_uint8(x)))
    assert tpg.stage_resolution(3) == jpg.stage_resolution(3) == 32
    cfg = tpg.ProGANConfig()
    assert cfg.num_stages == 9 and [cfg.nf(s) for s in (6, 7, 8)] == [128, 64, 32]
    assert tpg._he_scale(9 * 64) == jpg._he_scale(9 * 64)


def _halfway_inputs():
    """Inputs whose denorm (tanh(v) + 1) * 127.5, as the port computes it in
    fp32, lands exactly on k + 0.5."""
    found = []
    for k in range(1, 254):
        t = np.float32((2 * k + 1) / 255.0 - 1.0)
        v = np.float32(np.arctanh(np.float64(t)))
        for v in v + np.arange(-64, 65, dtype=np.float32) * np.spacing(v):
            pre = (torch.tanh(torch.tensor(v)) + 1.0) * 127.5
            if pre.item() == k + 0.5:
                found.append((np.float32(v), k))
                break
    return found


def test_to_uint8_rounds_half_to_even():
    cases = _halfway_inputs()
    ks = np.array([k for _, k in cases])
    assert (ks % 2 == 0).any() and (ks % 2 == 1).any(), "need both parities"
    got = tpg.to_uint8(torch.tensor(np.array([v for v, _ in cases]))).numpy()
    # half to even: k + 0.5 -> k for even k, k + 1 for odd k (roundf would
    # always give k + 1)
    np.testing.assert_array_equal(got, ks + (ks % 2))


def test_fused_upconv_matches_upsample_then_conv():
    w = torch.from_numpy(_rand((16, 8, 3, 3), 1))
    b = torch.from_numpy(_rand((16,), 2))
    x = torch.from_numpy(_rand((2, 8, 6, 7), 3))
    fused = upsample2x_conv3x3(w, b, x)
    ref = torch.nn.functional.conv2d(tpg.upsample_nearest_2x(x), w, b, padding=1)
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), atol=1e-5)


# -- converter ----------------------------------------------------------------

def test_converter_layouts_and_fan_in(small_case):
    jcfg, tcfg, jparams, tparams = small_case
    assert tparams["base_conv"]["w"].shape == (32, 32, 3, 3)  # OIHW
    assert tparams["to_rgb"][2]["w"].shape == (3, 16, 1, 1)
    assert tparams["blocks"][1]["conv1"]["w"].shape == (16, 32, 3, 3)
    assert tparams["base_dense"]["w"].shape == (16, 32 * 16)
    # eq_conv reads the He fan-in from OIHW axes 1-3: same result as JAX
    x = _rand((2, 8, 8, 32), 4)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    for layer, gain in ((jparams["base_conv"], math.sqrt(2.0)), (jparams["to_rgb"][0], 1.0)):
        tlayer = convert_generator_params({**jparams, "base_conv": layer})["base_conv"]
        want = jpg.eq_conv(layer, jnp.asarray(x), gain=gain, precision="highest")
        got = tpg.eq_conv(tlayer, xt, gain=gain)
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    # the base block's HWC reshape of the dense output
    z = _rand((2, 16), 5)
    want = jpg._g_base(jparams, jnp.asarray(z), jcfg, jnp.float32, "highest")
    got = tpg._g_base(tparams, torch.from_numpy(z), tcfg)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


# -- the generator ------------------------------------------------------------

@pytest.mark.parametrize("stage,alpha", [(0, 1.0), (1, 0.5), (2, 1.0), (3, 0.5), (4, 1.0)])
def test_generator_apply_matches_jax(small_case, stage, alpha):
    jcfg, tcfg, jparams, tparams = small_case
    z = _rand((2, 16), 10 + stage)
    want = np.asarray(jpg.generator_apply(jparams, jnp.asarray(z), jcfg, stage, alpha,
                                          precision="highest"))
    got = tpg.generator_apply(tparams, torch.from_numpy(z), tcfg, stage, alpha,
                              precision="highest").numpy()
    _assert_uint8_close(got, want)
    want_rgb = np.asarray(jpg.generator_rgb(jparams, jnp.asarray(z), jcfg, stage, alpha,
                                            precision="highest"))
    got_rgb = tpg.generator_rgb(tparams, torch.from_numpy(z), tcfg, stage, alpha,
                                precision="highest").numpy()
    np.testing.assert_allclose(got_rgb, want_rgb, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def packed_case():
    jcfg, tcfg, jparams, tparams = _both(PACKED, seed=0)
    stage = jcfg.num_stages - 1
    assert jpg.packed_start_stage(jcfg, stage) == tpg.packed_start_stage(tcfg, stage) == 6
    # jitted with alpha traced: one compile serves both alphas
    kw = dict(config=jcfg, stage=stage, precision="highest", packed=True)
    jax_rgb = jax.jit(lambda p, z, a: jpg.generator_rgb(p, z, alpha=a, **kw))
    jax_u8 = jax.jit(lambda p, z, a: jpg.generator_apply(p, z, alpha=a, **kw))
    return jcfg, tcfg, jparams, tparams, stage, _rand((1, 16), 1), jax_rgb, jax_u8


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_packed_slice_matches_jax(packed_case, alpha):
    """The packed slice as a whole: the port on the CPU (plain twins) against
    JAX generator_rgb/generator_apply(packed=True, precision="highest")."""
    jcfg, tcfg, jparams, tparams, stage, z, jax_rgb, jax_u8 = packed_case
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    want = np.asarray(jax_rgb(jparams, zj, jnp.float32(alpha)))
    got = tpg.generator_rgb(tparams, zt, tcfg, stage, alpha, precision="highest",
                            packed=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    want_u8 = np.asarray(jax_u8(jparams, zj, jnp.float32(alpha)))
    got_u8 = tpg.generator_apply(tparams, zt, tcfg, stage, alpha, precision="highest",
                                 packed=True).numpy()
    _assert_uint8_close(got_u8, want_u8)
    # packed and unpacked port paths agree with each other too
    unpacked = tpg.generator_rgb(tparams, zt, tcfg, stage, alpha, precision="high").numpy()
    np.testing.assert_allclose(got, unpacked, rtol=2e-4, atol=2e-4)


def test_packed_gate_matches_jax():
    for kw in (PACKED, SMALL, dict(resolution=1024), dict(resolution=256, latent_dim=64,
                                                             fmap_base=1024, fmap_max=64)):
        jcfg, tcfg = jpg.ProGANConfig(**kw), tpg.ProGANConfig(**kw)
        for stage in range(jcfg.num_stages):
            assert tpg.packed_start_stage(tcfg, stage) == jpg.packed_start_stage(jcfg, stage)
    assert tpg.packed_start_stage(tpg.ProGANConfig(), 8) == 7


@pytest.mark.parametrize("grade", [None, "default", "fast"])
def test_bf16_grades_raise(grade, monkeypatch):
    """The bf16 grades run on every path the port has: the unpacked path,
    the packed two-kernel path (its stages in kernel mode "default", here the
    twins), the stage-fused path (PROBGAN_STAGE_FUSED=1, which raised before
    B10/B11 had the bf16 modes: the same images as the two-kernel path) and
    the differentiable packed path at its bf16 mode "default"."""
    cfg = tpg.ProGANConfig(**PACKED)
    assert tpg.packed_start_stage(cfg, 6) == 6
    params = tpg.init_generator(cfg, 0)
    z = torch.from_numpy(_rand((1, 16), 3))
    for packed in (False, True):
        img = tpg.generator_apply(params, z, cfg, 6, precision=grade, packed=packed)
        assert img.dtype == torch.uint8 and tuple(img.shape) == (1, 256, 256, 3)
    monkeypatch.setenv("PROBGAN_STAGE_FUSED", "1")
    assert torch.equal(tpg.generator_apply(params, z, cfg, 6, precision=grade, packed=True), img)
    monkeypatch.delenv("PROBGAN_STAGE_FUSED")
    rgb = tpg.generator_rgb(params, z, cfg, 6, precision=grade, packed_mode="default")
    assert tuple(rgb.shape) == (1, 256, 256, 3) and torch.isfinite(rgb).all()


def test_fp32_grades_turn_tf32_off(monkeypatch):
    """Inside a call at an fp32 grade both TF32 switches are off (a spy on
    F.conv2d reads them at every conv); after the call they are back as they
    were, whichever they were."""
    cfg = tpg.ProGANConfig(**SMALL)
    params = tpg.init_generator(cfg, 0)
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for before in (True, False):
            for grade in ("high", "highest"):
                torch.backends.cudnn.allow_tf32 = before
                torch.backends.cuda.matmul.allow_tf32 = before
                seen.clear()
                tpg.generator_apply(params, torch.zeros(1, 16), cfg, 1, precision=grade)
                assert seen and set(seen) == {(False, False)}
                assert torch.backends.cudnn.allow_tf32 is before
                assert torch.backends.cuda.matmul.allow_tf32 is before
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# -- the environment switches of the JAX generator ------------------------------

@pytest.mark.parametrize("fuse", ["0", "1"])
@pytest.mark.parametrize("stage", [2, 3])
def test_fuse_upconv_switch_matches_jax(small_case, monkeypatch, fuse, stage):
    """``PROBGAN_FUSE_UPCONV=0`` takes upsample then conv in every stage
    block, as the JAX generator does (tests/test_pro_gan.py:168-196); 1 (the
    default) the fused upsample-into-conv. Both against JAX with the same
    setting, fp32 reassociation only (2e-4)."""
    jcfg, tcfg, jparams, tparams = small_case
    z = _rand((2, 16), 20 + stage)
    monkeypatch.setenv("PROBGAN_FUSE_UPCONV", fuse)
    calls = []
    fused = tpg.upsample2x_conv3x3
    monkeypatch.setattr(tpg, "upsample2x_conv3x3",
                        lambda *a: (calls.append(1), fused(*a))[1])
    want = np.asarray(jpg.generator_rgb(jparams, jnp.asarray(z), jcfg, stage, 0.7,
                                        precision="highest"))
    got = tpg.generator_rgb(tparams, torch.from_numpy(z), tcfg, stage, 0.7,
                            precision="highest").numpy()
    assert len(calls) == (stage if fuse == "1" else 0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# The 256² config of the packed gate test: stage 6 runs on the packed path.
PACKED_256 = dict(resolution=256, latent_dim=16, fmap_base=1024, fmap_max=64)


@pytest.fixture(scope="module")
def packed_256_case():
    jcfg, tcfg, jparams, tparams = _both(PACKED_256, seed=2)
    stage = jcfg.num_stages - 1
    assert jpg.packed_start_stage(jcfg, stage) == tpg.packed_start_stage(tcfg, stage) == 6
    return jcfg, tcfg, jparams, tparams, stage, _rand((1, 16), 3)


def test_fused_uint8_switch_matches_jax(packed_256_case, monkeypatch):
    """``PROBGAN_FUSED_UINT8=0``: the packed generator_apply emits fp32 RGB
    from packed_conv_rgb and denorms it with to_uint8, as the JAX package
    does. Its bytes equal JAX's with the switch off (+-1 where tanh lands on
    a rounding boundary, at most 0.5% of bytes) and the port's own fused
    epilogue's, bit for bit."""
    from probgan_tpu_torch.ops import packed as tpk

    jcfg, tcfg, jparams, tparams, stage, z = packed_256_case
    emitted = []
    conv_rgb = tpk.packed_conv_rgb
    monkeypatch.setattr(tpk, "packed_conv_rgb", lambda *a, emit_uint8=False, **kw: (
        emitted.append(emit_uint8), conv_rgb(*a, emit_uint8=emit_uint8, **kw))[1])
    zt = torch.from_numpy(z)
    fused = tpg.generator_apply(tparams, zt, tcfg, stage, 0.5, precision="highest",
                                packed=True).numpy()
    monkeypatch.setenv("PROBGAN_FUSED_UINT8", "0")
    got = tpg.generator_apply(tparams, zt, tcfg, stage, 0.5, precision="highest",
                              packed=True).numpy()
    assert emitted == [True, False]
    want = np.asarray(jax.jit(lambda p, zz: jpg.generator_apply(
        p, zz, jcfg, stage, 0.5, precision="highest", packed=True))(jparams, jnp.asarray(z)))
    _assert_uint8_close(got, want, max_share=5e-3)
    np.testing.assert_array_equal(got, fused)
