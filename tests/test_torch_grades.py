"""The precision grades and ``dtype`` of the port, on the CPU, against the JAX
package on the same numpy inputs and converted weights.

- Kernel mode "default" (one bf16 pass): each plain twin of
  ``packed_upconv`` / ``packed_conv`` / ``packed_conv_rgb`` against the JAX
  kernel in mode "emulate_bf16" in interpret mode (JAX's own "default" is
  exact fp32 on the CPU, so it is no model of the pass). Both round the same
  fp32 operands to bf16, whose products are exact in fp32: only the order of
  the fp32 sums differs, 2e-5. toRGB of packed_conv_rgb rounds the
  PixelNorm'd features, which the two compute in another order: a feature
  within that reassociation of a bf16 rounding boundary rounds the other way
  in one of them, moving its RGB by |rgb_w| x one bf16 step of the feature.
  So fp32 RGB is held to 2e-5 on all but 2% of values and 2e-2 on the rest,
  uint8 to +-1 on 0.5% of bytes.
- The "fast" grade end to end at the 256² config of
  tests/test_pallas_packed.py (seed 7), against JAX's generator at "fast"
  with its kernel modes set to "emulate_bf16" (the device that test uses):
  uint8 within +-1 on 1% of bytes, and PSNR against the fp32 "high" path
  within 1 dB of JAX's and inside that test's 51-70 dB band.
- ``resolve_precision`` and the two kernel-mode maps, key for key.
- ``dtype=bfloat16``: each package rounds the activations to bf16 at its own
  places, so the port is held to JAX at bf16 by the size of bf16's own
  error: JAX's bf16 images are 46 dB from its fp32 ones on these inputs, the
  port's are held to >= 40 dB from JAX's; logits within 2e-2.
- The TF32 scope: the two switches inside every conv of a forward and of a
  train step's backward, at each grade in turn, and restored after each.
- The unpacked train step at kernel grade "default" and at bf16 against the
  JAX step; the engine and the image trainer CLI at every grade.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from probgan_tpu.engine import train as jtrain
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.cli import train_image as timage_cli
from probgan_tpu_torch.core import convert
from probgan_tpu_torch.core.convert import (
    convert_discriminator_params,
    convert_generator_params,
)
from probgan_tpu_torch.core.tree import tree_leaves
from probgan_tpu_torch.engine import train as ttrain
from probgan_tpu_torch.engine.image import ImageGANEngine
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk
from tests.test_torch_bf16_ring import (  # noqa: F401 (recorded: the wrappers on meta tensors)
    _meta,
    recorded,
)

TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(resolution=32, latent_dim=8, fmap_base=64, fmap_max=16)
TINY = dict(resolution=16, latent_dim=8, fmap_base=64, fmap_max=16)
GRADES = (None, "default", "fast", "high", "highest")


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


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


def _numpy_params(init, jcfg, seed):
    """numpy N(0, 1) weights and N(0, 0.1) biases in the tree of ``init``."""
    shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.key(0))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                   * (1.0 if len(a.shape) > 1 else 0.1)).astype(np.float32),
                        shapes)


def _psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return 10 * np.log10(255.0**2 / mse) if mse else float("inf")


def _assert_uint8_close(got, want, max_share):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and np.mean(d != 0) <= max_share, (d.max(), np.mean(d != 0))


# -- kernel mode "default": the twins against the JAX kernels ------------------

def test_upconv_default_twin_matches_pallas_emulate_bf16():
    """B1 at "default", with the toRGB of its input: the taps are pre-summed
    in fp32, then rounded (bf16(w_a + w_b)), as JAX's prep_upconv_weights."""
    b, c, cout, h, w = 2, 8, 4, 8, 16
    x, wgt, bias = _rand((b, h, w, c), 4), _rand((3, 3, c, cout), 5, 0.2), _rand((cout,), 6)
    rgb_w, rgb_b = _rand((c, 3), 7, 0.3), _rand((3,), 8)
    want, want_rgb = pk.packed_upconv(
        _phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2, mode="emulate_bf16",
        rows_per_step=4, interpret=True, rgb_w=jnp.asarray(rgb_w), rgb_b=jnp.asarray(rgb_b))
    got, got_rgb = tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias),
                                     rgb_w=torch.from_numpy(rgb_w.T.copy()),
                                     rgb_b=torch.from_numpy(rgb_b), mode="default")
    np.testing.assert_allclose(_nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 4)), **TOL)
    np.testing.assert_allclose(
        _nhwc(got_rgb), np.asarray(pk.packed_rgb_to_nhwc(want_rgb, 2))[..., :3], **TOL)
    # the grade is not the fp32 one
    fp32 = tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias))
    assert not np.allclose(_nhwc(got), _nhwc(fp32), atol=1e-3)


def test_conv_default_twin_matches_pallas_emulate_bf16():
    b, c, cout, h, w = 2, 8, 8, 16, 32
    x, wgt, bias = _rand((b, h, w, c), 0), _rand((3, 3, c, cout), 1, 0.2), _rand((cout,), 2)
    want = pk.packed_conv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2,
                          mode="emulate_bf16", interpret=True)
    got = tpk.packed_conv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), mode="default")
    np.testing.assert_allclose(_nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 2)), **TOL)


@pytest.mark.parametrize("emit_uint8,alpha", [(False, 0.3), (True, 1.0)])
def test_conv_rgb_default_twin_matches_pallas_emulate_bf16(emit_uint8, alpha):
    b, c, cout, h, w, p = 1, 8, 8, 32, 64, 4
    x, wgt, bias = _rand((b, h, w, c), 12), _rand((3, 3, c, cout), 13, 0.2), _rand((cout,), 14)
    rgb_w, rgb_b = _rand((cout, 3), 15, 0.3), _rand((3,), 16)
    prev = _rand((b, h // 2, w // 2, 3), 17)
    prev8 = np.pad(prev, ((0, 0), (0, 0), (0, 0), (0, 5)))
    want = pk.packed_conv_rgb(
        _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias), jnp.asarray(rgb_w),
        jnp.asarray(rgb_b), _phase_blocked(prev8, p // 2), jnp.float32(alpha), p,
        mode="emulate_bf16", interpret=True, emit_uint8=emit_uint8)
    got = tpk.packed_conv_rgb(
        _nchw(x), _oihw(wgt), torch.from_numpy(bias), torch.from_numpy(rgb_w.T.copy()),
        torch.from_numpy(rgb_b), _nchw(prev), alpha, emit_uint8=emit_uint8,
        mode="default").numpy()
    if emit_uint8:
        _assert_uint8_close(got, np.asarray(pk.packed_u32_to_nhwc_uint8(want, p)), 5e-3)
    else:
        d = np.abs(got - np.asarray(pk.packed_rgb_to_nhwc(want, p)))
        assert np.mean(d > 2e-5) <= 0.02 and d.max() <= 2e-2, (np.mean(d > 2e-5), d.max())


def test_kernel_modes_the_port_does_not_have_raise():
    """The TPU kernels' test aids are no modes of the port (ValueError).
    "default" (one bf16 pass) and "mid" (the 2-term split) run at every
    epilogue, "mid" between "default" and fp32 in accuracy; "default" is the
    fp32 conv of the operands rounded to bf16."""
    x, w, b = torch.zeros(1, 8, 16, 32), torch.zeros(8, 8, 3, 3), torch.zeros(8)
    xr, wr = torch.from_numpy(_rand((1, 8, 16, 32), 60)), torch.from_numpy(_rand((8, 8, 3, 3), 61))
    fp32 = tpk.packed_conv(xr, wr, b, "none")
    mid_err = (tpk.packed_conv(xr, wr, b, "none", mode="mid") - fp32).abs().max()
    xb, wb = (t.to(torch.bfloat16).float() for t in (xr, wr))
    default_err = (tpk.packed_conv(xb, wb, b, "none") - fp32).abs().max()  # one bf16 pass
    # "mid" drops the weights' rounding alone: x times the rounded weights
    assert (tpk.packed_conv(xr, wr, b, "none", mode="mid")
            - tpk.packed_conv(xr, wb, b, "none")).abs().max() < 1e-4 * fp32.abs().max()
    assert 0 < mid_err < default_err
    for aid in ("exact6", "emulate_bf16"):
        with pytest.raises(ValueError, match="test aid"):
            tpk.packed_upconv(x, w, b, mode=aid)
    assert torch.equal(tpk.packed_conv(xr, wr, b, "none", mode="default"),
                       tpk.packed_conv(xb, wb, b, "none"))
    assert torch.equal(tpk.packed_conv(x, w, b, mode="high"), tpk.packed_conv(x, w, b,
                                                                               mode="highest"))


def test_bf16_weight_layouts_and_shared_memory(recorded):
    """The layouts the bf16 kernels read, by their index formulas
    (csrc/packed_conv_bf16.cu, packed_upconv_bf16.cu): word pairs of bf16
    [C/32][tap][Cout][40] with the 8 pad entries zero, the upconv's taps
    pre-summed in fp32 and then rounded; the shared memory the wrappers pass
    is the kernels' (the rings of B2/B3/B5 and B1, bf16_ring.cuh
    ConvBf16Ring / UpconvBf16Ring::kBytes, the figures its note states: B3's
    wrapper launches B2's ring bytes at one slab of all Cout)."""
    cout, c = 8, 64
    w = torch.from_numpy(_rand((cout, c, 3, 3), 40))
    got = tpk.conv_bf16_weights(w).float()
    for o, ci, ky, kx in [(0, 0, 0, 0), (7, 63, 2, 2), (3, 33, 1, 2), (5, 31, 2, 0)]:
        assert got[ci // 32, ky * 3 + kx, o, ci % 32] == w[o, ci, ky, kx].to(torch.bfloat16).float()
    assert not got[..., 32:].any() and tuple(got.shape) == (2, 9, cout, 40)
    par = tpk.parity_weights(w)
    up = tpk.upconv_bf16_weights(w).float()
    for py, px, dy, dx, o, ci in [(0, 0, 0, 0, 0, 0), (1, 1, 1, 1, 7, 63), (0, 1, 1, 0, 2, 40)]:
        assert up[py, ci // 32, px, dy * 2 + dx, o, ci % 32] == par[py, px, o, ci, dy, dx].to(
            torch.bfloat16).float()
    assert not up[..., 32:].any() and tuple(up.shape) == (2, 2, 2, 4, cout, 40)
    with torch.no_grad():
        for co in (64, 32):
            tpk.packed_conv_rgb(_meta(2, co, 64, 64), _meta(co, co, 3, 3), _meta(co),
                                _meta(3, co), _meta(3), _meta(2, 3, 32, 32), 1.0,
                                emit_uint8=True, mode="default")
    assert [(name, args[-1]) for name, args in recorded] == [
        ("packed_conv_rgb_bf16", tpk.bf16_ring_bytes(co)) for co in (64, 32)]
    assert [tpk.bf16_ring_bytes(co) for co in (64, 32)] == [195_584, 231_424]
    assert [tpk.bf16_upconv_ring_bytes(co) for co in (64, 32)] == [207_360, 219_648]


# -- the "fast" grade end to end ---------------------------------------------

def test_fast_generator_matches_jax_emulated(monkeypatch):
    kw = dict(resolution=256, latent_dim=64, fmap_base=1024, fmap_max=64)
    jcfg, tcfg = jpg.ProGANConfig(**kw), tpg.ProGANConfig(**kw)
    stage = jcfg.num_stages - 1
    assert tpg.packed_start_stage(tcfg, stage) == 6
    init = jax.jit(jpg.init_generator, static_argnums=1)
    params = jax.tree.map(np.asarray, init(jax.random.key(7), jcfg))
    # the first latent of that test's pair
    z = np.asarray(jax.random.normal(jax.random.key(8), (2, jcfg.latent_dim), jnp.float32))[:1]
    tparams, zt = convert_generator_params(params), torch.from_numpy(z.copy())
    for key in list(jpg._PACKED_MODES):
        monkeypatch.setitem(jpg._PACKED_MODES, key, "emulate_bf16")

    def jax_render(precision, packed):  # traced here, with the modes set above
        fn = jax.jit(lambda p, zz: jpg.generator_apply(p, zz, jcfg, stage, 1.0, jnp.float32,
                                                        precision, packed=packed))
        return np.asarray(fn(params, jnp.asarray(z)))

    j_fast, j_high = jax_render("fast", True), jax_render("high", False)
    t_fast = tpg.generator_apply(tparams, zt, tcfg, stage, 1.0, precision="fast",
                                 packed=True).numpy()
    t_high = tpg.generator_apply(tparams, zt, tcfg, stage, 1.0, precision="high").numpy()
    _assert_uint8_close(t_fast, j_fast, 1e-2)
    j_psnr, t_psnr = _psnr(j_fast, j_high), _psnr(t_fast, t_high)
    assert abs(t_psnr - j_psnr) <= 1.0 and 51.0 < t_psnr < 70.0, (t_psnr, j_psnr)


# -- the grade ladder -----------------------------------------------------------

def test_resolve_precision_and_mode_maps_match_jax():
    def name(v):
        return None if v is None else v.name

    for grade in GRADES:
        assert name(tpg.resolve_precision(grade)) == name(jpg.resolve_precision(grade))
    for member in tpg.Precision:
        assert tpg.resolve_precision(member) is member
        assert jpg.resolve_precision(getattr(jax.lax.Precision, member.name)).name == member.name
    with pytest.raises(ValueError, match="precision"):
        tpg.resolve_precision("bogus")

    def keys(table):
        return {k if k is None or isinstance(k, str) else f"P.{k.name}": v
                for k, v in table.items()}

    assert keys(tpg._PACKED_MODES) == keys(jpg._PACKED_MODES)
    assert keys(tpg._PACKED_MODES_D) == keys(jpg._PACKED_MODES_D)
    assert [tpg.tf32_allowed(g) for g in GRADES] == [True, True, False, False, False]


# -- dtype bfloat16 -------------------------------------------------------------

def test_bf16_dtype_matches_jax(monkeypatch):
    jcfg, tcfg = jpg.ProGANConfig(**SMALL), tpg.ProGANConfig(**SMALL)
    stage = jcfg.num_stages - 1
    g, d = _numpy_params(jpg.init_generator, jcfg, 1), _numpy_params(jpg.init_discriminator,
                                                                      jcfg, 2)
    tg, td = convert_generator_params(g), convert_discriminator_params(d)
    z = _rand((4, 8), 3)
    want = np.asarray(jax.jit(lambda p, zz: jpg.generator_apply(
        p, zz, jcfg, stage, 0.7, jnp.bfloat16))(g, jnp.asarray(z)))
    got = tpg.generator_apply(tg, torch.from_numpy(z), tcfg, stage, 0.7, torch.bfloat16)
    assert got.dtype == torch.uint8 and _psnr(got.numpy(), want) >= 40.0
    rgb = tpg.generator_rgb(tg, torch.from_numpy(z), tcfg, stage, 0.7, torch.bfloat16)
    assert rgb.dtype == torch.bfloat16
    img = np.random.RandomState(4).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: jpg.discriminator_apply(
        p, x, jcfg, stage, 0.6, jnp.bfloat16))(d, jnp.asarray(img))).astype(np.float32)
    got = tpg.discriminator_apply(td, torch.from_numpy(img), tcfg, stage, 0.6, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)
    # bf16 never takes the packed path (its gate is fp32 only, as in JAX):
    # with the packed gate open at every stage, fp32 enters it and bf16 not
    monkeypatch.setattr(tpg, "packed_start_stage", lambda config, st: 1)

    def entered(*args, **kwargs):
        raise LookupError("packed path")

    monkeypatch.setattr(tpg, "_g_late_packed", entered)
    with pytest.raises(LookupError):
        tpg.generator_apply(tg, torch.from_numpy(z), tcfg, stage, packed=True)
    tpg.generator_apply(tg, torch.from_numpy(z), tcfg, stage, dtype=torch.bfloat16, packed=True)


# -- the TF32 scope --------------------------------------------------------------

class ConvSpy(TorchDispatchMode):
    """Records both TF32 switches at every convolution that reaches the
    dispatcher: F.conv2d's forward and autograd's convolution_backward."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.convolution,
                                   torch.ops.aten.convolution_backward):
            self.seen.append((func.overloadpacket.__name__, torch.backends.cudnn.allow_tf32,
                              torch.backends.cuda.matmul.allow_tf32))
        return func(*args, **(kwargs or {}))


def test_tf32_scope_holds_through_forward_and_backward():
    """At each grade in turn, in an order where an fp32 grade follows a TF32
    one and the reverse: every conv of ``generator_apply`` and every conv of
    a train step, its backward's included (``autograd.grad`` runs after the
    forward has returned), sees the grade's switches; after each call both
    are back to what they were before it."""
    cfg = tpg.ProGANConfig(**TINY)
    g = tpg.init_generator(cfg, 0)
    state = ttrain.progan_init_state(0, cfg, device="cpu")
    real, z = torch.from_numpy(_rand((2, 8, 8, 3), 5)), torch.from_numpy(_rand((2, 8), 6))
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for before, grade in itertools.product((True, False),
                                               (None, "high", "default", "highest", "fast")):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = before
            with ConvSpy() as spy:
                tpg.generator_apply(g, z, cfg, 2, precision=grade)
            on = tpg.tf32_allowed(grade)
            assert spy.seen and {s[1:] for s in spy.seen} == {(on, on)}
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
                before, before)
        for mode in ("default", "highest", "default", "high"):
            with ConvSpy() as spy:
                ttrain.progan_train_step(state, real, z, 0.5, cfg, 1, remat=False,
                                         packed_train_mode=mode)
            on = mode == "default"
            assert {s[0] for s in spy.seen} == {"convolution", "convolution_backward"}
            assert {s[1:] for s in spy.seen} == {(on, on)}, mode
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
                False, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# -- the unpacked train step, the engine and the trainer at the grades ---------------

@pytest.mark.parametrize("grade", ["default", "bf16"])
def test_unpacked_train_step_matches_jax(grade):
    """The unpacked step at kernel grade "default" and at dtype bf16. At
    "default" the step takes TF32, which the CPU does not have: there it is
    the fp32 step, bit for bit ("highest", which tests/test_torch_train.py
    holds to the JAX step). At bf16 it is held to the JAX step at bf16: bf16
    gradients of this random 16² GAN are about 6% (L2) from the fp32 ones in
    either package, up to half a leaf's largest entry in a leaf, and JAX's
    bf16 losses are 2.6e-3 from its fp32 ones; so the losses are held to 1e-2
    and the gradients as one vector, within 15% (L2) of JAX's at cosine >=
    0.99 (measured: 5-6%, 0.998)."""
    stage = 2
    cfg, jcfg = tpg.ProGANConfig(**TINY), jpg.ProGANConfig(**TINY)
    real, z = _rand((2, 16, 16, 3), 24), _rand((2, 8), 25)
    batch = (torch.from_numpy(real), torch.from_numpy(z), 0.4, cfg, stage)
    if grade == "default":
        state = ttrain.progan_init_state(0, cfg, device="cpu")
        after, m = ttrain.progan_train_step(state, *batch, packed_train_mode="default")
        fp32, m32 = ttrain.progan_train_step(state, *batch, packed_train_mode="highest")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(after), tree_leaves(fp32)))
        assert all(torch.equal(m[k], m32[k]) for k in m)
        return
    jstate = jtrain.progan_init_state(jax.random.key(0), jcfg)
    state = convert.convert_progan_train_state(jstate)
    jafter, jm = jtrain.progan_train_step(
        jstate, jnp.asarray(real), jnp.asarray(z), jnp.float32(0.4), jcfg, stage,
        dtype=jnp.bfloat16)
    after, m = ttrain.progan_train_step(state, *batch, dtype=torch.bfloat16)
    for name in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-2, err_msg=name)
    want = convert.convert_progan_train_state(jafter)
    for got_tree, want_tree in ((after.d_opt[0].mu, want.d_opt[0].mu),
                                (after.g_opt[0].mu, want.g_opt[0].mu)):
        got, ref = tree_leaves(got_tree), tree_leaves(want_tree)
        assert all(a.dtype == torch.float32 for a in got)
        u, v = torch.cat([a.flatten() for a in got]), torch.cat([b.flatten() for b in ref])
        assert (u - v).norm() <= 0.15 * v.norm() and u @ v >= 0.99 * u.norm() * v.norm()


def test_engine_serves_every_grade_and_bf16():
    """The engine on the CPU (unpacked) at every grade gives the fp32 images
    (TF32 does not exist there), scores and walks; at dtype bf16 its images
    stay within bf16's error of them and its logits are fp32 numpy."""
    cfg = tpg.ProGANConfig(**SMALL)
    ref = ImageGANEngine(cfg, device="cpu", seed=1, precision="high")
    z = ref.sample_latents(2)
    img = ref.generate(z)
    reals = img.astype(np.float32) / 127.5 - 1.0
    for grade in GRADES:
        e = ImageGANEngine(cfg, g_params=ref.g_params, d_params=ref.d_params, device="cpu",
                           precision=grade)
        np.testing.assert_array_equal(e.generate(z), img)
        assert e.score(reals).shape == (2,) and e.latent_walk(z[0], z[1], frames=3).shape[0] == 3
    e = ImageGANEngine(cfg, g_params=ref.g_params, d_params=ref.d_params, device="cpu",
                       dtype=torch.bfloat16)
    assert _psnr(e.generate(z), img) >= 30.0
    logits = e.score(reals)
    assert logits.dtype == np.float32
    np.testing.assert_allclose(logits, ref.score(reals), atol=5e-2, rtol=5e-2)


def test_image_trainer_bf16_trains(tmp_path, capsys):
    """``--bf16`` trains the unpacked path to the end, losses finite."""
    out_dir = str(tmp_path / "bf16")
    assert timage_cli.main(["--synthetic", "8", "--resolution", "16", "--latent_dim", "8",
                            "--fmap_base", "64", "--fmap_max", "16", "--epochs_per_stage", "1",
                            "--batch_size", "4", "--device", "cpu", "--bf16",
                            "--output_dir", out_dir]) == 0
    assert "Training complete!" in capsys.readouterr().out
