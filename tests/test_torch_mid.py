"""Kernel mode "mid" (the 2-term bf16 split) of the port on the CPU, against
the JAX package on the same numpy inputs.

"mid" rounds the weights to bf16 and splits each activation in two bf16
terms, ``bf16(x) + bf16(x - bf16(x))``: a dot is the rounded weights times x
to ~2^-16, the products exact and summed in fp32.

- Each plain twin at "mid" (B1 "lrelu_norm" with the toRGB of its input and
  "lrelu"; B2 "lrelu_norm", "lrelu" and "none"; B3 fp32 and uint8; B5
  "lrelu" and "none") against the JAX Pallas kernel at "mid" in interpret
  mode, whose CPU dots are exact over the same bf16 operands: the two differ
  by the order of the fp32 sums, 2e-5 of the output's largest entry (uint8
  within +-1 on 0.5% of bytes). Each twin also against an fp32 conv of x with
  the bf16-rounded weights (below 5e-5 of the largest entry: the split drops
  only ~2^-16 of x), as tests/test_pallas_packed.py test_mid_mode_conv_parity.
- ``packed_conv_wgrad`` takes "mid" as the reference does, at fp32: its
  result equals "highest"'s bit for bit; "default" is one bf16 pass: the fp32
  product of the operands rounded to bf16.
- The train step's raw gradients at ``packed_train_mode="mid"`` (both packed
  gates) against the unpacked fp32 step at the JAX test's bounds (cosine above
  0.995 and norm ratio within 0.95-1.05 a leaf; tests/test_packed_vjp.py
  test_train_step_packed_mid_mode_parity, its config).
- The generator's mixes "mid" and "default+mid" against JAX's at the 512²
  config of tests/test_pallas_packed.py test_per_stage_mode_mix_routing (two
  packed stages); JAX's own "default" is exact fp32 on the CPU, so its side
  of the mix runs "emulate_bf16+mid".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from probgan_tpu.models import pro_gan as jpg
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.core.convert import convert_generator_params
from probgan_tpu_torch.core.tree import tree_leaves
from probgan_tpu_torch.engine import train as ttrain
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk
from tests.test_torch_packed import _assert_uint8_close, _nchw, _nhwc, _oihw, _phase_blocked, _rand

REL = 2e-5  # twin vs the JAX kernel, of the output's largest entry
SPLIT_REL = 5e-5  # twin vs fp32 with bf16 weights: the split's ~2^-16 of x


def _assert_rel(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _fp32_bf16w(x, w, b, epilogue):
    """conv3x3 of x with the bf16-rounded weights, fp32, + the epilogue."""
    y = F.conv2d(x, w.to(torch.bfloat16).float(), padding=1) + b[:, None, None]
    return tpk._epilogue(y, epilogue)


@pytest.mark.parametrize("epilogue,with_rgb", [("lrelu_norm", True), ("lrelu", False)])
def test_upconv_mid_twin_matches_pallas(epilogue, with_rgb):
    b, c, cout, h, w = 2, 8, 4, 8, 16
    x, wgt, bias = _rand((b, h, w, c), 80), _rand((3, 3, c, cout), 81, 0.2), _rand((cout,), 82)
    rgb_w, rgb_b = _rand((c, 3), 83, 0.3), _rand((3,), 84)
    kw = dict(rgb_w=jnp.asarray(rgb_w), rgb_b=jnp.asarray(rgb_b)) if with_rgb else {}
    want = pk.packed_upconv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2,
                            mode="mid", rows_per_step=4, interpret=True, epilogue=epilogue, **kw)
    tkw = dict(rgb_w=torch.from_numpy(rgb_w.T.copy()), rgb_b=torch.from_numpy(rgb_b)) \
        if with_rgb else {}
    got = tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), epilogue=epilogue,
                            mode="mid", **tkw)
    if with_rgb:
        (want, want_rgb), (got, got_rgb) = want, got
        _assert_rel(_nhwc(got_rgb), np.asarray(pk.packed_rgb_to_nhwc(want_rgb, 2))[..., :3])
        _assert_rel(got_rgb, F.conv2d(_nchw(x), tkw["rgb_w"].to(torch.bfloat16).float()
                                      [:, :, None, None]) + tkw["rgb_b"][:, None, None],
                    SPLIT_REL)
    _assert_rel(_nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 4)))
    # x unsplit against the pre-summed parity taps, rounded
    taps = tpk.parity_weights(_oihw(wgt)).to(torch.bfloat16).float()
    _assert_rel(got, tpk._epilogue(tpk.parity_conv(taps, torch.from_numpy(bias), _nchw(x)),
                                   epilogue), SPLIT_REL)


@pytest.mark.parametrize("epilogue", ["lrelu_norm", "lrelu", "none"])
def test_conv_mid_twin_matches_pallas(epilogue):
    b, c, cout, h, w = 2, 8, 8, 16, 32
    x, wgt, bias = _rand((b, h, w, c), 70), _rand((3, 3, c, cout), 71, 0.2), _rand((cout,), 72)
    want = pk.packed_conv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2,
                          mode="mid", epilogue=epilogue, interpret=True)
    args = (_nchw(x), _oihw(wgt), torch.from_numpy(bias))
    got = tpk.packed_conv(*args, epilogue, mode="mid")
    _assert_rel(_nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, 2)))
    _assert_rel(got, _fp32_bf16w(*args, epilogue), SPLIT_REL)
    assert not torch.equal(got, tpk.packed_conv(*args, epilogue))  # not the fp32 grade


@pytest.mark.parametrize("epilogue", ["lrelu", "none"])
def test_convpool_mid_twin_matches_pallas(epilogue):
    b, c, cout, h, w, p = 2, 8, 16, 16, 32, 2
    x, wgt, bias = _rand((b, h, w, c), 63), _rand((3, 3, c, cout), 64, 0.2), _rand((cout,), 65)
    want = pk.packed_convpool(_phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias), p,
                              mode="mid", epilogue=epilogue, rows_per_step=8, interpret=True)
    args = (_nchw(x), _oihw(wgt), torch.from_numpy(bias))
    got = tpk.packed_convpool(*args, epilogue, mode="mid")
    _assert_rel(_nhwc(got), np.asarray(pk.packed_rgb_to_nhwc(want, p // 2)))
    _assert_rel(got, F.avg_pool2d(_fp32_bf16w(*args, epilogue), 2), SPLIT_REL)


@pytest.mark.parametrize("emit_uint8,alpha", [(False, 0.3), (True, 1.0)])
def test_conv_rgb_mid_twin_matches_pallas(emit_uint8, alpha):
    b, c, cout, h, w, p = 1, 8, 8, 32, 64, 4
    x, wgt, bias = _rand((b, h, w, c), 12), _rand((3, 3, c, cout), 13, 0.2), _rand((cout,), 14)
    rgb_w, rgb_b = _rand((cout, 3), 15, 0.3), _rand((3,), 16)
    prev = _rand((b, h // 2, w // 2, 3), 17)
    prev8 = np.pad(prev, ((0, 0), (0, 0), (0, 0), (0, 5)))
    want = pk.packed_conv_rgb(
        _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias), jnp.asarray(rgb_w),
        jnp.asarray(rgb_b), _phase_blocked(prev8, p // 2), jnp.float32(alpha), p,
        mode="mid", interpret=True, emit_uint8=emit_uint8)
    args = (_nchw(x), _oihw(wgt), torch.from_numpy(bias), torch.from_numpy(rgb_w.T.copy()),
            torch.from_numpy(rgb_b), _nchw(prev), alpha)
    got = tpk.packed_conv_rgb(*args, emit_uint8=emit_uint8, mode="mid").numpy()
    if emit_uint8:
        _assert_uint8_close(got, np.asarray(pk.packed_u32_to_nhwc_uint8(want, p)), 5e-3)
    else:
        _assert_rel(got, np.asarray(pk.packed_rgb_to_nhwc(want, p)))
        rounded = [a.to(torch.bfloat16).float() for a in args[1:2] + args[3:4]]
        fp32 = tpk.packed_conv_rgb(args[0], rounded[0], *args[2:3], rounded[1], *args[4:])
        _assert_rel(got, fp32.numpy(), SPLIT_REL)


def test_wgrad_mid_is_fp32_and_default_raises():
    """(The name is kept from when "default" raised.) "mid" is "highest" bit
    for bit; "default" is "highest" on the operands rounded to bf16."""
    x, g = torch.from_numpy(_rand((2, 8, 16, 32), 90)), torch.from_numpy(_rand((2, 16, 16, 32), 91))
    assert torch.equal(tpk.packed_conv_wgrad(x, g, mode="mid"),
                       tpk.packed_conv_wgrad(x, g, mode="highest"))
    default = tpk.packed_conv_wgrad(x, g, mode="default")
    assert torch.equal(default, tpk.packed_conv_wgrad(tpk._bf16(x), tpk._bf16(g), mode="highest"))
    assert not torch.equal(default, tpk.packed_conv_wgrad(x, g, mode="highest"))
    with pytest.raises(ValueError, match="test aid"):
        tpk.packed_conv_wgrad(x, g, mode="exact6")


def test_train_step_mid_gradients_near_fp32():
    """Both packed gates at "mid" against the unpacked fp32 step, on the raw
    gradients of the two losses (a first Adam update is sign-like, so the
    parameters after it are the wrong observable): the JAX test's bounds."""
    cfg = tpg.ProGANConfig(resolution=256, latent_dim=8, fmap_base=1024, fmap_max=64)
    state = ttrain.progan_init_state(0, cfg, device="cpu")
    real = torch.from_numpy(np.tanh(_rand((2, 256, 256, 3), 30)))
    z = torch.from_numpy(_rand((2, 8), 31))
    mid = ttrain.progan_grads(state, real, z, 0.7, cfg, 6, packed_d=True, packed_g=True,
                              packed_train_mode="mid")
    fp32 = ttrain.progan_grads(state, real, z, 0.7, cfg, 6, packed_train_mode="highest")
    for tree_mid, tree_fp32 in zip(mid[:2], fp32[:2]):
        for a, b in zip(tree_leaves(tree_mid), tree_leaves(tree_fp32)):
            a, b = a.double().flatten(), b.double().flatten()
            if a.norm() == 0 and b.norm() == 0:
                continue  # a leaf this stage and alpha do not use
            assert (a @ b) / (a.norm() * b.norm()) > 0.995
            assert 0.95 < a.norm() / b.norm() < 1.05
    for k, v in mid[2].items():
        np.testing.assert_allclose(float(v), float(fp32[2][k]), rtol=1e-2, atol=1e-3)


def _late_stages(monkeypatch, resolution, mode, jax_mode):
    """The packed late stages [6, final] of the generator at "fast" with G's
    packed mode ``mode`` in the port and ``jax_mode`` in JAX, both from the
    port's fp32 stage-5 features on numpy weights (latent 16, fmap_base 512,
    fmap_max 64: the configs of tests/test_pallas_packed.py
    test_per_stage_mode_mix_routing): pre-tanh RGB, NHWC; also the port's
    at "default"."""
    kw = dict(resolution=resolution, latent_dim=16, fmap_base=512, fmap_max=64)
    jcfg, tcfg = jpg.ProGANConfig(**kw), tpg.ProGANConfig(**kw)
    stage = jcfg.num_stages - 1
    s0 = tpg.packed_start_stage(tcfg, stage)
    assert s0 == 6
    shapes = jax.eval_shape(lambda k: jpg.init_generator(k, jcfg), jax.random.key(0))
    rng = np.random.RandomState(5)
    params = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                     * (1.0 if len(a.shape) > 1 else 0.1)).astype(np.float32),
                          shapes)
    tparams = convert_generator_params(params)
    x = tpg._g_trunk(tparams, torch.from_numpy(_rand((1, 16), 6)), tcfg, s0)

    def port(m):
        monkeypatch.setitem(tpg._PACKED_MODES, "fast", m)
        return tpg._g_late_packed(tparams, x, tcfg, s0, stage, 1.0, "fast").numpy()

    monkeypatch.setitem(jpg._PACKED_MODES, "fast", jax_mode)
    want = np.asarray(jpg._g_late_packed(params, jnp.asarray(_nhwc(x)), jcfg, s0, stage, 1.0,
                                         "fast"))
    return port(mode), want, [port(m) for m in ("default", "mid")]


def _uint8(rgb):
    return tpg.to_uint8(torch.tensor(rgb)).numpy().astype(np.float64)


def test_generator_mixes_match_jax(monkeypatch):
    """G's packed modes against JAX's: "mid" at 256² (one packed stage),
    pre-tanh RGB within 1e-4 of the largest entry; "default+mid" at 512²
    (stage 6 in one bf16 pass, emulated on JAX's side, stage 7 at "mid"): a
    stage-6 value on a bf16 rounding boundary can round the other way, so the
    uint8 images are held to 60 dB of each other with at most 1% of bytes
    apart. The mix is neither pure mode."""
    mid, want, _ = _late_stages(monkeypatch, 256, "mid", "mid")
    _assert_rel(mid, want, 1e-4)
    mix, want, pure = _late_stages(monkeypatch, 512, "default+mid", "emulate_bf16+mid")
    a, b = _uint8(mix), _uint8(want)
    assert 10 * np.log10(255.0**2 / np.mean((a - b) ** 2)) >= 60.0
    assert np.mean(a != b) <= 1e-2
    assert not any(np.array_equal(mix, p) for p in pure)
