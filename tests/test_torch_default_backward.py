"""Kernel mode "default" of the training backward (one bf16 pass: both
operands of every dot rounded to bf16, to nearest even, the products summed
in fp32) on the CPU, against the JAX package on the same numpy inputs.

JAX's own "default" dots are exact fp32 on the CPU, so it is no model of the
pass there; its kernels' "emulate_bf16" rounds the same operands and runs
exact dots over them (tests/test_torch_grades.py).

- Each "default" twin the backward needs (B1 "lrelu", B2 "lrelu" and
  "none", B5 "lrelu" and "none") against the JAX kernel at "emulate_bf16" in
  interpret mode: the products are exact, so the two differ by the order of
  the fp32 sums, 2e-5 of the output's largest entry.
- ``packed_conv_wgrad_plain`` at "default" against JAX's
  ``packed_conv_wgrad`` at "highest" on inputs rounded to bf16 beforehand
  (JAX's wgrad has no emulation mode: at "emulate_bf16" it runs HIGHEST on
  unrounded operands), 1e-5 of dW's largest entry.
- The four Functions of ``ops/packed_vjp.py`` at "default" (their default
  mode) against ``jax.vjp`` of the JAX custom VJPs at "emulate_bf16", with
  the ``packed_conv_wgrad`` those call patched in this test to round its
  operands (``_patched_wgrad``); the bounds are in the test.
- The 256² step (one packed stage in G and in D) at
  ``packed_train_mode="default"`` (the default) against the JAX step at
  patched "emulate_bf16", and at ``dtype=bfloat16`` with both gates (the
  ``--fast`` math) against the same JAX step; the bounds are in the tests.
- ``--fast`` on the tiny CPU schedule, as tests/test_train.py
  test_image_trainer_fast_preset runs the JAX trainer, and on a schedule that
  reaches a packed stage (its Functions on the twins, at bf16); the
  checkpoint loads in the JAX package.
- The fade-in at bf16 rounds alpha to bf16, as the JAX package does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.core import image_checkpoint as jimage_checkpoint
from probgan_tpu.engine import train as jtrain
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu.ops import packed_vjp as jvjp
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.cli import train_image as timage_cli
from probgan_tpu_torch.core import convert
from probgan_tpu_torch.core.tree import tree_leaves
from probgan_tpu_torch.engine import train as ttrain
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk
from probgan_tpu_torch.ops import packed_vjp as tvjp
from tests.test_torch_packed import _nchw, _nhwc, _oihw, _phase_blocked, _rand

REL = 2e-5  # twin vs the JAX kernel, of the output's largest entry
WGRAD_REL = 1e-5


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _hwio(w_oihw: torch.Tensor) -> np.ndarray:
    return w_oihw.detach().numpy().transpose(2, 3, 1, 0)


def _round_bf16(a):
    return a.astype(jnp.bfloat16).astype(jnp.float32)


def _wgrad_rounding_at_emulate(real):
    def wgrad(x, dpre, p, *, mode="default", **kw):
        if mode == "emulate_bf16":
            x, dpre, mode = _round_bf16(x), _round_bf16(dpre), "highest"
        return real(x, dpre, p, mode=mode, **kw)
    return wgrad


@pytest.fixture
def _patched_wgrad(monkeypatch):
    """JAX's ``packed_conv_wgrad``, as the JAX custom VJPs call it, rounding
    both operands to bf16 at mode "emulate_bf16" and then running HIGHEST:
    the one bf16 pass its "default" is on the TPU. For this test only."""
    monkeypatch.setattr(pk, "packed_conv_wgrad", _wgrad_rounding_at_emulate(pk.packed_conv_wgrad))


# -- the twins against the JAX kernels ------------------------------------------

def test_upconv_lrelu_default_twin_matches_pallas():
    b, c, cout, h, w = 2, 8, 4, 8, 16
    x, wgt, bias = _rand((b, h, w, c), 40), _rand((3, 3, c, cout), 41, 0.2), _rand((cout,), 42)
    want = pk.packed_upconv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2,
                            mode="emulate_bf16", rows_per_step=4, interpret=True,
                            epilogue="lrelu")
    got = tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias), epilogue="lrelu",
                            mode="default")
    assert _rel_err(_nhwc(got), pk.packed_rgb_to_nhwc(want, 4)) <= REL
    assert not torch.equal(got, tpk.packed_upconv(_nchw(x), _oihw(wgt), torch.from_numpy(bias),
                                                  epilogue="lrelu", mode="mid"))


@pytest.mark.parametrize("epilogue", ["lrelu", "none"])
def test_conv_default_twin_matches_pallas(epilogue):
    b, c, cout, h, w = 2, 8, 8, 16, 32
    x, wgt, bias = _rand((b, h, w, c), 43), _rand((3, 3, c, cout), 44, 0.2), _rand((cout,), 45)
    want = pk.packed_conv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2,
                          mode="emulate_bf16", epilogue=epilogue, interpret=True)
    args = (_nchw(x), _oihw(wgt), torch.from_numpy(bias))
    got = tpk.packed_conv(*args, epilogue, mode="default")
    assert _rel_err(_nhwc(got), pk.packed_rgb_to_nhwc(want, 2)) <= REL
    # the fp32 conv of the rounded operands, bit for bit
    assert torch.equal(got, tpk.packed_conv(tpk._bf16(args[0]), tpk._bf16(args[1]), args[2],
                                            epilogue))


@pytest.mark.parametrize("epilogue", ["lrelu", "none"])
def test_convpool_default_twin_matches_pallas(epilogue):
    b, c, cout, h, w, p = 2, 8, 16, 16, 32, 2
    x, wgt, bias = _rand((b, h, w, c), 46), _rand((3, 3, c, cout), 47, 0.2), _rand((cout,), 48)
    want = pk.packed_convpool(_phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias), p,
                              mode="emulate_bf16", epilogue=epilogue, rows_per_step=8,
                              interpret=True)
    args = (_nchw(x), _oihw(wgt), torch.from_numpy(bias))
    got = tpk.packed_convpool(*args, epilogue, mode="default")
    assert _rel_err(_nhwc(got), pk.packed_rgb_to_nhwc(want, p // 2)) <= REL
    # convpool_lrelu's mask recompute: packed_conv "lrelu" at "default" pooled
    assert torch.equal(got, torch.nn.functional.avg_pool2d(
        tpk.packed_conv(*args, epilogue, mode="default"), 2))


@pytest.mark.parametrize("c,cout", [(8, 16), (16, 8)])
def test_wgrad_default_twin_matches_pallas_on_rounded_inputs(c, cout):
    p, b, h, w = 4, 2, 16, 32
    x, g = _rand((b, h, w, c), 49), _rand((b, h, w, cout), 50)
    want = pk.packed_conv_wgrad(_round_bf16(_phase_blocked(x, p)),
                                _round_bf16(_phase_blocked(g, p)), p, mode="highest",
                                interpret=True)
    got = tpk.packed_conv_wgrad(_nchw(x), _nchw(g), mode="default")
    assert _rel_err(_hwio(got), want) <= WGRAD_REL
    fp32 = tpk.packed_conv_wgrad(_nchw(x), _nchw(g), mode="highest")
    assert _rel_err(got, fp32) > WGRAD_REL  # the rounding is there


# -- the four Functions against the JAX custom VJPs --------------------------------

_JAX_VJPS = {"conv_lrelu": (jvjp.conv_lrelu, 1, 1.0),
             "convpool_lrelu": (jvjp.convpool_lrelu, 0.5, 0.5),
             "conv_lrelu_norm": (jvjp.conv_lrelu_norm, 1, 1.0),
             "upconv_lrelu_norm": (jvjp.upconv_lrelu_norm, 2, 2.0)}


@pytest.mark.parametrize("name", list(_JAX_VJPS))
def test_function_default_matches_jax_vjp(name, _patched_wgrad):
    """The forward and (dx, dw, db) at "default", the Functions' default
    mode, against the JAX custom VJP at "emulate_bf16": the output and db
    within 2e-5 of the largest entry (the sums' order); dx and dw within 1e-3.
    The backward rounds the cotangents it recomputes (the PixelNorm
    cotangent, the lrelu mask's product) to bf16, and the two packages
    compute them in other orders: where one lies within an fp32 ulp of a
    bf16 rounding boundary it rounds the other way in one of them, one bf16
    step (2^-8) of that element, which moves the few dx and dw entries it
    reaches by about 2^-8 of its share of them."""
    jax_fn, scale, p_ratio = _JAX_VJPS[name]
    c, cout, p, b, h, w = 8, 16, 2, 2, 16, 32
    x = _rand((b, h, w, c), 51)
    wgt, bias = _rand((3, 3, c, cout), 52, 0.2), _rand((cout,), 53)
    cot = _rand((b, int(h * scale), int(w * scale), cout), 54)
    y_j, vjp_fn = jax.vjp(lambda xp, wg, bi: jax_fn(xp, wg, bi, p, "emulate_bf16"),
                          _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias))
    dx_j, dw_j, db_j = vjp_fn(_phase_blocked(cot, int(p * p_ratio)))

    xt, wt, bt = (t.clone().requires_grad_(True)
                  for t in (_nchw(x), _oihw(wgt), torch.from_numpy(bias)))
    y = getattr(tvjp, name)(xt, wt, bt)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), _nchw(cot))
    assert _rel_err(_nhwc(y.detach()), pk.packed_rgb_to_nhwc(y_j, int(p * p_ratio))) <= REL
    assert _rel_err(db, db_j) <= REL
    assert _rel_err(_nhwc(dx), pk.packed_rgb_to_nhwc(dx_j, p)) <= 1e-3
    assert _rel_err(_hwio(dw), dw_j) <= 1e-3
    # not the fp32 grade
    y32 = getattr(tvjp, name)(_nchw(x), _oihw(wgt), torch.from_numpy(bias), mode="highest")
    assert not torch.equal(y.detach(), y32)


# -- the train step --------------------------------------------------------------

# 256², stage 6: one packed stage in G and in D (8 channels at 256²), batch 2
PACKED = dict(resolution=256, latent_dim=8, fmap_base=512, fmap_max=16)


@pytest.fixture(scope="module")
def _steps():
    """The JAX step at "emulate_bf16" (its wgrad patched as above, for this
    one trace) and the port's at the default mode, "default", in fp32 and in
    bf16, from one converted state and one numpy batch: (metrics, state
    after) each."""
    stage = 6
    cfg, jcfg = tpg.ProGANConfig(**PACKED), jpg.ProGANConfig(**PACKED)
    jstate = jtrain.progan_init_state(jax.random.key(0), jcfg)
    state = convert.convert_progan_train_state(jstate)
    real, z = np.tanh(_rand((2, 256, 256, 3), 55)), _rand((2, 8), 56)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "packed_conv_wgrad", _wgrad_rounding_at_emulate(pk.packed_conv_wgrad))
        jafter, jm = jtrain.progan_train_step(
            jstate, jnp.asarray(real), jnp.asarray(z), jnp.float32(0.7), jcfg, stage,
            packed_d=True, packed_g=True, packed_train_mode="emulate_bf16")
    out = {"jax": (jm, convert.convert_progan_train_state(jafter))}
    for dtype in (torch.float32, torch.bfloat16):
        out[dtype] = ttrain.progan_train_step(
            state, torch.from_numpy(real), torch.from_numpy(z), 0.7, cfg, stage, dtype=dtype,
            packed_d=True, packed_g=True)[::-1]
    return out


def _grad_trees(state):
    """Adam's first moments: with b1 = 0, the step's gradients."""
    return state.d_opt[0].mu, state.g_opt[0].mu


def _vec(tree) -> torch.Tensor:
    return torch.cat([a.flatten().double() for a in tree_leaves(tree)])


def test_train_step_default_matches_jax(_steps):
    """The step at the default ``packed_train_mode``, "default", against the
    JAX step at "emulate_bf16" (JAX's and the port's unpacked convs are both
    fp32 on the CPU). Losses within rtol 1e-4; each gradient leaf within
    2e-2 of its largest entry (this config reaches 1.1e-3). The two
    packages' fp32 convs differ by ~1e-5 of a value before the kernels round
    it, and a value that close to a bf16 rounding boundary rounds the other
    way in one of them: a whole bf16 step, which the next rounding carries
    on. Wider stages reach more such boundaries, so this config keeps the
    late stages at 8 and 16 channels."""
    (jm, want), (m, after) = _steps["jax"], _steps[torch.float32]
    for name in ("d_loss", "g_loss", "real_logit", "fake_logit"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-4, err_msg=name)
    for got_tree, want_tree in zip(_grad_trees(after), _grad_trees(want)):
        for a, b in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
            assert (a - b).abs().max() <= 2e-2 * b.abs().max()
    assert int(after.d_opt[0].count) == 1


def test_train_step_bf16_packed_matches_jax(_steps):
    """``dtype=bfloat16`` with both packed gates at "default" (the ``--fast``
    math): the kernels run on fp32 casts of the bf16 activations. Held to
    the JAX step at the default grade as the unpacked bf16 step is held to
    JAX (tests/test_torch_grades.py): losses within 1e-2, each network's
    gradients as one vector within 15% (L2) at cosine >= 0.99 (measured:
    3.8% and 3.1%, 0.9993 and 0.9995). The parameters, their gradients and
    Adam's state stay fp32."""
    (jm, want), (m, after) = _steps["jax"], _steps[torch.bfloat16]
    for name in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-2, err_msg=name)
    for got_tree, want_tree in zip(_grad_trees(after), _grad_trees(want)):
        assert all(a.dtype == torch.float32 for a in tree_leaves(got_tree))
        u, v = _vec(got_tree), _vec(want_tree)
        assert (u - v).norm() <= 0.15 * v.norm() and u @ v >= 0.99 * u.norm() * v.norm()
    assert all(a.dtype == torch.float32 for a in tree_leaves(after.g_params))
    # the bf16 step is another step than the fp32 one
    assert not torch.equal(_vec(_grad_trees(after)[1]),
                           _vec(_grad_trees(_steps[torch.float32][1])[1]))


def test_fade_in_rounds_alpha_to_the_step_dtype():
    """The progressive blend at bf16 takes bf16(alpha), as the JAX package's
    ``jnp.asarray(alpha, dtype=rgb.dtype)``; at fp32 it is unchanged."""
    prev, x = torch.randn(4, 3, 8, 8), torch.randn(4, 3, 8, 8)
    for dtype in (torch.bfloat16, torch.float32):
        p, q = prev.to(dtype), x.to(dtype)
        a = torch.tensor(0.7).to(dtype)
        assert torch.equal(tpg.blend(p, q, 0.7), p + a * (q - p))
    assert torch.equal(tpg.blend(prev, x, 0.7), prev + 0.7 * (x - prev))


# -- --fast ------------------------------------------------------------------------

TINY_SCHEDULE = ["--synthetic", "8", "--resolution", "16", "--latent_dim", "8",
                 "--fmap_base", "64", "--fmap_max", "16", "--epochs_per_stage", "1",
                 "--batch_size", "4", "--device", "cpu"]


@pytest.mark.parametrize("schedule", ["tiny", "packed"])
def test_image_trainer_fast_preset(schedule, tmp_path, capsys, monkeypatch):
    """``--fast`` implies ``--bf16 --packed_d --packed_g`` and trains end to
    end to a checkpoint the JAX package loads: on the JAX test's tiny
    schedule (no stage packs at 16²), and at 256² with 8-channel late stages,
    where stage 6 of G and D runs on the Functions (here the twins) at
    "default" with bf16 activations around them."""
    args = list(TINY_SCHEDULE)
    calls = []
    if schedule == "packed":
        args[args.index("--resolution") + 1] = "256"
        args[args.index("--fmap_base") + 1] = "512"
        args[args.index("--synthetic") + 1] = "4"
        args[args.index("--batch_size") + 1] = "2"
        for name in ("upconv_lrelu_norm", "conv_lrelu_norm", "conv_lrelu", "convpool_lrelu"):
            real = getattr(tvjp, name)
            monkeypatch.setattr(tvjp, name, lambda x, w, b, mode="default", _real=real,
                                _name=name: calls.append((_name, mode, x.dtype)) or
                                _real(x, w, b, mode))
    out_dir = str(tmp_path / "fast")
    assert timage_cli.main([*args, "--output_dir", out_dir, "--fast"]) == 0
    assert "Training complete!" in capsys.readouterr().out
    if schedule == "packed":
        assert {c[0] for c in calls} == {"upconv_lrelu_norm", "conv_lrelu_norm", "conv_lrelu",
                                         "convpool_lrelu"}
        assert {c[1:] for c in calls} == {("default", torch.float32)}
    cfg, g, _ = jimage_checkpoint.load_image_checkpoint(
        os.path.join(out_dir, "image_checkpoint.msgpack"))
    assert cfg.resolution == (256 if schedule == "packed" else 16)
    assert jax.tree.structure(g) == jax.tree.structure(
        jax.eval_shape(lambda k: jpg.init_generator(k, cfg), jax.random.key(0)))
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(g))
