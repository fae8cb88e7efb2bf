"""The port's discriminator (probgan_tpu_torch/models/pro_gan.py) against the
JAX package's, on the CPU, from the same numpy images and converted weights.

Tolerances: logits to rtol = atol = 2e-4 against JAX precision="highest"
(float reassociation through up to nine conv blocks), and 1e-2 against the
JAX packed path at "high", which is a 3-term bf16 split there and plain fp32
in the port: the JAX tests' own tolerances. JAX runs its Pallas kernels in
interpret mode. Both sides always score the same batch: the minibatch stddev
makes the logits a function of the whole batch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.models import pro_gan as jpg
from probgan_tpu_torch.core.convert import (
    convert_discriminator_params,
    discriminator_params_to_jax,
)
from probgan_tpu_torch.models import pro_gan as tpg

SMALL = dict(resolution=64, latent_dim=16, fmap_base=64, fmap_max=32)
# The packed-gate config of tests/test_pallas_packed.py: nf(7) = 16, nf(6) =
# 32, nf(5) = 64, so the gate takes stages 7 and 6 (resolutions 512, 256).
PACKED = dict(resolution=512, latent_dim=16, fmap_base=2048, fmap_max=64)
TOL = dict(rtol=2e-4, atol=2e-4)


def _both(kw, seed=0):
    """(JAX config, port config, JAX params, port params): numpy N(0,1)
    weights (non-symmetric in every axis) and N(0, 0.1) biases in the JAX
    package's tree, converted for the port."""
    jcfg, tcfg = jpg.ProGANConfig(**kw), tpg.ProGANConfig(**kw)
    shapes = jax.eval_shape(lambda k: jpg.init_discriminator(k, jcfg), jax.random.key(0))
    rng = np.random.RandomState(seed)
    jparams = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape) * (1.0 if len(s.shape) > 1 else 0.1))
        .astype(np.float32), shapes)
    return jcfg, tcfg, jparams, convert_discriminator_params(jparams)


def _images(n, res, seed):
    return np.random.RandomState(seed).uniform(-1.0, 1.0, (n, res, res, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def small_case():
    return _both(SMALL, seed=2)


def test_init_discriminator_tree_matches_jax():
    jcfg, tcfg = jpg.ProGANConfig(**SMALL), tpg.ProGANConfig(**SMALL)
    want = jax.eval_shape(lambda k: jpg.init_discriminator(k, jcfg), jax.random.key(0))
    got = discriminator_params_to_jax(tpg.init_discriminator(tcfg, 3))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert jax.tree.map(lambda a: a.shape, got) == jax.tree.map(lambda s: s.shape, want)
    params = tpg.init_discriminator(tcfg, 3)
    assert params["final_conv"]["w"].shape == (32, 33, 3, 3)  # +1: the stddev channel
    assert float(params["from_rgb"][0]["b"].abs().max()) == 0.0
    again = tpg.init_discriminator(tcfg, torch.Generator().manual_seed(3))
    assert torch.equal(again["out_dense"]["w"], params["out_dense"]["w"])


def test_convert_discriminator_params_layouts(small_case):
    jcfg, tcfg, jparams, tparams = small_case
    assert len(tparams["from_rgb"]) == jcfg.num_stages
    assert tparams["from_rgb"][4]["w"].shape == (4, 3, 1, 1)  # OIHW, nf(4) = 4
    assert tparams["blocks"][1]["conv2"]["w"].shape == (32, 16, 3, 3)  # nf(2) -> nf(1)
    assert tparams["final_dense"]["w"].shape == (32 * 16, 32)
    w = np.asarray(jparams["blocks"][1]["conv2"]["w"])  # HWIO
    np.testing.assert_array_equal(
        tparams["blocks"][1]["conv2"]["w"][5, 7, 0, 2].item(), w[0, 2, 7, 5])
    back = discriminator_params_to_jax(tparams)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(got, want)


def test_minibatch_stddev_matches_jax():
    x = np.random.RandomState(5).standard_normal((3, 4, 4, 6)).astype(np.float32)
    want = np.asarray(jpg.minibatch_stddev(jnp.asarray(x)))
    got = tpg.minibatch_stddev(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert tuple(got.shape) == (3, 7, 4, 4)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-6, atol=1e-6)
    pooled = tpg.downsample_avg_2x(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(pooled.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jpg.downsample_avg_2x(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stage,alpha", [(0, 1.0), (1, 0.5), (2, 1.0), (3, 0.5), (4, 1.0),
                                         (4, 0.5)])
def test_discriminator_apply_matches_jax(small_case, stage, alpha):
    """Every stage of a small config. final_dense reads the 4x4 map in HWC
    order and the weights are non-symmetric, so a wrong flatten order or a
    misplaced blend fails here."""
    jcfg, tcfg, jparams, tparams = small_case
    img = _images(3, 4 * 2**stage, 20 + stage)
    want = np.asarray(jpg.discriminator_apply(jparams, jnp.asarray(img), jcfg, stage, alpha,
                                              precision="highest"))
    got = tpg.discriminator_apply(tparams, torch.from_numpy(img), tcfg, stage, alpha,
                                  precision="highest").numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, **TOL)
    # the gate declines this config: packed=True is the same path
    same = tpg.discriminator_apply(tparams, torch.from_numpy(img), tcfg, stage, alpha,
                                   precision="high", packed=True).numpy()
    np.testing.assert_array_equal(same, got)


def test_score_depends_on_the_batch(small_case):
    _, tcfg, _, tparams = small_case
    img = torch.from_numpy(_images(4, 64, 7))
    whole = tpg.discriminator_apply(tparams, img, tcfg, 4)
    alone = torch.cat([tpg.discriminator_apply(tparams, img[i:i + 1], tcfg, 4)
                       for i in range(4)])
    assert not torch.allclose(whole, alone, atol=1e-4)


@pytest.fixture(scope="module")
def packed_case():
    jcfg, tcfg, jparams, tparams = _both(PACKED, seed=3)
    stage = jcfg.num_stages - 1
    assert jpg.packed_d_stage_count(jcfg, stage) == tpg.packed_d_stage_count(tcfg, stage) == 2
    # jitted once per precision with alpha traced: one compile serves both alphas
    @functools.lru_cache(maxsize=None)
    def jitted(precision):
        return jax.jit(lambda p, x, a: jpg.discriminator_apply(
            p, x, jcfg, stage, a, precision=precision, packed=True))
    return jcfg, tcfg, jparams, tparams, stage, _images(2, 512, 11), jitted


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_packed_discriminator_matches_jax(packed_case, alpha):
    """The packed stages as a whole: the port on the CPU (plain twins of
    packed_conv "lrelu" and packed_convpool) against JAX
    discriminator_apply(packed=True, precision="highest"); at alpha 0.5 the
    blend sits inside the packed stages, after the first block only."""
    jcfg, tcfg, jparams, tparams, stage, img, jitted = packed_case
    want = np.asarray(jitted("highest")(jparams, jnp.asarray(img), jnp.float32(alpha)))
    got = tpg.discriminator_apply(tparams, torch.from_numpy(img), tcfg, stage, alpha,
                                  precision="highest", packed=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    unpacked = tpg.discriminator_apply(tparams, torch.from_numpy(img), tcfg, stage, alpha,
                                       precision="high").numpy()
    np.testing.assert_allclose(got, unpacked, **TOL)


def test_packed_discriminator_fast_matches_jax(packed_case):
    """The scoring grade "fast": both packages run D's packed stages in
    kernel mode "mid" (the weights rounded to bf16, the activations split in
    two bf16 terms, exact products, fp32 sums in another order): logits
    within 1e-4 of JAX's largest |logit|, at a fade-in alpha (the blend
    inside the packed stages)."""
    jcfg, tcfg, jparams, tparams, stage, img, jitted = packed_case
    alpha = 0.5
    want = np.asarray(jitted("fast")(jparams, jnp.asarray(img), jnp.float32(alpha)))
    got = tpg.discriminator_apply(tparams, torch.from_numpy(img), tcfg, stage, alpha,
                                  precision="fast", packed=True).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), (got, want)


def test_packed_discriminator_near_jax_high_ladder(packed_case):
    """JAX's "high" on the packed D path is a 3-term bf16 split; the port's
    "high" is fp32. They agree to the split's accuracy."""
    jcfg, tcfg, jparams, tparams, stage, img, jitted = packed_case
    want = np.asarray(jitted("high")(jparams, jnp.asarray(img), jnp.float32(1.0)))
    got = tpg.discriminator_apply(tparams, torch.from_numpy(img), tcfg, stage, 1.0,
                                  precision="high", packed=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_packed_path_calls_the_packed_ops(packed_case, monkeypatch):
    """Two packed stages: two packed_conv "lrelu" and two packed_convpool
    calls per forward, at the stages' channel counts and the grade's kernel
    mode."""
    from probgan_tpu_torch.ops import packed as tpk

    _, tcfg, _, tparams, stage, img, _ = packed_case
    calls = []
    conv, pool = tpk.packed_conv, tpk.packed_convpool
    monkeypatch.setattr(tpk, "packed_conv", lambda x, w, b, epilogue="lrelu_norm", **kw: (
        calls.append(("conv", epilogue, tuple(x.shape[1:]), w.shape[0], kw.get("mode"))),
        conv(x, w, b, epilogue, **kw))[1])
    monkeypatch.setattr(tpk, "packed_convpool", lambda x, w, b, epilogue="lrelu", **kw: (
        calls.append(("pool", epilogue, tuple(x.shape[1:]), w.shape[0], kw.get("mode"))),
        pool(x, w, b, epilogue, **kw))[1])
    for precision, mode in (("high", "high"), ("fast", "mid")):
        calls.clear()
        tpg.discriminator_apply(tparams, torch.from_numpy(img[:1]), tcfg, stage, 1.0,
                                precision=precision, packed=True)
        assert calls == [("conv", "lrelu", (16, 512, 512), 16, mode),
                         ("pool", "lrelu", (16, 512, 512), 32, mode),
                         ("conv", "lrelu", (32, 256, 256), 32, mode),
                         ("pool", "lrelu", (32, 256, 256), 64, mode)]


def test_packed_d_gate_matches_jax():
    for kw in (PACKED, SMALL, dict(resolution=1024),
               dict(resolution=512, latent_dim=16, fmap_base=512, fmap_max=64),
               dict(resolution=256, latent_dim=64, fmap_base=1024, fmap_max=64),
               dict(resolution=256, latent_dim=64, fmap_base=1000, fmap_max=60)):
        jcfg, tcfg = jpg.ProGANConfig(**kw), tpg.ProGANConfig(**kw)
        for stage in range(jcfg.num_stages):
            for precision in ("highest", "high", "fast", "default", None):
                assert (tpg.packed_d_stage_count(tcfg, stage, precision)
                        == jpg.packed_d_stage_count(jcfg, stage, precision)), (kw, stage)
    assert tpg.packed_d_stage_count(tpg.ProGANConfig(), 8) == 2
    assert tpg.packed_d_stage_count(tpg.ProGANConfig(), 8, "high") == 2


@pytest.mark.parametrize("grade", [None, "default", "fast"])
def test_bf16_grades_raise(grade):
    """D at the bf16 grades. None and "default" run, packed or not: the
    packed gate declines them (packed_d_stage_count is 0), so D is unpacked,
    as in the JAX package. "fast" runs unpacked, and packed in kernel mode
    "mid" (the 2-term split), near the unpacked fp32 logits and not equal to
    them. The differentiable packed path runs at its one-pass mode "default"
    at every grade (the name of the test is kept from when it raised): its
    stage on the twins, near the unpacked logits and not equal to them."""
    cfg = tpg.ProGANConfig(**PACKED)
    assert tpg.packed_d_stage_count(cfg, 6, "high") == 1
    params = tpg.init_discriminator(cfg, 0)
    img = torch.from_numpy(_images(2, 256, 9))
    unpacked = tpg.discriminator_apply(params, img, cfg, 6, 0.5, precision=grade)
    assert unpacked.shape == (2,) and torch.isfinite(unpacked).all()
    if grade == "fast":
        assert tpg.packed_d_stage_count(cfg, 6, grade) == 1
        packed = tpg.discriminator_apply(params, img, cfg, 6, 0.5, precision=grade, packed=True)
        assert torch.isfinite(packed).all() and not torch.equal(packed, unpacked)
        np.testing.assert_allclose(packed.numpy(), unpacked.numpy(), rtol=1e-2, atol=1e-2)
    else:
        assert tpg.packed_d_stage_count(cfg, 6, grade) == 0
        assert torch.equal(tpg.discriminator_apply(params, img, cfg, 6, 0.5, precision=grade,
                                                   packed=True), unpacked)
    packed = tpg.discriminator_apply(params, img, cfg, 6, 0.5, precision=grade, packed=True,
                                     packed_mode="default")
    assert torch.isfinite(packed).all() and not torch.equal(packed, unpacked)
    np.testing.assert_allclose(packed.numpy(), unpacked.numpy(), rtol=1e-2, atol=1e-2)
