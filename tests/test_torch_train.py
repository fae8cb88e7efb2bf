"""The port's train steps (probgan_tpu_torch/engine/train.py) against the JAX
package's, on the CPU: the same numpy inputs, the JAX package's initial state
carried across by core/convert.py, the JAX noise replayed.

Tolerances. Losses and logits: rtol 1e-4 (fp32 sums in another order).
Gradients before Adam, per leaf: within 1e-3 of the leaf's largest entry (with
b1 = 0 the first moment after one step IS the gradient, so it is read from
the optimizer state of both packages). Parameters after Adam: rtol 4e-3,
atol 6e-4 = 0.6 * lr: a first Adam update is sign-like (about +-lr), so where
a gradient is about 0 reduction-order noise moves the update by up to 2 * lr
while a systematically wrong gradient moves whole tensors; the bound is the
JAX package's own (tests/test_packed_vjp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.engine import train as jtrain
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu_torch.core import convert
from probgan_tpu_torch.core.tree import tree_leaves, tree_map
from probgan_tpu_torch.engine import train as ttrain
from probgan_tpu_torch.models import pro_gan as tpg

LR = 1e-3
PARAM_TOL = dict(rtol=4e-3, atol=0.6 * LR)
METRICS = ("d_loss", "g_loss", "real_logit", "fake_logit")
SMALL = dict(resolution=32, latent_dim=8, fmap_base=64, fmap_max=16)
PACKED = dict(resolution=256, latent_dim=8, fmap_base=1024, fmap_max=64)


def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _both_states(kw, seed=0):
    jstate = jtrain.progan_init_state(jax.random.key(seed), jpg.ProGANConfig(**kw), lr=LR)
    return jstate, convert.convert_progan_train_state(jstate)


def _assert_metrics(got: dict, want: dict, names=METRICS):
    for name in names:
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-4,
                                   err_msg=name)


def _assert_leafwise(got_tree, want_tree, check):
    got, want = tree_leaves(got_tree), tree_leaves(want_tree)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        check(a.detach().numpy(), b.detach().numpy(), i)


def _assert_grads(got_tree, want_tree):
    def check(a, b, i):
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-3 * scale + 1e-12, (i, np.abs(a - b).max(), scale)

    _assert_leafwise(got_tree, want_tree, check)


def _assert_params(got_tree, want_tree):
    _assert_leafwise(got_tree, want_tree,
                     lambda a, b, i: np.testing.assert_allclose(a, b, err_msg=str(i),
                                                                **PARAM_TOL))


def _assert_state(state, jstate_after):
    want = convert.convert_progan_train_state(jstate_after)
    _assert_grads(state.d_opt[0].mu, want.d_opt[0].mu)
    _assert_grads(state.g_opt[0].mu, want.g_opt[0].mu)
    _assert_params(state.d_params, want.d_params)
    _assert_params(state.g_params, want.g_params)
    _assert_params(state.g_ema, want.g_ema)
    assert int(state.d_opt[0].count) == int(want.d_opt[0].count) == 1


@pytest.mark.parametrize("packed", [False, True])
def test_progan_train_step_matches_jax(packed):
    """One whole G/D step at 256², stage 6, alpha 0.7, batch 2: with ``packed``
    the gates route one stage of D and of G through ops/packed_vjp.py (their
    plain twins here; the JAX kernels in interpret mode at "highest")."""
    stage = 6
    cfg, jcfg = tpg.ProGANConfig(**PACKED), jpg.ProGANConfig(**PACKED)
    assert tpg.packed_d_stage_count(cfg, stage, "highest") == 1
    assert tpg.packed_start_stage(cfg, stage) == 6
    jstate, state = _both_states(PACKED)
    real, z = _rand((2, 256, 256, 3), 20), _rand((2, 8), 21)
    jafter, jm = jtrain.progan_train_step(
        jstate, jnp.asarray(real), jnp.asarray(z), jnp.float32(0.7), jcfg, stage, lr=LR,
        packed_d=packed, packed_g=packed, packed_train_mode="highest")
    after, m = ttrain.progan_train_step(
        state, torch.from_numpy(real), torch.from_numpy(z), 0.7, cfg, stage, lr=LR,
        packed_d=packed, packed_g=packed, packed_train_mode="highest")
    _assert_metrics(m, jm)
    _assert_state(after, jafter)
    # the step is pure: the state it was given is untouched
    for a, b in zip(tree_leaves(state), tree_leaves(convert.convert_progan_train_state(jstate))):
        assert torch.equal(a, b)


def test_progan_packed_paths_agree_and_packed_fake_runs_no_backward():
    """packed_d + packed_g, packed_fake alone and the unpacked step compute
    the same losses and gradients (rtol 1e-4; 1e-3 of a leaf's max), and
    ``progan_grads`` returns what the step feeds to Adam. All at the fp32
    grade "highest"."""
    stage, cfg = 6, tpg.ProGANConfig(**PACKED)
    _, state = _both_states(PACKED, seed=1)
    real, z = torch.from_numpy(_rand((2, 256, 256, 3), 22)), torch.from_numpy(_rand((2, 8), 23))
    fp32 = dict(packed_train_mode="highest")
    d_ref, g_ref, m_ref = ttrain.progan_grads(state, real, z, 0.7, cfg, stage, **fp32)
    for kw in (dict(packed_d=True, packed_g=True), dict(packed_fake=True)):
        d_got, g_got, m = ttrain.progan_grads(state, real, z, 0.7, cfg, stage, **kw, **fp32)
        _assert_metrics(m, m_ref)
        _assert_grads(d_got, d_ref)
        _assert_grads(g_got, g_ref)
    after, m = ttrain.progan_train_step(state, real, z, 0.7, cfg, stage, lr=LR,
                                        packed_d=True, packed_g=True, **fp32)
    np.testing.assert_allclose(float(m["d_loss"]), float(m_ref["d_loss"]), rtol=1e-4)
    _assert_grads(after.d_opt[0].mu, d_ref)  # b1 = 0: mu is the gradient


@pytest.mark.parametrize("remat,r1_gamma", [(True, 0.0), (False, 5.0), (True, 5.0)])
def test_progan_small_step_r1_and_remat_match_jax(remat, r1_gamma):
    """32², stage 3: the R1 penalty (a second derivative through the unpacked
    D, through the activation checkpoints when ``remat``) against the JAX
    step; ``remat`` changes no number."""
    stage = 3
    cfg, jcfg = tpg.ProGANConfig(**SMALL), jpg.ProGANConfig(**SMALL)
    jstate, state = _both_states(SMALL)
    real, z = _rand((4, 32, 32, 3), 24), _rand((4, 8), 25)
    jafter, jm = jtrain.progan_train_step(
        jstate, jnp.asarray(real), jnp.asarray(z), jnp.float32(0.4), jcfg, stage, lr=LR,
        remat=remat, r1_gamma=r1_gamma)
    after, m = ttrain.progan_train_step(
        state, torch.from_numpy(real), torch.from_numpy(z), 0.4, cfg, stage, lr=LR,
        remat=remat, r1_gamma=r1_gamma)
    _assert_metrics(m, jm)
    _assert_state(after, jafter)
    if r1_gamma:
        _, plain = ttrain.progan_train_step(
            state, torch.from_numpy(real), torch.from_numpy(z), 0.4, cfg, stage, lr=LR)
        assert float(m["d_loss"]) > float(plain["d_loss"]) + 1e-6  # the penalty is there


def test_progan_accum_matches_jax_and_the_plain_step():
    stage = 3
    cfg, jcfg = tpg.ProGANConfig(**SMALL), jpg.ProGANConfig(**SMALL)
    jstate, state = _both_states(SMALL)
    real, z = _rand((2, 2, 32, 32, 3), 26), _rand((2, 2, 8), 27)
    t_real, t_z = torch.from_numpy(real), torch.from_numpy(z)
    # A = 1 is the plain step
    one, m_one = ttrain.progan_train_step_accum(state, t_real[:1], t_z[:1], 0.6, cfg, stage)
    ref, m_ref = ttrain.progan_train_step(state, t_real[0], t_z[0], 0.6, cfg, stage)
    _assert_metrics(m_one, m_ref)
    for a, b in zip(tree_leaves(one), tree_leaves(ref)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # A = 2 averages the microbatches' gradients: against the JAX step
    jafter, jm = jtrain.progan_train_step_accum(
        jstate, jnp.asarray(real), jnp.asarray(z), jnp.float32(0.6), jcfg, stage, lr=LR)
    after, m = ttrain.progan_train_step_accum(state, t_real, t_z, 0.6, cfg, stage, lr=LR)
    _assert_metrics(m, jm)
    _assert_state(after, jafter)
    d0, g0, _ = ttrain.progan_grads(state, t_real[0], t_z[0], 0.6, cfg, stage)
    d1, _, _ = ttrain.progan_grads(state, t_real[1], t_z[1], 0.6, cfg, stage)
    _assert_grads(after.d_opt[0].mu, tree_map(lambda a, b: 0.5 * (a + b), d0, d1))


def test_progan_ema():
    stage, cfg = 2, tpg.ProGANConfig(**SMALL)
    state = ttrain.progan_init_state(3, cfg, device="cpu")
    assert state.g_ema is state.g_params and state.g_params["base_conv"]["w"].device.type == "cpu"
    real, z = torch.from_numpy(_rand((2, 16, 16, 3), 28)), torch.from_numpy(_rand((2, 8), 29))
    raw, _ = ttrain.progan_train_step(state, real, z, 1.0, cfg, stage, ema_beta=0.0)
    assert raw.g_ema is raw.g_params  # beta 0: an alias, nothing materialized
    ema, _ = ttrain.progan_train_step(state, real, z, 1.0, cfg, stage, ema_beta=0.9)
    for e, old, new in zip(tree_leaves(ema.g_ema), tree_leaves(state.g_params),
                           tree_leaves(ema.g_params)):
        torch.testing.assert_close(e, 0.9 * old + 0.1 * new, rtol=1e-6, atol=1e-7)


def test_init_state_defaults_to_the_card():
    cfg = tpg.ProGANConfig(**SMALL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            ttrain.progan_init_state(0, cfg)
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            ttrain.kg_init_state(0, 10, 2)
    a = ttrain.progan_init_state(5, cfg, device="cpu")
    b = ttrain.progan_init_state(torch.Generator().manual_seed(5), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    opt = ttrain.progan_optimizer(2e-3)
    assert (opt.lr, opt.b1, opt.b2, opt.eps) == (2e-3, 0.0, 0.99, 1e-8)
    assert ttrain.kg_optimizer().b1 == 0.9


# the packed training modes and bf16 are ported: those cases run (their ids
# are kept); the reference against which each is held bit for bit
@pytest.mark.parametrize("kwargs,match", [
    pytest.param(dict(packed_train_mode="default", packed_g=True), dict(packed_train_mode="high"),
                 id="kwargs0-bf16"),
    pytest.param(dict(packed_train_mode="mid", packed_d=True), dict(packed_train_mode="high"),
                 id="kwargs1-bf16"),
    pytest.param(dict(dtype=torch.bfloat16, packed_d=True), dict(packed_d=False),
                 id="kwargs2-bf16"),
    (dict(axis_names=("data",)), "axis_names"),
])
def test_unported_train_options_raise(kwargs, match):
    """What the step cannot take raises before any work: ``axis_names`` that
    is not a process group (JAX's tuple of mesh axes; a group's step:
    tests/test_torch_dp.py). The packed training paths run at every kernel mode
    and at dtype bf16: at this size no stage is packed, so a step at "mid"
    or "default" is the step at "high" (on the CPU, where TF32 is no grade),
    and bf16 with the packed gate the unpacked bf16 step, bit for bit; so
    are the differentiable G and D at ``packed_mode="default"`` the unpacked
    ones."""
    cfg = tpg.ProGANConfig(**SMALL)
    state = ttrain.progan_init_state(0, cfg, device="cpu")
    real, z = torch.zeros(2, 16, 16, 3), torch.zeros(2, 8)
    if isinstance(match, dict):
        _, got = ttrain.progan_train_step(state, real, z, 1.0, cfg, 2, **kwargs)
        _, want = ttrain.progan_train_step(state, real, z, 1.0, cfg, 2, **{**kwargs, **match})
        assert all(torch.isfinite(v) and torch.equal(v, want[k]) for k, v in got.items())
        img = tpg.generator_rgb(state.g_params, z, cfg, 2, packed_mode="default")
        assert torch.equal(img, tpg.generator_rgb(state.g_params, z, cfg, 2))
        assert torch.equal(tpg.discriminator_apply(state.d_params, img, cfg, 2, packed=True,
                                                   packed_mode="default"),
                           tpg.discriminator_apply(state.d_params, img, cfg, 2))
        return
    with pytest.raises(TypeError, match=match):
        ttrain.progan_train_step(state, real, z, 1.0, cfg, 2, **kwargs)


def test_step_in_a_group_of_one_is_the_plain_step(tmp_path):
    """``axis_names`` a gloo group of one process: the minibatch stddev's and
    the gradients' means over one rank change no bit, with R1 too."""
    import torch.distributed as dist

    cfg = tpg.ProGANConfig(**SMALL)
    state = ttrain.progan_init_state(0, cfg, device="cpu")
    real, z = torch.from_numpy(_rand((4, 16, 16, 3), 30)), torch.from_numpy(_rand((4, 8), 31))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    try:
        for r1 in (0.0, 10.0):
            got, gm = ttrain.progan_train_step(state, real, z, 0.7, cfg, 2, r1_gamma=r1,
                                               axis_names=dist.group.WORLD)
            want, wm = ttrain.progan_train_step(state, real, z, 0.7, cfg, 2, r1_gamma=r1)
            assert all(torch.equal(gm[k], wm[k]) for k in METRICS)
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# KG
# ---------------------------------------------------------------------------

KG = dict(num_entities=200, num_relations=7, embed_dim=16, noise_dim=8, hidden_dim=32)
KG_METRICS = METRICS + ("gen_cosine",)


def _kg_batch(seed, b=12, s=40):
    rs = np.random.RandomState(seed)
    triplets = np.stack([rs.randint(0, KG["num_entities"], b),
                         rs.randint(0, KG["num_relations"], b),
                         rs.randint(0, KG["num_entities"], b)], axis=1).astype(np.int32)
    negatives = np.stack([rs.randint(0, KG["num_entities"], b),
                          rs.randint(0, KG["num_relations"], b)], axis=1).astype(np.int32)
    ce = rs.randint(0, KG["num_entities"], s).astype(np.int32)
    ce[:3] = triplets[:3, 2]  # negatives that collide with a true tail
    return triplets, negatives, ce


@pytest.mark.parametrize("with_negatives,with_ce", [(False, False), (True, False),
                                                    (True, True)])
def test_kg_train_step_matches_jax(with_negatives, with_ce):
    jstate = jtrain.kg_init_state(jax.random.key(2), lr=LR, **KG)
    state = convert.convert_kg_train_state(jstate)
    triplets, negatives, ce = _kg_batch(31)
    key = jax.random.key(9)
    z = np.array(jax.random.normal(key, (len(triplets), KG["noise_dim"]), jnp.float32))
    jafter, jm = jtrain.kg_train_step(
        jstate, jnp.asarray(triplets), key, lr=LR,
        negatives=jnp.asarray(negatives) if with_negatives else None,
        ce_negatives=jnp.asarray(ce) if with_ce else None)
    after, m = ttrain.kg_train_step(
        state, torch.from_numpy(triplets).long(), lr=LR, z=torch.from_numpy(z),
        negatives=torch.from_numpy(negatives).long() if with_negatives else None,
        ce_negatives=torch.from_numpy(ce).long() if with_ce else None)
    _assert_metrics(m, jm, KG_METRICS)
    want = convert.convert_kg_train_state(jafter)
    for a, b in zip(tree_leaves(after), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.6 * LR, rtol=0)
    # rows no triplet names have a zero gradient, so Adam leaves them alone
    untouched = np.setdiff1d(np.arange(KG["num_entities"]),
                             np.concatenate([triplets[:, 0], triplets[:, 2], ce]))
    if with_ce:
        assert torch.equal(after.node_emb[untouched], state.node_emb[untouched])

    zz = _rand((len(triplets), KG["noise_dim"]), 33)
    hits_j = jtrain.kg_eval_hits(jafter.g_params, jafter.node_emb, jafter.rel_emb,
                                 jnp.asarray(triplets), jnp.asarray(zz), k=10)
    hits = ttrain.kg_eval_hits(want.g_params, want.node_emb, want.rel_emb,
                               torch.from_numpy(triplets).long(), torch.from_numpy(zz), k=10)
    assert float(hits) == float(hits_j)


def test_kg_noise_sources():
    """``z`` given, a torch.Generator, or the port's RngStream: the same
    generator state gives the same step; with none of them the step raises."""
    from probgan_tpu_torch.core.rng import RngStream

    state = ttrain.kg_init_state(4, device="cpu", **KG)
    assert state.node_emb.shape == (200, 16) and float(state.node_emb.std()) < 0.2
    triplets = torch.from_numpy(_kg_batch(34)[0]).long()
    runs = [ttrain.kg_train_step(state, triplets, torch.Generator().manual_seed(1))[1]
            for _ in range(2)]
    assert float(runs[0]["g_loss"]) == float(runs[1]["g_loss"])
    z = torch.randn((len(triplets), 8), generator=torch.Generator().manual_seed(1))
    assert float(ttrain.kg_train_step(state, triplets, z=z)[1]["g_loss"]) == float(
        runs[0]["g_loss"])
    a = ttrain.kg_train_step(state, triplets, RngStream(3))[1]
    b = ttrain.kg_train_step(state, triplets, RngStream(3))[1]
    assert float(a["g_loss"]) == float(b["g_loss"]) != float(runs[0]["g_loss"])
    with pytest.raises(ValueError, match="generator or z"):
        ttrain.kg_train_step(state, triplets)
