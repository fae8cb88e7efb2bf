"""The port's KG models against the JAX package on the same weights and
inputs (numpy seeds, handed to both), on the CPU.

Floats agree to atol 1e-5: fp32 sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.models import kg_gan as jax_kg
from probgan_tpu_torch.core.checkpoint import params_to_torch_state
from probgan_tpu_torch.core.convert import convert_kg_checkpoint, convert_kg_params
from probgan_tpu_torch.models import kg_gan
from probgan_tpu_torch.models.modular import ModularDiscriminator, ModularGenerator
from tests.conftest import EMBED_DIM, HIDDEN_DIM, NOISE_DIM, NUM_ENTITIES, NUM_RELATIONS

ATOL = 1e-5
B = 6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h, r, t = (rng.standard_normal((B, EMBED_DIM)).astype(np.float32) for _ in range(3))
    z = rng.standard_normal((B, NOISE_DIM)).astype(np.float32)
    trips = np.stack([rng.integers(0, NUM_ENTITIES, B), rng.integers(0, NUM_RELATIONS, B),
                      rng.integers(0, NUM_ENTITIES, B)], axis=1)
    return h, r, t, z, trips


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_generator_apply_matches_jax(ckpt_dict):
    h, r, _, z, _ = _inputs()
    want = jax_kg.generator_apply(ckpt_dict["generator"], jnp.asarray(h), jnp.asarray(r),
                                  jnp.asarray(z))
    params = convert_kg_params(ckpt_dict["generator"])
    got = kg_gan.generator_apply(params, _t(h), _t(r), _t(z))
    assert tuple(got.shape) == (B, EMBED_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_discriminator_apply_matches_jax(ckpt_dict):
    h, r, t, _, _ = _inputs(1)
    want = jax_kg.discriminator_apply(ckpt_dict["discriminator"], jnp.asarray(h),
                                      jnp.asarray(r), jnp.asarray(t))
    params = convert_kg_params(ckpt_dict["discriminator"])
    got = kg_gan.discriminator_apply(params, _t(h), _t(r), _t(t))
    assert tuple(got.shape) == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_discriminator_score_triplets_matches_jax(ckpt_dict):
    trips = _inputs(2)[4]
    want_l, want_p = jax_kg.discriminator_score_triplets(
        ckpt_dict["discriminator"], jnp.asarray(ckpt_dict["node_emb"]),
        jnp.asarray(ckpt_dict["rel_emb"]["weight"]), jnp.asarray(trips))
    ck = convert_kg_checkpoint(ckpt_dict)
    assert ck["best_epoch"] == 17 and ck["args"] == ckpt_dict["args"]
    got_l, got_p = kg_gan.discriminator_score_triplets(
        ck["discriminator"], ck["node_emb"], ck["rel_emb"]["weight"], _t(trips))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=ATOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL)


def test_dims_are_recovered_from_params(ckpt_dict):
    ck = convert_kg_checkpoint(ckpt_dict)
    assert kg_gan.generator_dims(ck["generator"]) == (EMBED_DIM, NOISE_DIM)
    assert kg_gan.discriminator_dims(ck["discriminator"]) == (EMBED_DIM, HIDDEN_DIM)
    assert kg_gan.generator_dims(ck["generator"]) == jax_kg.generator_dims(
        ckpt_dict["generator"])
    assert kg_gan.discriminator_dims(ck["discriminator"]) == jax_kg.discriminator_dims(
        ckpt_dict["discriminator"])


def test_init_shapes_match_jax_and_are_seeded():
    g = kg_gan.init_generator(torch.Generator().manual_seed(3), EMBED_DIM, NOISE_DIM)
    d = kg_gan.init_discriminator(torch.Generator().manual_seed(3), EMBED_DIM, HIDDEN_DIM)
    import jax

    jg = jax_kg.init_generator(jax.random.key(0), EMBED_DIM, NOISE_DIM)
    jd = jax_kg.init_discriminator(jax.random.key(0), EMBED_DIM, HIDDEN_DIM)
    for mine, theirs in ((g, jg), (d, jd)):
        assert mine.keys() == theirs.keys()
        for name in mine:
            assert tuple(mine[name]["w"].shape) == theirs[name]["w"].shape
            assert tuple(mine[name]["b"].shape) == theirs[name]["b"].shape
            assert float(mine[name]["b"].abs().max()) == 0.0
    again = kg_gan.init_generator(torch.Generator().manual_seed(3), EMBED_DIM, NOISE_DIM)
    assert torch.equal(again["fc1"]["w"], g["fc1"]["w"])
    # He-normal: std of fc2 is sqrt(2 / fan_in)
    assert float(g["fc2"]["w"].std()) == pytest.approx((2 / (2 * EMBED_DIM)) ** 0.5, rel=0.2)


def test_modular_generator_loads_reference_pt_strict(torch_ckpt_path, ckpt_dict):
    """The fixture's .pt (written by the JAX package) loads into the real
    nn.Modules with strict=True, and they compute what the functions do."""
    raw = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    gen = ModularGenerator(EMBED_DIM, NOISE_DIM)
    gen.load_state_dict(raw["generator"], strict=True)
    gen.to("cpu").eval()
    h, r, _, z, _ = _inputs(3)
    with torch.no_grad():
        got = gen(_t(h), _t(r), z=_t(z))
    want = jax_kg.generator_apply(ckpt_dict["generator"], jnp.asarray(h), jnp.asarray(r),
                                  jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    fn = kg_gan.generator_apply(convert_kg_params(ckpt_dict["generator"]), _t(h), _t(r), _t(z))
    np.testing.assert_allclose(got.numpy(), fn.numpy(), atol=ATOL)
    # its state dict is the layout the checkpoint writer produces
    state = params_to_torch_state(ckpt_dict["generator"])
    assert gen.state_dict().keys() == state.keys()
    np.testing.assert_array_equal(gen.state_dict()["fc1.weight"].numpy(), state["fc1.weight"])


def test_modular_generator_internal_noise_is_deterministic_per_sequence():
    h, r = _t(_inputs(4)[0]), _t(_inputs(4)[1])
    a1, a2 = ModularGenerator(EMBED_DIM, NOISE_DIM, seed=5), ModularGenerator(
        EMBED_DIM, NOISE_DIM, seed=5)
    with torch.no_grad():
        first = a1(h, r)
        assert torch.equal(first, a2(h, r))      # same seed, same call index
        assert not torch.equal(a1(h, r), first)  # successive calls differ
        assert tuple(first.shape) == (B, EMBED_DIM)


def test_modular_discriminator_loads_reference_pt_strict(torch_ckpt_path, ckpt_dict):
    raw = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    disc = ModularDiscriminator(EMBED_DIM, HIDDEN_DIM)
    disc.load_state_dict(raw["discriminator"], strict=True)
    disc.eval()
    h, r, t, _, trips = _inputs(5)
    with torch.no_grad():
        got = disc(_t(h), _t(r), _t(t))
        logits, probs = disc.score_triplets(raw["node_emb"], raw["rel_emb"], trips)
    want = jax_kg.discriminator_apply(ckpt_dict["discriminator"], jnp.asarray(h),
                                      jnp.asarray(r), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    want_l, want_p = jax_kg.discriminator_score_triplets(
        ckpt_dict["discriminator"], jnp.asarray(ckpt_dict["node_emb"]),
        jnp.asarray(ckpt_dict["rel_emb"]["weight"]), jnp.asarray(trips))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_l), atol=ATOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p), atol=ATOL)
    with pytest.raises(RuntimeError):  # strict: a wrong-sized state is refused
        ModularDiscriminator(EMBED_DIM, HIDDEN_DIM + 1).load_state_dict(
            raw["discriminator"], strict=True)
