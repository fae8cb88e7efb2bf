"""The port's image engine beyond generate (probgan_tpu_torch/engine/image.py):
discriminator scoring, latent walks and the separate denorm switch, on the
CPU against the JAX engine fed the same parameters, images and latents.

Tolerances: logits 2e-4 (float reassociation, JAX at precision "highest");
uint8 frames within +-1 on at most 0.1% of bytes (tanh landing on a rounding
boundary).
"""

import jax
import numpy as np
import pytest
import torch

from probgan_tpu.engine.image import ImageGANEngine as JaxEngine
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu_torch.core.convert import (
    convert_discriminator_params,
    convert_generator_params,
)
from probgan_tpu_torch.engine import ImageGANEngine, image as engine_mod
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import image as image_ops

SMALL = dict(resolution=32, latent_dim=16, fmap_base=64, fmap_max=32)


def _assert_uint8_close(got, want, max_share=1e-3):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert np.mean(d != 0) <= max_share, np.mean(d != 0)


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine on the same numpy weights."""
    jcfg, tcfg = jpg.ProGANConfig(**SMALL), tpg.ProGANConfig(**SMALL)
    rng = np.random.RandomState(0)

    def numpy_tree(init):
        shapes = jax.eval_shape(lambda k: init(k, jcfg), jax.random.key(0))
        return jax.tree.map(
            lambda s: (rng.standard_normal(s.shape) * (1.0 if len(s.shape) > 1 else 0.1))
            .astype(np.float32), shapes)

    g, d = numpy_tree(jpg.init_generator), numpy_tree(jpg.init_discriminator)
    jax_engine = JaxEngine(jcfg, g_params=g, d_params=d, device="cpu", precision="highest")
    port = ImageGANEngine(tcfg, g_params=convert_generator_params(g),
                          d_params=convert_discriminator_params(d), device="cpu",
                          precision="highest")
    return jax_engine, port


@pytest.mark.parametrize("stage,alpha", [(None, 1.0), (2, 0.5)])
def test_score_matches_jax_engine(engines, stage, alpha):
    jax_engine, port = engines
    res = 32 if stage is None else 4 * 2**stage
    img = np.random.RandomState(3).uniform(-1, 1, (4, res, res, 3)).astype(np.float32)
    want = jax_engine.score(img, stage=stage, alpha=alpha)
    got = port.score(img, stage=stage, alpha=alpha)
    assert isinstance(got, np.ndarray) and got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # a tensor input, and the images the engine itself makes (uint8 -> [-1, 1])
    np.testing.assert_array_equal(port.score(torch.from_numpy(img), stage, alpha), got)
    own = port.generate(port.sample_latents(2)).astype(np.float32) / 127.5 - 1.0
    assert np.isfinite(port.score(own)).all()


@pytest.mark.parametrize("frames", [8, 12, 5])
def test_latent_walk_matches_jax_engine(engines, frames):
    """8 frames: one chunk; 12: two chunks, the last zero-padded and cut; 5:
    below one chunk, rendered as one batch of 5."""
    jax_engine, port = engines
    rng = np.random.RandomState(4)
    z0, z1 = (rng.standard_normal(16).astype(np.float32) for _ in range(2))
    want = jax_engine.latent_walk(z0, z1, frames=frames)
    got = port.latent_walk(z0, z1, frames=frames)
    assert got.shape == (frames, 32, 32, 3)
    _assert_uint8_close(got, want)
    # the ends are the renders of z0 and z1 themselves
    _assert_uint8_close(got[:1], port.generate(z0[None]))
    _assert_uint8_close(got[-1:], port.generate(z1[None]))
    assert (got[0] != got[-1]).any()


def test_latent_walk_renders_in_chunks_of_8(engines, monkeypatch):
    _, port = engines
    batches = []
    generate = engine_mod.generate_fn
    monkeypatch.setattr(engine_mod, "generate_fn", lambda g, z, *a, **k: (
        batches.append(z.clone()), generate(g, z, *a, **k))[1])
    z0, z1 = torch.zeros(16), torch.ones(16)
    out = port.latent_walk(z0, z1, frames=12, stage=2, alpha=0.5)
    assert out.shape == (12, 16, 16, 3)
    assert [tuple(z.shape) for z in batches] == [(8, 16), (8, 16)]
    assert float(batches[1][4:].abs().max()) == 0.0  # the zero padding
    np.testing.assert_allclose(batches[1][3].numpy(), np.ones(16), atol=1e-6)  # t = 1


def test_use_pallas_switch_argument_and_env(engines, monkeypatch):
    """use_pallas routes generate through generator_rgb + to_uint8_fused;
    None reads PROBGAN_PALLAS_UINT8. Same bytes either way on the CPU (both
    are torch's tanh and round there), and the JAX engine's within +-1."""
    jax_engine, port = engines
    cfg = port.config
    assert port.use_pallas is False
    monkeypatch.setenv("PROBGAN_PALLAS_UINT8", "1")
    assert ImageGANEngine(cfg, device="cpu").use_pallas is True
    assert ImageGANEngine(cfg, device="cpu", use_pallas=False).use_pallas is False
    monkeypatch.setenv("PROBGAN_PALLAS_UINT8", "0")
    assert ImageGANEngine(cfg, device="cpu").use_pallas is False
    fused = ImageGANEngine(cfg, g_params=port.g_params, d_params=port.d_params,
                           device="cpu", use_pallas=True, precision="highest")
    calls = []
    denorm = image_ops.to_uint8_fused
    monkeypatch.setattr(image_ops, "to_uint8_fused",
                        lambda rgb: (calls.append(tuple(rgb.shape)), denorm(rgb))[1])
    z = np.random.RandomState(5).standard_normal((3, 16)).astype(np.float32)
    got = fused.generate(z)
    assert calls == [(3, 32, 32, 3)]
    np.testing.assert_array_equal(got, port.generate(z))
    assert calls == [(3, 32, 32, 3)]  # the default path does not call it
    _assert_uint8_close(got, jax_engine.generate(z))
    walk = fused.latent_walk(z[0], z[1], frames=3, stage=1)
    assert walk.shape == (3, 8, 8, 3) and calls[-1] == (3, 8, 8, 3)


def test_engine_seeds_both_networks_and_rejects_a_mesh():
    cfg = tpg.ProGANConfig(**SMALL)
    a, b = ImageGANEngine(cfg, device="cpu", seed=5), ImageGANEngine(cfg, device="cpu", seed=5)
    assert torch.equal(a.d_params["final_dense"]["w"], b.d_params["final_dense"]["w"])
    assert torch.equal(a.g_params["base_dense"]["w"], b.g_params["base_dense"]["w"])
    other = ImageGANEngine(cfg, device="cpu", seed=6)
    assert not torch.equal(a.d_params["final_dense"]["w"], other.d_params["final_dense"]["w"])
    assert a.d_params["from_rgb"][3]["w"].shape == (8, 3, 1, 1)
    # a mesh outside a launched world: "auto" is the one device, a count
    # that no world gives raises (the mesh paths: tests/test_torch_dp.py)
    assert ImageGANEngine(cfg, device="cpu", mesh="auto").mesh is None
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        ImageGANEngine(cfg, device="cpu", mesh="2")
    assert ImageGANEngine(cfg, device="cpu", mesh="").device.type == "cpu"
