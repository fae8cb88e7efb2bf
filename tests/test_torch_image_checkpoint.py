"""Image-GAN checkpoints (probgan_tpu_torch/core/image_checkpoint.py) and the
CLI's generate_images task, on the CPU, both ways between the packages: a
file written by the JAX package read by the port, and a file written by the
port read by the JAX package. On disk the trees are in the JAX layout
(HWIO); in memory the port's are OIHW tensors.
"""

import json

import jax
import numpy as np
import pytest
import torch

from probgan_tpu.cli import infer as jax_infer
from probgan_tpu.core import image_checkpoint as jic
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu_torch.cli import infer
from probgan_tpu_torch.core import image_checkpoint as tic
from probgan_tpu_torch.core.convert import (
    convert_discriminator_params,
    convert_generator_params,
    generator_params_to_jax,
)
from probgan_tpu_torch.engine import ImageGANEngine
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.utils import demo_checkpoint

SMALL = dict(resolution=32, latent_dim=16, fmap_base=64, fmap_max=32)


def _numpy_tree(init, cfg, seed):
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def jax_trees():
    cfg = jpg.ProGANConfig(**SMALL)
    return (cfg, _numpy_tree(jpg.init_generator, cfg, 1),
            _numpy_tree(jpg.init_discriminator, cfg, 2),
            _numpy_tree(jpg.init_generator, cfg, 3))


def test_schema_names_match_the_jax_package():
    assert tic.IMAGE_KEYS == jic.IMAGE_KEYS
    assert tic.is_image_checkpoint({"image_generator": {}})
    assert not tic.is_image_checkpoint({"generator": {}})


@pytest.mark.parametrize("with_ema", [False, True])
def test_port_reads_what_the_jax_package_wrote(tmp_path, jax_trees, with_ema):
    jcfg, g, d, ema = jax_trees
    path = str(tmp_path / "image_checkpoint.msgpack")
    jic.save_image_checkpoint(path, jcfg, g, d, training_history={"stage": 3},
                              g_ema=ema if with_ema else None)
    cfg, g_got, d_got = tic.load_image_checkpoint(path)
    assert cfg == tpg.ProGANConfig(**SMALL) and isinstance(cfg.resolution, int)
    assert isinstance(g_got["blocks"], list) and isinstance(d_got["from_rgb"], list)
    assert g_got["base_conv"]["w"].dtype == torch.float32
    _assert_trees_equal(g_got, convert_generator_params(ema if with_ema else g))
    _assert_trees_equal(d_got, convert_discriminator_params(d))
    _, g_raw, _ = tic.load_image_checkpoint(path, prefer_ema=False)
    _assert_trees_equal(g_raw, convert_generator_params(g))
    cfg, g_raw, g_ema, d_got = tic.load_image_checkpoint_trees(path)
    _assert_trees_equal(g_raw, convert_generator_params(g))
    _assert_trees_equal(d_got, convert_discriminator_params(d))
    if with_ema:
        _assert_trees_equal(g_ema, convert_generator_params(ema))
    else:
        assert g_ema is None
    # the loaded trees drive the port's models as the JAX trees drive JAX's
    z = np.random.RandomState(4).standard_normal((2, 16)).astype(np.float32)
    want = np.asarray(jpg.generator_rgb(g, z, jcfg, 3, precision="highest"))
    got = tpg.generator_rgb(g_raw, torch.from_numpy(z), cfg, 3).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_ema", [False, True])
def test_jax_package_reads_what_the_port_wrote(tmp_path, jax_trees, with_ema):
    jcfg, g, d, ema = jax_trees
    tcfg = tpg.ProGANConfig(**SMALL)
    path = str(tmp_path / "sub" / "image_checkpoint.msgpack")  # the directory is made
    tic.save_image_checkpoint(
        path, tcfg, convert_generator_params(g), convert_discriminator_params(d),
        training_history={"stage": 3},
        g_ema=convert_generator_params(ema) if with_ema else None)
    cfg, g_got, d_got = jic.load_image_checkpoint(path)
    assert cfg == jcfg
    _assert_trees_equal(g_got, ema if with_ema else g)
    _assert_trees_equal(d_got, d)
    cfg, g_raw, g_ema, d_got = jic.load_image_checkpoint_trees(path)
    _assert_trees_equal(g_raw, g)
    if with_ema:
        _assert_trees_equal(g_ema, ema)
    else:
        assert g_ema is None
    # and the port reads its own file back to the same tensors
    _, g_back, d_back = tic.load_image_checkpoint(path, prefer_ema=False)
    _assert_trees_equal(g_back, convert_generator_params(g))
    _assert_trees_equal(generator_params_to_jax(g_back), g)


def test_empty_discriminator_both_ways(tmp_path, jax_trees):
    jcfg, g, _, _ = jax_trees
    for name, save, cfg, tree in (
            ("jax.msgpack", jic.save_image_checkpoint, jcfg, g),
            ("port.msgpack", tic.save_image_checkpoint, tpg.ProGANConfig(**SMALL),
             convert_generator_params(g))):
        path = str(tmp_path / name)
        save(path, cfg, tree)
        assert tic.load_image_checkpoint(path)[2] == {}
        assert tic.load_image_checkpoint_trees(path)[3] == {}
        assert not jic.load_image_checkpoint(path)[2]


def test_a_kg_checkpoint_is_refused_with_the_same_message(native_ckpt_path):
    with pytest.raises(ValueError) as theirs:
        jic.load_image_checkpoint(native_ckpt_path)
    for load in (tic.load_image_checkpoint, tic.load_image_checkpoint_trees):
        with pytest.raises(ValueError) as mine:
            load(native_ckpt_path)
        assert str(mine.value) == str(theirs.value)
    assert "missing 'image_generator'" in str(theirs.value)
    with pytest.raises(FileNotFoundError, match="Checkpoint not found"):
        tic.load_image_checkpoint("/nonexistent/image_checkpoint.msgpack")


def test_demo_image_checkpoint_is_seeded_and_loads_in_both(tmp_path):
    path = str(tmp_path / "demo.msgpack")
    argv = [path, "--image", "--resolution", "32", "--latent_dim", "16", "--fmap_base", "64",
            "--fmap_max", "32", "--ema", "--seed", "9"]
    assert demo_checkpoint.main(argv) == 0
    cfg, g_raw, g_ema, d = tic.load_image_checkpoint_trees(path)
    assert cfg == tpg.ProGANConfig(**SMALL)
    assert not torch.equal(g_raw["base_dense"]["w"], g_ema["base_dense"]["w"])
    trees = demo_checkpoint.make_image_checkpoint(cfg, seed=9, ema=True)
    _assert_trees_equal(g_raw, trees["g_params"])
    _assert_trees_equal(d, trees["d_params"])
    jcfg, jg, jd = jic.load_image_checkpoint(path)
    assert jcfg == jpg.ProGANConfig(**SMALL)
    _assert_trees_equal(jg, generator_params_to_jax(g_ema))
    assert np.asarray(jd["final_conv"]["w"]).shape == (3, 3, 33, 32)  # HWIO on disk


def _cli(capsys, module, argv):
    module.main(argv)
    out = capsys.readouterr().out
    return out, json.loads(out[out.index("{\n"):])


def test_generate_images_task_matches_the_jax_cli(tmp_path, jax_trees, capsys):
    """The same file through both CLIs: equal keys, shape and metadata, the
    same banner. The checksums differ: each package draws its latents from
    its own RNG stream (jax.random vs torch.Generator), the documented RNG
    gap; with shared latents the images agree (the engine tests)."""
    jcfg, g, d, ema = jax_trees
    path = str(tmp_path / "image_checkpoint.msgpack")
    jic.save_image_checkpoint(path, jcfg, g, d, g_ema=ema)
    argv = ["--checkpoint_path", path, "--task", "generate_images", "--num_images", "3",
            "--stage", "2", "--alpha", "0.5", "--device", "cpu", "--seed", "4",
            "--precision", "highest"]
    want_out, want = _cli(capsys, jax_infer, argv)
    got_out, got = _cli(capsys, infer, argv)
    assert list(got) == list(want) and got["metadata"] == want["metadata"]
    assert got["images_shape"] == want["images_shape"] == [3, 16, 16, 3]
    assert got["dtype"] == "uint8" and got["images_file"] == ""
    assert isinstance(got["checksum"], int) and got["checksum"] != want["checksum"]
    assert got_out.splitlines()[0] == want_out.splitlines()[0] == (
        "Generating 3 images at 16x16 (alpha=0.5)...")

    # the checksum is that of the engine on the same weights, seed and stream
    engine = ImageGANEngine(tpg.ProGANConfig(**SMALL), g_params=convert_generator_params(ema),
                            device="cpu", seed=4, precision="highest")
    img = engine.generate(engine.sample_latents(3), stage=2, alpha=0.5)
    assert got["checksum"] == int(img.astype(np.int64).sum())
    # --raw_generator serves the other tree
    _, raw = _cli(capsys, infer, argv + ["--raw_generator"])
    assert raw["checksum"] != got["checksum"]


def test_generate_images_outputs(tmp_path, capsys):
    path = str(tmp_path / "demo.msgpack")
    demo_checkpoint.main([path, "--image", "--resolution", "32", "--latent_dim", "16",
                          "--fmap_base", "64", "--fmap_max", "32"])
    capsys.readouterr()
    base = ["--checkpoint_path", path, "--task", "generate_images", "--device", "cpu"]
    npz = str(tmp_path / "imgs.npz")
    out, res = _cli(capsys, infer, base + ["--num_images", "2", "--output_file", npz])
    assert f"Images saved to: {npz}" in out and res["images_file"] == npz
    images = np.load(npz)["images"]
    assert images.dtype == np.uint8 and images.shape == (2, 32, 32, 3)  # --stage -1: final
    assert res["checksum"] == int(images.astype(np.int64).sum())
    assert res["metadata"] == {"num_images": 2, "stage": 3, "alpha": 1.0, "resolution": 32,
                               "seed": 0}
    js = str(tmp_path / "res.json")
    infer.main(base + ["--output_file", js])
    assert f"Results saved to: {js}" in capsys.readouterr().out
    with open(js) as f:
        assert json.load(f)["images_shape"] == [1, 32, 32, 3]
    # the bf16 grades serve too; on the CPU (unpacked, where TF32 does not
    # exist) they give the "high" images
    _, high = _cli(capsys, infer, base)
    for grade in ("default", "fast"):
        _, graded = _cli(capsys, infer, base + ["--precision", grade])
        assert graded["images_shape"] == [1, 32, 32, 3]
        assert graded["checksum"] == high["checksum"]
    # --mesh auto outside a launched world serves on the one device; a count
    # that no world gives raises (over four ranks: tests/test_torch_dp.py)
    _, meshed = _cli(capsys, infer, base + ["--mesh", "auto"])
    assert meshed == high
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        infer.main(base + ["--mesh", "2"])
