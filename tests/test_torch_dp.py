"""The port's data parallelism for the image family
(``probgan_tpu_torch/parallel/sharded_image.py``, ``parallel/dp_train.py``,
``ImageGANEngine(mesh=)`` and the two CLIs' ``--mesh``) against the JAX
package's, on the CPU.

One world of 4 gloo processes (``tests/torch_dp_worker.py``, a ``file://``
rendezvous under ``tmp_path``) runs every case of ``tests/test_parallel.py``'s
DP half at ``ProGANConfig(resolution=16, latent_dim=8, fmap_base=64,
fmap_max=16)``; meanwhile this process computes JAX's side (its 8-device CPU
mesh, or one device) in threads and the port's one-process side. The bounds
are ``tests/test_parallel.py``'s: uint8 within +-1, logits within rtol = atol
= 1e-5, losses within 1e-5 and parameters within 5e-6 of JAX's one-device
step on the whole batch, with and without the R1 penalty. The CLIs' rank 0
is held to the one-process CLI (uint8 equal but for +-1 on at most 0.1% of
bytes; losses within 1e-5), and the other ranks print and write nothing.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.engine import train as jtrain
from probgan_tpu.engine.image import generate_fn as jax_generate_fn
from probgan_tpu.engine.image import score_fn as jax_score_fn
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu.parallel import make_mesh as jax_make_mesh
from probgan_tpu.parallel.sharded_image import dp_generate as jax_dp_generate
from probgan_tpu_torch.cli import infer as port_infer
from probgan_tpu_torch.cli import train_image as port_train_image
from probgan_tpu_torch.core import convert
from probgan_tpu_torch.core.image_checkpoint import save_image_checkpoint
from probgan_tpu_torch.core.tree import tree_leaves
from probgan_tpu_torch.engine.image import ImageGANEngine
from probgan_tpu_torch.models import pro_gan as tpg

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
SMALL = dict(resolution=16, latent_dim=8, fmap_base=64, fmap_max=16)
STAGE = 2  # the final stage at 16²
WALK_FRAMES = 10  # padded to 12 over the 4 ranks
R1_GAMMA = 10.0
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4  # a gradient leaf against JAX's, as a share of its largest entry
CLI_IMAGES = 6  # generate_images --num_images: padded to 8
TRAIN_CLI = ["--synthetic", "4", "--resolution", "8", "--latent_dim", "8", "--fmap_base", "32",
             "--fmap_max", "8", "--epochs_per_stage", "1", "--batch_size", "4", "--device", "cpu"]


def _uint8_close(got, want, max_share=None):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    if max_share is not None:
        assert np.mean(d != 0) <= max_share, np.mean(d != 0)


def _jax_side(g, d, state, arrays):
    """JAX's results on the same inputs, each in a thread: dp_generate over its
    8-device mesh, generate_fn and score_fn on one device, and one train step
    on the whole batch without and with R1."""
    cfg = jpg.ProGANConfig(**SMALL)
    z, imgs, real = (jnp.asarray(arrays[k]) for k in ("z", "images", "real"))
    jobs = {
        "dp_generate": lambda: jax_dp_generate(jax_make_mesh(8, model_parallelism=1), g, z,
                                               cfg, STAGE),
        "generate": lambda: jax_generate_fn(g, z, jnp.float32(1.0), cfg, STAGE, jnp.float32,
                                            False, None),
        "score": lambda: jax_score_fn(d, imgs, jnp.float32(0.7), cfg, STAGE, jnp.float32, None),
        **{name: (lambda r1=r1: jtrain.progan_train_step(state, real, z, jnp.float32(0.7), cfg,
                                                         STAGE, 1e-3, r1_gamma=r1))
           for name, r1 in (("train", 0.0), ("train_r1", R1_GAMMA))},
    }
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(lambda fn: jax.block_until_ready(fn()), jobs.values())))
    return {"dp_generate": np.asarray(done["dp_generate"]),
            "generate": np.asarray(done["generate"]), "score": np.asarray(done["score"]),
            **{name: (convert.convert_progan_train_state(done[name][0]),
                      {k: float(v) for k, v in done[name][1].items()})
               for name in ("train", "train_r1")}}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(0)
    g = jpg.init_generator(jax.random.key(0), jpg.ProGANConfig(**SMALL))
    d = jpg.init_discriminator(jax.random.key(0), jpg.ProGANConfig(**SMALL))
    jstate = jtrain.progan_init_state(jax.random.key(1), jpg.ProGANConfig(**SMALL))
    arrays = {
        "z": rng.standard_normal((16, 8)).astype(np.float32),
        "images": rng.uniform(-1, 1, (16, 16, 16, 3)).astype(np.float32),
        "real": (rng.standard_normal((16, 16, 16, 3)) * 0.5).astype(np.float32),
        "z0": rng.standard_normal(8).astype(np.float32),
        "z1": rng.standard_normal(8).astype(np.float32),
    }
    trees = {"g": convert.convert_generator_params(g), "d": convert.convert_discriminator_params(d),
             "state": convert.convert_progan_train_state(jstate)}
    cfg = tpg.ProGANConfig(**SMALL)
    ckpt = str(work / "image.msgpack")
    save_image_checkpoint(ckpt, cfg, trees["g"], trees["d"])
    infer_argv = ["--checkpoint_path", ckpt, "--task", "generate_images", "--num_images",
                  str(CLI_IMAGES), "--device", "cpu", "--seed", "3"]
    cli = {"infer": infer_argv + ["--mesh", "auto", "--output_file", str(work / "dp.npz")],
           "train_image": TRAIN_CLI + ["--mesh", "auto", "--output_dir", str(work / "dp_train")]}
    np.savez(work / "inputs.npz", **arrays)
    torch.save(trees, work / "trees.pt")
    with open(work / "inputs.json", "w") as f:
        json.dump({"config": SMALL, "walk_frames": WALK_FRAMES, "r1_gamma": R1_GAMMA,
                   "cli": cli}, f)

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests/torch_dp_worker.py"), str(r),
                               str(WORLD), str(work)], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]

    jax_out = _jax_side(g, d, jstate, arrays)
    # the port in this process, one device
    one = ImageGANEngine(cfg, g_params=trees["g"], d_params=trees["d"], device="cpu",
                         precision=None)
    port_one = {"score": one.score(arrays["images"]), "score3": one.score(arrays["images"][:3]),
                "walk": one.latent_walk(arrays["z0"], arrays["z1"], frames=WALK_FRAMES),
                "generate6": one.generate(arrays["z"][:6])}
    port_infer.main(infer_argv + ["--output_file", str(work / "one.npz")])
    assert port_train_image.main(TRAIN_CLI + ["--output_dir", str(work / "one_train")]) == 0

    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"jax": jax_out, "one": port_one, "ranks": ranks, "work": work, "arrays": arrays}


def test_mesh_group_is_the_default_group(four_ranks):
    assert all(out["group_is_world"] for out in four_ranks["ranks"])


def test_dp_generate_matches_jax(four_ranks):
    """Batch 16 over 4 ranks: JAX's dp_generate and generate_fn within +-1,
    every rank the same bytes; the other ranks passed other latents, so the
    first rank's were broadcast."""
    jax_out, first = four_ranks["jax"], four_ranks["ranks"][0]["generate"]
    assert first.shape == (16, 16, 16, 3)
    _uint8_close(first, jax_out["dp_generate"])
    _uint8_close(first, jax_out["generate"])
    for out in four_ranks["ranks"]:
        np.testing.assert_array_equal(out["generate"], first)


def test_dp_paths_reject_an_indivisible_batch(four_ranks):
    for out in four_ranks["ranks"]:
        for key in ("generate_indivisible", "score_indivisible", "train_indivisible"):
            assert "batch 6 must be divisible by device count 4" in out[key], key


def test_dp_score_matches_jax(four_ranks):
    """The minibatch stddev over the whole batch: JAX's one-device logits
    at alpha 0.7 within 1e-5, on every rank."""
    for out in four_ranks["ranks"]:
        assert out["score"].shape == (16,)
        np.testing.assert_allclose(out["score"], four_ranks["jax"]["score"], **LOGIT_TOL)


def test_engine_mesh_matches_one_process(four_ranks):
    """ImageGANEngine(mesh="auto"): score at 16 (DP) within 1e-5 and at 3
    (replicated: the one-device logits, bit for bit), latent_walk at 10
    frames (padded to 12) and generate at 6 (padded to 8) within +-1."""
    one = four_ranks["one"]
    for out in four_ranks["ranks"]:
        engine = out["engine"]
        assert engine["mesh_size"] == WORLD and engine["device"] == "cpu"
        np.testing.assert_allclose(engine["score"], one["score"], **LOGIT_TOL)
        np.testing.assert_array_equal(engine["score3"], one["score3"])
        assert engine["walk"].shape == (WALK_FRAMES, 16, 16, 3)
        _uint8_close(engine["walk"], one["walk"])
        _uint8_close(engine["generate6"], one["generate6"])


@pytest.mark.parametrize("name", ["train", "train_r1"])
def test_dp_train_step_matches_jax(four_ranks, name):
    """One DP step on 4 ranks against JAX's one-device step on the whole
    batch of 16 (with R1 at gamma 10: its penalty through the statistic over
    the whole batch): losses within 1e-5, every parameter within 5e-6, every
    rank's state the same bits, and a second step finite. A first Adam
    update is sign-like, so the gradients are held too: with b1 = 0 the
    first moment after one step is the gradient averaged over the ranks,
    within GRAD_REL of each leaf's largest entry."""
    want_state, want = four_ranks["jax"][name]
    first = four_ranks["ranks"][0][name]
    for key in ("d_loss", "g_loss"):
        assert abs(first["metrics"][key] - want[key]) < 1e-5, (key, first["metrics"], want)
    for tree in ("g_params", "d_params"):
        for a, b in zip(tree_leaves(getattr(first["state"], tree)),
                        tree_leaves(getattr(want_state, tree))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-6)
    for opt in ("g_opt", "d_opt"):
        for i, (a, b) in enumerate(zip(tree_leaves(getattr(first["state"], opt)[0].mu),
                                       tree_leaves(getattr(want_state, opt)[0].mu))):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            assert err <= GRAD_REL * scale + 1e-12, (opt, i, err, scale)
    assert all(np.isfinite(v) for v in first["second"].values())
    for out in four_ranks["ranks"][1:]:
        assert out[name]["metrics"] == first["metrics"]
        for a, b in zip(tree_leaves(out[name]["state"]), tree_leaves(first["state"])):
            assert torch.equal(a, b)


def test_r1_moves_the_dp_step(four_ranks):
    """The R1 case is not the plain step: the penalty moved d_loss, as it
    does in JAX's step."""
    ranks, jax_out = four_ranks["ranks"][0], four_ranks["jax"]
    assert ranks["train_r1"]["metrics"]["d_loss"] != ranks["train"]["metrics"]["d_loss"]
    assert jax_out["train_r1"][1]["d_loss"] != jax_out["train"][1]["d_loss"]


def test_cli_generate_images_mesh(four_ranks):
    """cli.infer --task generate_images --mesh auto on 4 ranks: rank 0 alone
    prints and writes the .npz, whose images are the one-process CLI's but
    for +-1 on at most 0.1% of bytes."""
    work, ranks = four_ranks["work"], four_ranks["ranks"]
    first = ranks[0]["cli_infer"]
    assert first["writes"] == [str(work / "dp.npz")]
    assert f"Images saved to: {work / 'dp.npz'}" in first["stdout"]
    for out in ranks[1:]:
        assert out["cli_infer"]["writes"] == [] and out["cli_infer"]["stdout"] == ""
    got, want = (np.load(work / f"{n}.npz")["images"] for n in ("dp", "one"))
    assert got.shape == (CLI_IMAGES, 16, 16, 3)
    _uint8_close(got, want, max_share=1e-3)


def test_cli_train_image_mesh(four_ranks):
    """cli.train_image --mesh auto, 2 steps at batch 4 (one image a rank):
    exit 0 on every rank; rank 0 alone prints and writes, one metrics.jsonl
    whose losses are the one-process run's within 1e-5."""
    work, ranks = four_ranks["work"], four_ranks["ranks"]
    first = ranks[0]["cli_train_image"]
    assert first["rc"] == 0 and "Training complete!" in first["stdout"]
    assert "Mesh: 4 devices" in first["stdout"]
    assert str(work / "dp_train" / "metrics.jsonl") in first["writes"]
    for out in ranks[1:]:
        assert out["cli_train_image"] == {"rc": 0, "writes": [], "stdout": ""}
    lines = [[json.loads(x) for x in open(work / d / "metrics.jsonl")]
             for d in ("dp_train", "one_train")]
    assert len(lines[0]) == len(lines[1]) == 2
    for got, want in zip(*lines):
        assert (got["stage"], got["epoch"]) == (want["stage"], want["epoch"])
        for key in ("d_loss", "g_loss"):
            assert abs(got[key] - want[key]) < 1e-5, (key, got, want)
    assert sorted(os.listdir(work / "dp_train")) == sorted(os.listdir(work / "one_train"))


def test_engine_mesh_outside_a_launched_world():
    """No launched world: "auto" is one device; a count of 2 raises, naming
    torchrun (no fallback to one device)."""
    cfg = tpg.ProGANConfig(**SMALL)
    assert ImageGANEngine(cfg, device="cpu", mesh="auto").mesh is None
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        ImageGANEngine(cfg, device="cpu", mesh="2")
