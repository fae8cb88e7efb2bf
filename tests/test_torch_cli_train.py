"""The port's trainer CLIs (probgan_tpu_torch/cli/train.py, train_image.py)
and its numpy data helpers (native.py) on the CPU, against the JAX package's
(tests/test_train.py is the pattern).

Tolerances. Per-epoch losses of both trainers against the JAX CLIs on the
same initial state and replayed latents: rtol 1e-4 (the train step's own
bound against JAX in tests/test_torch_train.py; fp32 sums in another order).
Host against device data placement: the JAX test's 5e-4 / 5e-3. The data
helpers are compared bit for bit.
"""

import ast
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from probgan_tpu.cli import train as jtrain_cli
from probgan_tpu.cli import train_image as jimage_cli
from probgan_tpu.core import checkpoint as jcheckpoint
from probgan_tpu.core import image_checkpoint as jimage_checkpoint
from probgan_tpu.engine import train as jtrain
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu_torch import native
from probgan_tpu_torch.cli import infer as tinfer_cli
from probgan_tpu_torch.cli import train as ttrain_cli
from probgan_tpu_torch.cli import train_image as timage_cli
from probgan_tpu_torch.core import image_checkpoint as timage_checkpoint
from probgan_tpu_torch.core.convert import convert_kg_train_state, convert_progan_train_state
from probgan_tpu_torch.engine import InferenceEngine

KG_ARGS = ["--batch_size", "32", "--embed_dim", "16", "--noise_dim", "8",
           "--hidden_dim", "32", "--device", "cpu"]
IMG_ARGS = ["--synthetic", "8", "--resolution", "16", "--latent_dim", "8",
            "--fmap_base", "64", "--fmap_max", "16", "--epochs_per_stage", "1",
            "--batch_size", "4", "--device", "cpu"]
# The loss comparison with the JAX CLI: two epochs a stage, so that the
# fade-in alpha takes 0.5 and 1.0.
PARITY_ARGS = ["--synthetic", "8", "--resolution", "16", "--latent_dim", "8",
               "--fmap_base", "64", "--fmap_max", "16", "--epochs_per_stage", "2",
               "--batch_size", "4", "--device", "cpu", "--seed", "3"]


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def kg_data(tmp_path_factory):
    """A learnable synthetic KG: tail = (head + rel + 1) mod 40."""
    root = tmp_path_factory.mktemp("kgdata")
    rng = np.random.RandomState(0)
    rows = [(h, rel, (h + rel + 1) % 40) for h in range(40) for rel in range(4)]
    rng.shuffle(rows)
    split = int(0.9 * len(rows))
    for name, part in (("train.txt", rows[:split]), ("valid.txt", rows[split:])):
        with open(root / name, "w") as f:
            f.writelines(f"{h}\t{rel}\t{t}\n" for h, rel, t in part)
    return str(root)


# -- the data helpers -----------------------------------------------------------

def test_native_helpers_equal_the_jax_numpy_paths(kg_data, monkeypatch):
    """parse_triplets / sample_negatives / load_triplets against the JAX
    package's under PROBGAN_NO_NATIVE=1 (its numpy paths), bit for bit."""
    from probgan_tpu import native as jnative

    monkeypatch.setenv("PROBGAN_NO_NATIVE", "1")
    monkeypatch.setattr(jnative, "_native", None)
    path = os.path.join(kg_data, "train.txt")
    np.testing.assert_array_equal(native.parse_triplets(path), jnative.parse_triplets(path))
    assert native.parse_triplets(path).dtype == np.int32
    for n, num, seed in ((32, 40, 0), (1000, 1_000_000, 0x5EED0007)):
        got = native.sample_negatives(n, num, seed)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jnative.sample_negatives(n, num, seed))
    got, want = ttrain_cli.load_triplets(kg_data), jtrain_cli.load_triplets(kg_data)
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_native_module_is_numpy_only():
    """The port keeps no C loader: native.py imports numpy and nothing else."""
    tree = ast.parse(Path(native.__file__).read_text())
    imported = {alias.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, (ast.Import, ast.ImportFrom))
                for alias in getattr(node, "names", [])}
    modules = {node.module.split(".")[0] for node in ast.walk(tree)
               if isinstance(node, ast.ImportFrom) and node.module}
    assert (imported | modules) - {"annotations"} <= {"numpy", "__future__"}


def test_string_triplets_take_the_vocabulary(tmp_path):
    root = tmp_path / "strdata"
    root.mkdir()
    (root / "train.txt").write_text(
        "".join(f"ent{i % 5}\trel{i % 2}\tent{(i + 1) % 5}\n" for i in range(30)))
    got, want = ttrain_cli.load_triplets(str(root)), jtrain_cli.load_triplets(str(root))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_image_loaders_equal_jax(factor, tmp_path):
    imgs = timage_cli.synthetic_images(6, 16, seed=4)
    np.testing.assert_array_equal(imgs, jimage_cli.synthetic_images(6, 16, seed=4))
    x = imgs.astype(np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(timage_cli._downscale(x, factor),
                                  jimage_cli._downscale(x, factor))
    np.save(tmp_path / "images.npy", imgs)
    np.testing.assert_array_equal(timage_cli.load_images(str(tmp_path)), imgs)


# -- the KG trainer -------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["torch", "native"])
def test_kg_trainer_end_to_end(kg_data, tmp_path, capsys, fmt):
    """The C17 checkpoint loads in the port's InferenceEngine and in the JAX
    package's core/checkpoint.py."""
    out_dir = str(tmp_path / "results")
    rc = ttrain_cli.main(["--data_root", kg_data, "--epochs", "2", "--output_dir", out_dir,
                          "--checkpoint_format", fmt, *KG_ARGS])
    out = capsys.readouterr().out
    assert rc == 0 and "Training complete!" in out and "Best validation Hit@10:" in out
    assert "Device: cpu:0" in out
    path = os.path.join(out_dir, "best_checkpoint" + (".pt" if fmt == "torch" else ".msgpack"))
    engine = InferenceEngine(path, device="cpu")
    assert engine.num_entities == 40 and engine.num_relations == 4
    assert len(engine.predict_tails([(0, 1)], top_k=5)["predictions"][0]) == 5
    ckpt = jcheckpoint.load_checkpoint(path)
    assert set(ckpt) >= {"args", "node_emb", "rel_emb", "generator", "discriminator",
                         "best_val_hit10", "best_epoch", "training_history"}
    assert np.asarray(ckpt["node_emb"]).shape == (40, 16)
    assert ckpt["args"] == {"embed_dim": 16, "noise_dim": 8, "hidden_dim": 32}
    assert len(_metrics(out_dir)) == 2


def test_kg_trainer_string_vocab_and_holdout(tmp_path, capsys):
    root = tmp_path / "strdata"
    root.mkdir()
    (root / "train.txt").write_text(
        "".join(f"ent{i % 5}\trel{i % 2}\tent{(i + 1) % 5}\n" for i in range(40)))
    out_dir = str(tmp_path / "results")
    assert ttrain_cli.main(["--data_root", str(root), "--epochs", "1", "--output_dir",
                            out_dir, "--batch_size", "16", "--embed_dim", "8",
                            "--noise_dim", "4", "--hidden_dim", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Train triplets: 38" in out and "Valid triplets: 2" in out  # 5% held out
    with open(os.path.join(out_dir, "vocab.json")) as f:
        assert set(json.load(f)) == {"entities", "relations"}


def test_kg_trainer_errors(tmp_path, capsys):
    with pytest.raises(FileNotFoundError, match="Training data not found"):
        ttrain_cli.main(["--data_root", str(tmp_path / "nope"), "--device", "cpu"])
    capsys.readouterr()
    for flags in (["--mesh", "2"], ["--device", "tpu"]):
        assert ttrain_cli.main(["--data_root", str(tmp_path), *flags]) == 1
        out = capsys.readouterr().out
        assert out.startswith("Error:") and ("torchrun --nproc-per-node 2" in out
                                             or "CUDA card" in out)


def test_kg_trainer_resume_prunes_metrics(kg_data, tmp_path, capsys):
    out_dir = str(tmp_path / "resume")
    common = ["--data_root", kg_data, "--output_dir", out_dir, *KG_ARGS]
    assert ttrain_cli.main(common + ["--epochs", "2"]) == 0
    # a crashed run's later epoch and a torn line, both to be dropped
    with open(os.path.join(out_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"epoch": 3, "val_hit10": 0.0}) + "\n{\"epoch\": 4, \"va")
    capsys.readouterr()
    assert ttrain_cli.main(common + ["--epochs", "4", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "Resumed from epoch 2" in out
    assert "Epoch 3/4" in out and "Epoch 4/4" in out and "Epoch 1/4" not in out
    assert [m["epoch"] for m in _metrics(out_dir)] == [1, 2, 3, 4]


@pytest.fixture(scope="module")
def kg_parity_data(tmp_path_factory):
    """A train.txt alone, so both CLIs hold out 5% (70 rows: two eval chunks
    of 64 and 6); 1,400 rows over 300 entities and 6 relations."""
    root = tmp_path_factory.mktemp("kgparity")
    rng = np.random.RandomState(5)
    h, r = rng.randint(0, 300, 1400), rng.randint(0, 6, 1400)
    rows = np.stack([h, r, (h + 7 * r + 1) % 300], axis=1)
    rows[0] = (299, 5, 0)
    np.savetxt(root / "train.txt", rows, fmt="%d", delimiter="\t")
    return str(root)


def test_kg_trainer_losses_match_the_jax_cli(kg_parity_data, tmp_path, monkeypatch):
    """Both CLIs on one train.txt, the port started from the JAX CLI's
    initial state and replaying its noise: per-epoch d_loss, g_loss and
    val_hit10 in metrics.jsonl agree within rtol 1e-4. This holds the loop
    itself to the JAX CLI's: the hold-out, the shuffle, the negatives' seeds
    (2g and 2g + 1, 0x5EED0000 + g for the sampled softmax), the chunked
    eval and the averaging."""
    monkeypatch.setenv("PROBGAN_NO_NATIVE", "1")  # the JAX package's numpy sampler
    from probgan_tpu import native as jnative

    monkeypatch.setattr(jnative, "_native", None)
    args = ["--data_root", kg_parity_data, "--epochs", "2", "--batch_size", "64",
            "--embed_dim", "16", "--noise_dim", "8", "--hidden_dim", "32",
            "--ce_negatives", "48", "--seed", "3", "--device", "cpu"]
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jtrain_cli.main([*args, "--output_dir", jax_dir]) == 0
    with jax.default_device(jax.devices("cpu")[0]):
        init = jax.tree.map(np.asarray, jtrain.kg_init_state(
            jax.random.key(3), 300, 6, 16, 8, 32, 1e-3))
    monkeypatch.setattr(ttrain_cli, "init_state",
                        lambda *a, **k: convert_kg_train_state(init, "cpu"))
    monkeypatch.setattr(ttrain_cli, "draw_noise", lambda seed, g, n, dim: torch.from_numpy(
        np.array(jax.random.normal(jax.random.fold_in(jax.random.key(seed), g), (n, dim)))))
    monkeypatch.setattr(ttrain_cli, "draw_eval_noise", lambda seed, n, dim: torch.from_numpy(
        np.array(jax.random.normal(jax.random.key(seed + 1), (n, dim)))))
    assert ttrain_cli.main([*args, "--output_dir", port_dir]) == 0
    got, want = _metrics(port_dir), _metrics(jax_dir)
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want] == [1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g["d_loss"], g["g_loss"], g["val_hit10"]],
                                   [w["d_loss"], w["g_loss"], w["val_hit10"]], rtol=1e-4)


def test_kg_train_states_cross_between_the_clis(kg_data, tmp_path, capsys):
    """A train state the JAX CLI wrote resumes in the port's CLI, and the
    port's in the JAX CLI."""
    for first, second in ((jtrain_cli, ttrain_cli), (ttrain_cli, jtrain_cli)):
        out_dir = str(tmp_path / f"{first.__name__.split('.')[0]}")
        common = ["--data_root", kg_data, "--output_dir", out_dir, *KG_ARGS]
        assert first.main(common + ["--epochs", "1"]) == 0
        capsys.readouterr()
        assert second.main(common + ["--epochs", "2", "--resume"]) == 0
        out = capsys.readouterr().out
        assert "Resumed from epoch 1" in out and "Epoch 2/2" in out


# -- the image trainer ----------------------------------------------------------

def test_image_trainer_end_to_end(tmp_path, capsys):
    """Through the dispatcher (both forms of --model): the checkpoint loads
    in the JAX package and serves the port's generate_images."""
    out_dir = str(tmp_path / "img")
    assert ttrain_cli.main(["--model=image", *IMG_ARGS, "--output_dir", out_dir]) == 0
    out = capsys.readouterr().out
    assert "Stage 0 (4²)" in out and "Stage 2 (16²)" in out and "Training complete!" in out
    ckpt = os.path.join(out_dir, "image_checkpoint.msgpack")
    cfg, g, _ = jimage_checkpoint.load_image_checkpoint(ckpt)
    assert cfg.resolution == 16 and cfg.fmap_base == 64
    assert jax.tree.structure(g) == jax.tree.structure(
        jax.eval_shape(lambda k: jpg.init_generator(k, cfg), jax.random.key(0)))
    tinfer_cli.main(["--checkpoint_path", ckpt, "--task", "generate_images",
                     "--num_images", "2", "--device", "cpu"])
    assert "Generating 2 images at 16x16" in capsys.readouterr().out
    assert len(_metrics(out_dir)) == 3
    # the other form of the flag
    assert ttrain_cli.main(["--model", "image", *IMG_ARGS, "--output_dir", out_dir,
                            "--resume"]) == 0
    assert "Resumed after stage 2" in capsys.readouterr().out


# --fast, --bf16 with a packed gate, --packed_mode default (the default) and
# mid, and --mesh are ported: they train (the ids of the cases are kept)
@pytest.mark.parametrize("flags,item", [
    pytest.param(["--fast"], None, id="flags0-bf16"),
    pytest.param(["--bf16", "--packed_g"], None, id="flags1-bf16"),
    pytest.param(["--packed_d"], None, id="flags2-bf16"),
    pytest.param(["--packed_g", "--packed_mode", "mid"], None, id="flags3-bf16"),
    pytest.param(["--mesh", "auto"], None, id="flags4-A11"),
    (["--device", "tpu"], "CUDA card"), (["--grow"], "--resume"),
])
def test_image_trainer_unported_flags_exit_1(flags, item, tmp_path, capsys):
    """Flags that need an unported piece exit 1 before any step, naming it.
    ``--fast``, ``--bf16`` with a packed gate and the packed gates at
    ``--packed_mode`` default or mid train to the end (``--bf16`` alone:
    tests/test_torch_grades.py), and so does ``--mesh auto`` outside a
    launched world, on the one device (over four ranks:
    tests/test_torch_dp.py)."""
    out_dir = tmp_path / "x"
    if item is None:
        assert timage_cli.main([*IMG_ARGS, *flags, "--output_dir", str(out_dir)]) == 0
        assert "Training complete!" in capsys.readouterr().out
        return
    assert timage_cli.main([*IMG_ARGS, *flags, "--output_dir", str(out_dir)]) == 1
    out = capsys.readouterr().out
    assert out.startswith("Error:") and item in out
    assert not out_dir.exists()


def test_image_trainer_missing_data_exits_1(tmp_path, capsys):
    assert timage_cli.main(["--device", "cpu", "--output_dir", str(tmp_path)]) == 1
    assert "--data_root or --synthetic required" in capsys.readouterr().out


def test_image_trainer_packed_high_accum_and_mirror(tmp_path, capsys):
    """--packed_d --packed_g --packed_mode high (fp32 grade), --grad_accum 2,
    --mirror and lazy R1 train to the end."""
    out_dir = str(tmp_path / "img")
    assert timage_cli.main([
        *IMG_ARGS, "--output_dir", out_dir, "--packed_d", "--packed_g", "--packed_mode",
        "high", "--grad_accum", "2", "--batch_size", "2", "--mirror", "--r1_gamma", "1",
        "--r1_every", "2"]) == 0
    assert "Training complete!" in capsys.readouterr().out
    assert all(np.isfinite(m["d_loss"]) and np.isfinite(m["g_loss"])
               for m in _metrics(out_dir))


def test_image_trainer_data_placement_parity(tmp_path):
    """device and host placement train the same model (the JAX test's bounds)."""
    losses = {}
    for placement in ("host", "device"):
        out_dir = str(tmp_path / placement)
        assert timage_cli.main([
            "--synthetic", "12", "--resolution", "8", "--latent_dim", "8", "--fmap_base",
            "64", "--fmap_max", "16", "--epochs_per_stage", "2", "--batch_size", "4",
            "--device", "cpu", "--output_dir", out_dir, "--data_placement", placement,
            "--mirror", "--seed", "3"]) == 0
        losses[placement] = _metrics(out_dir)
    assert len(losses["host"]) == len(losses["device"]) == 4
    for h, d in zip(losses["host"], losses["device"]):
        assert abs(h["d_loss"] - d["d_loss"]) < 5e-4
        assert abs(h["g_loss"] - d["g_loss"]) < 5e-3


def test_image_trainer_mid_stage_save_and_grow(tmp_path, capsys):
    """A tiny --checkpoint_minutes saves mid-stage; --resume continues from
    that epoch; --resume --grow extends a finished 8² run to 16²."""
    out_dir = str(tmp_path / "img")
    common = ["--synthetic", "8", "--latent_dim", "8", "--fmap_base", "64", "--fmap_max",
              "16", "--batch_size", "4", "--device", "cpu", "--output_dir", out_dir]
    assert timage_cli.main(common + ["--resolution", "8", "--epochs_per_stage", "3",
                                     "--checkpoint_minutes", "1e-9"]) == 0
    capsys.readouterr()
    from probgan_tpu_torch.core import _msgpack

    def meta():
        with open(os.path.join(out_dir, "train_state.msgpack"), "rb") as f:
            return _msgpack.unpackb(f.read())["meta"]

    assert meta()["stage"] == 1 and meta()["epoch"] == 3
    # a mid-stage file: pretend the run stopped after epoch 1 of stage 1
    state_path = os.path.join(out_dir, "train_state.msgpack")
    payload = _msgpack.unpackb(open(state_path, "rb").read())
    payload["meta"]["epoch"] = 1
    open(state_path, "wb").write(_msgpack.packb(payload))
    assert timage_cli.main(common + ["--resolution", "8", "--epochs_per_stage", "3",
                                     "--resume"]) == 0
    out = capsys.readouterr().out
    assert "Resumed mid-stage 1 (next: epoch 2/3)" in out and "Stage 0" not in out
    assert timage_cli.main(common + ["--resolution", "16", "--epochs_per_stage", "1",
                                     "--resume", "--grow"]) == 0
    out = capsys.readouterr().out
    assert "Resumed after stage 1" in out and "Stage 2 (16²)" in out
    cfg, _, _ = timage_checkpoint.load_image_checkpoint(
        os.path.join(out_dir, "image_checkpoint.msgpack"))
    assert cfg.resolution == 16


def test_image_trainer_debug_names_the_step(tmp_path, monkeypatch):
    from probgan_tpu_torch.engine import train as ttrain

    real = ttrain.progan_train_step

    def nan_step(*args, **kwargs):
        state, metrics = real(*args, **kwargs)
        return state, {**metrics, "d_loss": torch.tensor(float("nan"))}

    monkeypatch.setattr(ttrain, "progan_train_step", nan_step)
    with pytest.raises(FloatingPointError, match="stage 0, epoch 1, step 1"):
        timage_cli.main([*IMG_ARGS, "--output_dir", str(tmp_path), "--debug"])


@pytest.fixture(scope="module")
def jax_image_run(tmp_path_factory):
    """The JAX CLI's run of PARITY_ARGS, its initial state and its seed."""
    out_dir = str(tmp_path_factory.mktemp("jax_img"))
    assert jimage_cli.main([*PARITY_ARGS, "--output_dir", out_dir]) == 0
    cfg = jpg.ProGANConfig(resolution=16, latent_dim=8, fmap_base=64, fmap_max=16)
    with jax.default_device(jax.devices("cpu")[0]):
        init = jtrain.progan_init_state(jax.random.key(3), cfg, 1e-3)
    return out_dir, jax.tree.map(np.asarray, init)


def _replay_jax(monkeypatch, init):
    """The port's trainer starts from the JAX CLI's initial state and draws
    the JAX CLI's latents."""
    monkeypatch.setattr(timage_cli, "init_state",
                        lambda seed, config, lr, device: convert_progan_train_state(init, device))

    def jax_latents(seed, stage, epoch, step, n, latent_dim):
        key = jax.random.fold_in(jax.random.key(seed + 1), (stage * 1000 + epoch) * 100003 + step)
        return torch.from_numpy(np.array(jax.random.normal(key, (n, latent_dim))))

    monkeypatch.setattr(timage_cli, "draw_latents", jax_latents)


def test_image_trainer_losses_match_the_jax_cli(jax_image_run, tmp_path, monkeypatch):
    """Both CLIs on the same synthetic data, initial state and latents: the
    per-epoch d_loss/g_loss in metrics.jsonl agree within rtol 1e-4; the
    shuffle and the data are the same numpy streams."""
    jax_dir, init = jax_image_run
    _replay_jax(monkeypatch, init)
    out_dir = str(tmp_path / "port")
    assert timage_cli.main([*PARITY_ARGS, "--output_dir", out_dir]) == 0
    got, want = _metrics(out_dir), _metrics(jax_dir)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert (g["stage"], g["epoch"], g["alpha"]) == (w["stage"], w["epoch"], w["alpha"])
        np.testing.assert_allclose([g["d_loss"], g["g_loss"]], [w["d_loss"], w["g_loss"]],
                                   rtol=1e-4)


def test_image_files_cross_between_the_clis(jax_image_run, tmp_path, capsys):
    """The JAX CLI's train state resumes in the port's trainer and the
    port's in the JAX trainer (one more stage each way, --grow); the JAX
    checkpoint serves the port's generate_images."""
    jax_dir, _ = jax_image_run
    ckpt = os.path.join(jax_dir, "image_checkpoint.msgpack")
    tinfer_cli.main(["--checkpoint_path", ckpt, "--task", "generate_images",
                     "--num_images", "1", "--device", "cpu"])
    assert "Generating 1 images at 16x16" in capsys.readouterr().out
    grown = list(PARITY_ARGS)
    grown[grown.index("--resolution") + 1] = "32"
    grown[grown.index("--epochs_per_stage") + 1] = "1"
    port_dir = tmp_path / "port"
    assert timage_cli.main([*PARITY_ARGS, "--output_dir", str(port_dir)]) == 0
    for name, trainer, src in (("jax_to_port", timage_cli, Path(jax_dir)),
                               ("port_to_jax", jimage_cli, port_dir)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        (out_dir / "train_state.msgpack").write_bytes((src / "train_state.msgpack").read_bytes())
        capsys.readouterr()
        assert trainer.main([*grown, "--output_dir", str(out_dir), "--resume", "--grow"]) == 0
        out = capsys.readouterr().out
        assert "Resumed after stage 2" in out and "Stage 3 (32²)" in out
        cfg, _, _ = jimage_checkpoint.load_image_checkpoint(
            str(out_dir / "image_checkpoint.msgpack"))
        assert cfg.resolution == 32
