"""The port's row-sharded KG training (``probgan_tpu_torch/parallel/dp_train.py``
``shard_kg_state`` / ``kg_batch_sharding`` / ``gather_kg_state``,
``parallel/sharded_kg.py``, ``kg_train_step(mesh=)``, ``kg_eval_hits(mesh=)``
and ``cli.train --mesh``) against the JAX package's, on the CPU.

One world of 4 gloo processes (``tests/torch_kg_tp_worker.py``, a ``file://``
rendezvous under ``tmp_path``) builds a (2, 2) and a (1, 4) mesh and runs,
at N 61 (shards 31/30 and 16/16/16/13) and N 64, R 4, D 16, noise 8, hidden
32, global batch 8, two steps with ids repeated within the batch and across
shards, with the corrupted negatives, once with a sampled softmax whose
negatives collide with true tails and once with the full softmax; then
``cli.train --mesh auto``. Meanwhile this process computes JAX's side in
threads (at N 64 its sharded step on ``make_mesh(4, model_parallelism=2)``;
at N 61, which JAX's mesh refuses, its one-device step, which GSPMD's
equals) and the port's one-process side.

The bounds: against JAX those of ``tests/test_torch_train.py`` for the
one-process step (metrics rtol 1e-4, every leaf within 0.6 lr), Hit@10
equal; against the port's one-process step losses within 1e-6 relative and
every leaf within ``PARAM_TOL`` (the Adam moments included: a backward that
summed the table's gradient over "model" would put the first moment of every
looked-up row tp times off), Hit@10 equal.
"""

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from probgan_tpu.engine import train as jtrain
from probgan_tpu.parallel import make_mesh as jax_make_mesh
from probgan_tpu.parallel.dp_train import kg_batch_sharding as jax_batch_sharding
from probgan_tpu.parallel.dp_train import shard_kg_state as jax_shard_kg_state
from probgan_tpu_torch.cli import train as port_train_cli
from probgan_tpu_torch.core import convert
from probgan_tpu_torch.core.tree import tree_leaves
from probgan_tpu_torch.engine import InferenceEngine
from probgan_tpu_torch.engine import train as ttrain

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
TPS = (2, 4)  # meshes (2, 2) and (1, 4) of the one world
ENTITIES = (61, 64)
VARIANTS = ("sampled", "full")
# JAX's side: at N 64 its sharded step with the sampled softmax, at N 61 its
# one-device step with the full softmax (a JAX compile costs ~2-3 s a case)
JAX_RUNS = ((64, "sampled"), (61, "full"))
R, D, NOISE, HIDDEN, B, S = 4, 16, 8, 32, 8, 24
LR = 1e-3
PARAM_TOL = dict(rtol=4e-3, atol=0.6 * LR)  # tests/test_torch_train.py's
METRICS = ("d_loss", "g_loss", "real_logit", "fake_logit", "gen_cosine")
CLI_ARGS = ["--batch_size", "32", "--embed_dim", "16", "--noise_dim", "8", "--hidden_dim",
            "32", "--device", "cpu"]


def _batch(rs, n):
    """A step's triplets [B, 3] (ids repeated within the batch: rows 0/1 share
    a head, rows 2/3 a tail, on either side of a shard boundary), corrupted
    negatives [B, 2] and sampled-softmax ids [S] (two collide with true
    tails), int64."""
    trip = np.stack([rs.randint(0, n, B), rs.randint(0, R, B), rs.randint(0, n, B)], axis=1)
    trip[1, 0] = trip[0, 0]
    trip[2, 2], trip[3, 2] = 5, 5
    trip[4, 2], trip[5, 0] = n - 1, n // 2
    neg = np.stack([rs.randint(0, n, B), rs.randint(0, R, B)], axis=1)
    ce = rs.randint(0, n, S)
    ce[:2] = trip[:2, 2]
    return trip.astype(np.int64), neg.astype(np.int64), ce.astype(np.int64)


def _inputs():
    """For each N: the initial state (the port's init, carried into JAX's
    ``KGTrainState`` through the train state's dict form), two steps'
    batches, keys and the noise JAX's step draws from them, an eval batch
    and its noise."""
    normal = jax.jit(lambda key: jax.random.normal(key, (B, NOISE), jnp.float32))
    out = {}
    for n in ENTITIES:
        rs = np.random.RandomState(n)
        steps = []
        for i in range(2):
            key = jax.random.key(100 + n + i)
            trip, neg, ce = _batch(rs, n)
            steps.append({"triplets": trip, "negatives": neg, "ce": ce,
                          "z": np.array(normal(key)), "key": key})
        ev = np.stack([rs.randint(0, n, 13), rs.randint(0, R, 13), rs.randint(0, n, 13)],
                      axis=1).astype(np.int64)
        state = ttrain.kg_init_state(n, n, R, D, NOISE, HIDDEN, LR, device="cpu")
        template = jax.eval_shape(
            lambda key, n=n: jtrain.kg_init_state(key, n, R, D, NOISE, HIDDEN, LR),
            jax.random.key(0))
        out[n] = {"state": state, "steps": steps,
                  "jstate": serialization.from_state_dict(
                      template,
                      serialization.to_state_dict(convert.kg_train_state_to_jax(state))),
                  "eval": {"triplets": ev,
                           "z": rs.standard_normal((13, NOISE)).astype(np.float32)}}
    return out


def _jax_run(case, n, variant):
    """JAX's two steps and Hit@10: sharded on its (2, 2) mesh at N 64, on one
    device at N 61."""
    mesh = jax_make_mesh(4, model_parallelism=2) if n == 64 else None
    state = case["jstate"] if mesh is None else jax_shard_kg_state(mesh, case["jstate"])
    place = (lambda a: jnp.asarray(a)) if mesh is None else (
        lambda a: jax.device_put(jnp.asarray(a), jax_batch_sharding(mesh)))
    metrics = []
    for step in case["steps"]:
        state, m = jtrain.kg_train_step(
            state, place(step["triplets"]), step["key"], LR, negatives=place(step["negatives"]),
            ce_negatives=jnp.asarray(step["ce"]) if variant == "sampled" else None)
        metrics.append({k: float(v) for k, v in m.items()})
    state = jax.tree.map(np.asarray, state)
    hits = float(jtrain.kg_eval_hits(state.g_params, state.node_emb, state.rel_emb,
                                     jnp.asarray(case["eval"]["triplets"]),
                                     jnp.asarray(case["eval"]["z"]), k=10))
    return convert.convert_kg_train_state(state, "cpu"), metrics, hits


def _port_run(state, case, variant):
    """The port's one-process two steps and Hit@10."""
    metrics = []
    for step in case["steps"]:
        state, m = ttrain.kg_train_step(
            state, torch.from_numpy(step["triplets"]), lr=LR,
            negatives=torch.from_numpy(step["negatives"]),
            ce_negatives=torch.from_numpy(step["ce"]) if variant == "sampled" else None,
            z=torch.from_numpy(step["z"]))
        metrics.append({k: float(v) for k, v in m.items()})
    hits = float(ttrain.kg_eval_hits(state.g_params, state.node_emb, state.rel_emb,
                                     torch.from_numpy(case["eval"]["triplets"]),
                                     torch.from_numpy(case["eval"]["z"]), 10))
    return state, metrics, hits


@pytest.fixture(scope="module")
def kg_data(tmp_path_factory):
    """``tests/test_torch_cli_train.py``'s learnable KG: 40 entities (= 2 D +
    noise: a generator weight has the table's shape), 4 relations."""
    root = tmp_path_factory.mktemp("kgdata")
    rng = np.random.RandomState(0)
    rows = [(h, rel, (h + rel + 1) % 40) for h in range(40) for rel in range(4)]
    rng.shuffle(rows)
    split = int(0.9 * len(rows))
    for name, part in (("train.txt", rows[:split]), ("valid.txt", rows[split:])):
        with open(root / name, "w") as f:
            f.writelines(f"{h}\t{rel}\t{t}\n" for h, rel, t in part)
    return str(root)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory, kg_data):
    work = tmp_path_factory.mktemp("kg_tp")
    cases = _inputs()
    states = {n: c["state"] for n, c in cases.items()}
    tensors = lambda d: {k: torch.from_numpy(v) for k, v in d.items() if k != "key"}  # noqa: E731
    torch.save({"states": {str(n): s for n, s in states.items()},
                "steps": {str(n): [tensors(s) for s in c["steps"]] for n, c in cases.items()},
                "eval": {str(n): tensors(c["eval"]) for n, c in cases.items()}},
               work / "inputs.pt")
    common = ["--data_root", kg_data, *CLI_ARGS, "--mesh", "auto", "--output_dir",
              str(work / "mesh")]
    with open(work / "inputs.json", "w") as f:
        json.dump({"tps": TPS, "entities": ENTITIES, "variants": VARIANTS, "lr": LR,
                   "cli": {"train": common + ["--epochs", "2"],
                           "resume": common + ["--epochs", "3", "--resume"]}}, f)

    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests/torch_kg_tp_worker.py"),
                               str(r), str(WORLD), str(work)], cwd=REPO, env=env,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for r in range(WORLD)]

    with ThreadPoolExecutor(len(JAX_RUNS)) as pool:
        jax_out = dict(zip(JAX_RUNS, pool.map(lambda nv: _jax_run(cases[nv[0]], *nv),
                                              JAX_RUNS)))
    one = {(n, v): _port_run(states[n], cases[n], v) for n in ENTITIES for v in VARIANTS}
    one_dir = str(work / "one")
    for argv in (["--epochs", "2"], ["--epochs", "3", "--resume"]):
        assert port_train_cli.main(["--data_root", kg_data, *CLI_ARGS, "--output_dir", one_dir,
                                    *argv]) == 0

    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"jax": jax_out, "one": one, "ranks": ranks, "work": work, "states": states,
            "kg_data": kg_data}


def _leaves_close(got, want, label, **tol):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape, (label, i)
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=f"{label} leaf {i}", **tol)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("n", ENTITIES)
def test_shard_kg_state_places_table_and_moments(four_ranks, tp, n):
    """The table and both of its Adam moments are each rank's rows along
    "model" (zero-padded: 31/30 at tp 2, 16/16/16/13 at tp 4 for N 61), the
    other leaves replicated, and ``gather_kg_state`` of the placed state is
    the state bit for bit on rank 0's CPU and None on every other rank."""
    local_n = -(-n // tp)
    for rank, out in enumerate(four_ranks["ranks"]):
        p = out["placement"][f"tp{tp}_N{n}"]
        i = rank % tp  # the model index: ranks in row-major (data, model) order
        assert p["rows"] == [n, local_n, min(max(n - i * local_n, 0), local_n), i * local_n]
        assert p["table_rows"] == [True, True, True]
        assert p["others_whole"] and p["n_others"] == len(tree_leaves(four_ranks["states"][n])) - 3
        assert p["gathered"] is (True if rank == 0 else None)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("n,variant", JAX_RUNS)
def test_sharded_steps_match_jax(four_ranks, n, variant, tp):
    """Two sharded steps against JAX's (its mesh at N 64 with the sampled
    softmax, one device at N 61 with the full one): metrics within rtol
    1e-4 at each step, every leaf of the state within 0.6 lr, Hit@10 equal;
    the same metrics and Hit@10 on every rank, and every rank's part of the
    state its rows of rank 0's gathered state (the padding zero), the other
    leaves equal."""
    want_state, want_metrics, want_hits = four_ranks["jax"][(n, variant)]
    first = four_ranks["ranks"][0]["steps"][f"tp{tp}_N{n}_{variant}"]
    for got, want in zip(first["metrics"], want_metrics):
        for name in METRICS:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4, err_msg=name)
    _leaves_close(first["state"], want_state, "vs JAX", atol=0.6 * LR, rtol=0)
    assert first["hits"] == want_hits
    for rank, out in enumerate(four_ranks["ranks"]):
        mine = out["steps"][f"tp{tp}_N{n}_{variant}"]
        assert mine["metrics"] == first["metrics"] and mine["hits"] == first["hits"]
        assert rank == 0 or mine["state"] is None
        _, local_n, nvalid, offset = out["placement"][f"tp{tp}_N{n}"]["rows"]
        for i, (a, b) in enumerate(zip(tree_leaves(mine["local"]), tree_leaves(first["state"]))):
            if i in mine["table_at"]:
                assert a.shape[0] == local_n and not a[nvalid:].any(), (rank, i)
                a, b = a[:nvalid], b[offset:offset + nvalid]
            assert torch.equal(a, b), (rank, i)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("n", ENTITIES)
def test_sharded_steps_match_one_process(four_ranks, n, tp, variant):
    """Two sharded steps against the port's one-process step on the whole
    batch: losses within 1e-6 relative, every leaf (parameters and Adam
    moments) within PARAM_TOL, Hit@10 equal."""
    want_state, want_metrics, want_hits = four_ranks["one"][(n, variant)]
    first = four_ranks["ranks"][0]["steps"][f"tp{tp}_N{n}_{variant}"]
    for got, want in zip(first["metrics"], want_metrics):
        for name in METRICS:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-6, err_msg=name)
    _leaves_close(first["state"], want_state, "vs one process", **PARAM_TOL)
    assert first["hits"] == want_hits


def test_mesh_step_refusals(four_ranks):
    """A batch the data axis does not divide, and a mesh step on a state
    that ``shard_kg_state`` did not place, raise ValueError."""
    for out in four_ranks["ranks"]:
        assert "batch 3 must be divisible by the data axis's 2 devices" in out["tp2_indivisible"]
        for tp in TPS:
            assert "is not this rank's shard of 64 rows" in out[f"tp{tp}_unplaced"]


def _metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_train_mesh(four_ranks, tmp_path, capsys):
    """cli.train --mesh auto on 4 ranks ((2, 2): batch 32 split in two), 2
    epochs then --resume to 3: exit 0 on every rank, rank 0 alone prints and
    writes (one metrics.jsonl), whose losses are the one-process CLI's
    within 1e-6 and whose Hit@10 equal it; at each epoch's save rank 0
    alone gets the whole state, on its CPU, and every rank held only its
    20-row part of the table and its moments; the files are the one-process
    format: the one-process trainer resumes from them and InferenceEngine
    serves the checkpoint."""
    work, ranks = four_ranks["work"], four_ranks["ranks"]
    for name in ("train", "resume"):
        first = ranks[0][f"cli_{name}"]
        assert first["rc"] == 0 and "Training complete!" in first["stdout"]
        assert "Mesh: 4 devices {'data': 2, 'model': 2}" in first["stdout"]
        assert str(work / "mesh" / "metrics.jsonl") in first["writes"]
        for rank, out in enumerate(ranks):
            gathers = out[f"cli_{name}_gathers"]
            assert len(gathers) == (2 if name == "train" else 1)
            want = {"held_rows": [20, 20, 20], "whole_rows": 40, "whole_devices": ["cpu"]}
            if rank:
                want.update(whole_rows=None, whole_devices=None)
                assert out[f"cli_{name}"] == {"rc": 0, "writes": [], "stdout": ""}
            assert all(g == want for g in gathers), (rank, gathers)
    assert "Resumed from epoch 2" in ranks[0]["cli_resume"]["stdout"]
    got, want = _metrics(work / "mesh"), _metrics(work / "one")
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want] == [1, 2, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose([g["d_loss"], g["g_loss"]], [w["d_loss"], w["g_loss"]],
                                   rtol=1e-6)
        assert g["val_hit10"] == w["val_hit10"]
    assert sorted(os.listdir(work / "mesh")) == sorted(os.listdir(work / "one"))

    resumed = str(tmp_path / "resumed")
    shutil.copytree(work / "mesh", resumed)
    assert port_train_cli.main(["--data_root", four_ranks["kg_data"], *CLI_ARGS,
                                "--output_dir", resumed, "--epochs", "4", "--resume"]) == 0
    assert "Resumed from epoch 3" in capsys.readouterr().out
    engine = InferenceEngine(str(work / "mesh" / "best_checkpoint.pt"), device="cpu")
    assert engine.num_entities == 40
    assert len(engine.predict_tails([[0, 1]], top_k=5)["predictions"][0]) == 5
