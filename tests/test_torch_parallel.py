"""The port's parallel path (``probgan_tpu_torch/parallel/``) against the JAX
package's, on the CPU.

- ``make_mesh`` / ``resolve_mesh`` in a one-process gloo group, as
  ``tests/test_parallel.py`` holds the JAX ones;
- B4's ``rank_topk_local`` and its plain twin at every ``nvalid`` from 0 to
  the shard's rows against JAX's ``rank_topk_local`` (interpret mode), and
  the wrapper's CUDA route on meta tensors;
- one world of 4 gloo processes (``tests/torch_parallel_worker.py``, a
  ``file://`` rendezvous under ``tmp_path``): ``sharded_rank_topk`` at tp 2
  and 4 (uneven N, duplicates across shards, a shard at ``nvalid`` < k, a
  shard at ``nvalid`` 0, k above 16; k above N refused),
  ``InferenceEngine(mesh="auto")`` and
  ``cli.infer --mesh auto``, each against JAX's on the 8-device CPU mesh at
  the same inputs (and the same generator noise), ids equal and values
  within 1e-6 (``tests/test_parallel.py``'s bound), and the engine and CLI
  bit-equal to the port's own one-process results.
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
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from probgan_tpu.cli import infer as jax_infer
from probgan_tpu.engine import InferenceEngine as JaxEngine
from probgan_tpu.ops import pallas_rank
from probgan_tpu.parallel import make_mesh as jax_make_mesh
from probgan_tpu.parallel import sharded_rank_topk as jax_sharded_rank_topk
from probgan_tpu.parallel.sharded_rank import shard_entity_table as jax_shard
from probgan_tpu_torch.cli import infer as port_infer
from probgan_tpu_torch.engine import InferenceEngine
from probgan_tpu_torch.ops import _build, rank_fused
from probgan_tpu_torch.parallel import make_mesh, resolve_mesh
from tests.conftest import NUM_ENTITIES

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
ATOL = 1e-6  # tests/test_parallel.py's bound on values
H100_SMS = 132


# -- meshes in a one-process group ----------------------------------------------

@pytest.fixture
def one_process_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_make_mesh_in_one_process(one_process_group):
    mesh = make_mesh(1, device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert tuple(make_mesh(device_type="cpu").shape) == (1, 1)  # the launched world
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(8, model_parallelism=3, device_type="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8"):
        make_mesh(8, device_type="cpu")


@pytest.mark.parametrize("spec", [None, "", "1", 1, "auto", "one_device_mesh"])
def test_resolve_mesh_to_one_device(one_process_group, spec):
    """The off values, "auto" over a world of one and a one-device mesh
    whatever its axis names all collapse to None (one device)."""
    if spec == "one_device_mesh":
        spec = init_device_mesh("cpu", (1,), mesh_dim_names=("x",))
    assert resolve_mesh(spec, device_type="cpu") is None


@pytest.mark.parametrize("spec", [4, "2"])
def test_resolve_mesh_refuses_what_is_not_launched(one_process_group, spec):
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        resolve_mesh(spec, device_type="cpu")


def test_default_split_is_the_jax_packages():
    """make_mesh's default (data, model) split against the JAX package's, at
    every world size of its 8 devices."""
    from probgan_tpu_torch.parallel.mesh import default_model_parallelism

    for n in range(1, 9):
        assert default_model_parallelism(n) == jax_make_mesh(n).shape["model"], n


# -- B4 rank_topk_local at every nvalid ---------------------------------------------

def _normalized(rng, rows, d):
    x = rng.standard_normal((rows, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def shard_case():
    rng = np.random.default_rng(21)
    return _normalized(rng, 16, 128), _normalized(rng, 2048, 128)


@pytest.mark.parametrize("k", [5, 10, 16])
def test_rank_topk_local_matches_jax_at_every_nvalid(shard_case, k):
    """nvalid 0, 1, k - 1, k and the shard's 2048 rows: ids equal to JAX's
    kernel (interpret mode), the fillers' ids 0 included; values within 1e-6
    where finite and -inf where JAX's are. The wrapper on CPU tensors is the
    twin."""
    query, shard = shard_case
    jax_local = jax.jit(lambda q, t, nv: pallas_rank.rank_topk_local(q, t, k, nv,
                                                                      interpret=True))
    for nvalid in (0, 1, k - 1, k, 2048):
        wv, wi = (np.asarray(a) for a in jax_local(query, shard, jnp.int32(nvalid)))
        assert (np.isinf(wv) == (np.arange(k) >= nvalid)).all()
        for fn in (rank_fused.rank_topk_local, rank_fused.rank_topk_local_plain):
            v, i = fn(torch.from_numpy(query), torch.from_numpy(shard), k, nvalid)
            np.testing.assert_array_equal(i.numpy(), wi, err_msg=f"nvalid={nvalid}")
            np.testing.assert_array_equal(np.isinf(v.numpy()), np.isinf(wv))
            finite = np.isfinite(wv)
            np.testing.assert_allclose(v.numpy()[finite], wv[finite], atol=ATOL)


def test_rank_topk_local_normalize_is_rank_topk_fused(shard_case):
    """normalize=True takes raw queries: the one-device rank_topk_fused's
    result, bit for bit, where nvalid >= k."""
    query, shard = shard_case
    raw = torch.from_numpy(query) * 3.0
    for nvalid in (10, 2000):
        got = rank_fused.rank_topk_local(raw, torch.from_numpy(shard), 10, nvalid,
                                         normalize=True)
        want = rank_fused.rank_topk_fused(raw, torch.from_numpy(shard), 10, nvalid)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.fixture
def recorded(monkeypatch):
    """rank_fused's CUDA route on meta tensors, as on an H100 (132 SMs), the
    C launch recorded instead of run."""
    calls = []
    monkeypatch.setattr(rank_fused, "_check", lambda *a: None)
    monkeypatch.setattr(rank_fused, "_geometry",
                        lambda n, device, per_sm, tile_rows=rank_fused.TILE_ROWS:
                        rank_fused.tile_runs(n, tile_rows, per_sm * H100_SMS))
    monkeypatch.setattr(_build, "launch", lambda name, argtypes, device, *args:
                        calls.append((name, args)))
    before = dict(rank_fused.launches)
    yield calls
    rank_fused.launches.update(before)


def _c_entry_takes(args) -> bool:
    """The checks of ``probgan_rank_topk`` (csrc/rank_topk.cu) on a launch's
    arguments."""
    b, d, nvalid, k, _, tile_rows, per_block, blocks = args[4:12]
    covered = blocks * per_block * tile_rows
    return (b >= 1 and 4 <= d <= 256 and d % 4 == 0 and nvalid >= 1 and 1 <= k <= 16
            and per_block >= 1 and blocks >= 1
            and (tile_rows == 64 or (tile_rows == 128 and rank_fused.scores_k(d) <= 128))
            and (blocks - 1) * per_block * tile_rows < nvalid <= covered)


def test_c_entry_checks_are_the_mirrors():
    src = (REPO / "probgan_tpu_torch/csrc/rank_topk.cu").read_text()
    entry = src[src.index('extern "C" int probgan_rank_topk'):]
    for clause in ("nvalid < 1", "k > kMaxK", "ring_tiling_ok(tile_rows, D)",
                   "static_cast<long long>(n_blocks - 1) * tiles_per_block * tile_rows >= nvalid",
                   "static_cast<long long>(n_blocks) * tiles_per_block * tile_rows < nvalid"):
        assert clause in entry, clause


@pytest.mark.parametrize("b", [8, 64])
@pytest.mark.parametrize("k", [1, 10, 16])
def test_rank_topk_local_cuda_route_at_every_nvalid(recorded, b, k):
    """On a card's tensors: no launch at nvalid 0 (the fillers come back as
    they are); from 1 up one launch a call whose geometry the C entry takes,
    at the shard's rows of chip_smoke.py's phase (500,000) too."""
    rows, d = 500_000, 128
    pred, shard = torch.empty((b, d), device="meta"), torch.empty((rows, d), device="meta")
    for nvalid in sorted({0, 1, max(k - 1, 1), k, rows}):
        recorded.clear()
        before = rank_fused.launches["rank_topk"]
        v, i = rank_fused.rank_topk_local(pred, shard, k, nvalid)
        assert v.shape == i.shape == (b, k) and i.dtype == torch.int64
        launched = rank_fused.launches["rank_topk"] - before
        if nvalid == 0:
            assert recorded == [] and launched == 0
        else:
            (name, args), = recorded
            assert name == "rank_topk" and launched == 1
            assert args[6:9] == (nvalid, k, 0) and _c_entry_takes(args), args[4:]


@pytest.mark.parametrize("rows,k,nvalid", [(4, 5, 4), (32, 17, 4), (4, 0, 4), (4, 2, 5),
                                           (4, 2, -1)])
def test_rank_topk_local_refuses_what_a_shard_cannot_give(rows, k, nvalid):
    """k in 1..min(16, rows), nvalid in 0..rows."""
    with pytest.raises(ValueError):
        rank_fused.rank_topk_local(torch.zeros((2, 8)), torch.zeros((rows, 8)), k, nvalid)


# -- four gloo ranks against the 8-device JAX mesh ------------------------------------

CASES = {
    # name: (rows, d, queries, k, tp); the table's rows are the true N
    "even_tp2": (1024, 64, 16, 10, 2),
    "even_tp4": (1024, 64, 16, 10, 4),
    "duplicates_tp4": (1024, 32, 4, 8, 4),   # 256 rows four times: one copy a shard
    "uneven10_tp4": (10, 64, 4, 5, 4),       # shards of 3: the last at nvalid 1
    "uneven9_tp4": (9, 64, 4, 5, 4),         # the last shard all padding: nvalid 0
    "k20_tp2": (1001, 64, 8, 20, 2),         # above B4's bound: B7 masked
    "aligned_tp4": (7000, 128, 16, 10, 4),   # JAX's kernel branch, 2048-row shards
}


def _case_inputs(name, rows, d, queries, seed):
    rng = np.random.default_rng(seed)
    if name.startswith("duplicates"):
        table = np.tile(_normalized(rng, rows // 4, d), (4, 1))
    else:
        table = _normalized(rng, rows, d)
    if name.startswith("uneven"):
        # every true score negative: an unmasked pad row (cosine 0) would win
        q = -table.sum(axis=0, keepdims=True)
        query = np.tile(q / np.linalg.norm(q), (queries, 1)).astype(np.float32)
    else:
        query = _normalized(rng, queries, d)
    return table, query


def _recording_noise(monkeypatch, drawn):
    real = JaxEngine._noise

    def record(self, batch, task):
        z = real(self, batch, task)
        drawn.append(np.array(z))
        return z

    monkeypatch.setattr(JaxEngine, "_noise", record)


def _replaying_noise(monkeypatch, drawn):
    queue = list(drawn)
    monkeypatch.setattr(InferenceEngine, "_noise",
                        lambda self, batch, task: torch.from_numpy(queue.pop(0)))


def _cli(path, device=None, mesh=None):
    """The CLI calls of tests/test_parallel.py's JSON test, by task."""
    argv = {
        "predict_tails": ["--checkpoint_path", path, "--task", "predict_tails",
                          "--input_pairs", "[[0,1],[2,3],[7,4]]", "--top_k", "5", "--seed", "3"],
        "similar_entities": ["--checkpoint_path", path, "--task", "similar_entities",
                             "--input_entities", "[0,7,21]", "--top_k", "5", "--seed", "3"],
    }
    return {task: a + (["--device", device] if device else []) + (["--mesh", mesh] if mesh else [])
            for task, a in argv.items()}


def _jax_case(name, table, query):
    rows, _, _, k, tp = CASES[name]
    mesh = jax_make_mesh(8, model_parallelism=tp)
    v, i = jax_sharded_rank_topk(jnp.asarray(query), jax_shard(jnp.asarray(table), mesh), k,
                                 mesh, num_entities=rows)
    return np.asarray(v), np.asarray(i)


@pytest.fixture(scope="module")
def four_ranks(native_ckpt_path, tmp_path_factory):
    """The port's four ranks in subprocesses, and meanwhile the JAX side (its
    sharded cases compiled in threads) and the port's one-process side here;
    all of it, by kind."""
    work = tmp_path_factory.mktemp("four_ranks")
    mp = pytest.MonkeyPatch()
    arrays = {}
    for seed, (name, (rows, d, queries, _, _)) in enumerate(CASES.items()):
        arrays[f"{name}.table"], arrays[f"{name}.query"] = _case_inputs(name, rows, d,
                                                                        queries, seed)

    # the JAX engine and CLI, their generator noise recorded
    pairs, entities, top_ks = [[0, 1], [2, 3], [7, 4], [49, 6]], [0, 7, 21, NUM_ENTITIES - 1], [5, 20]
    drawn = []
    _recording_noise(mp, drawn)
    jax_engine = JaxEngine(native_ckpt_path, device="cpu", seed=0, mesh="auto")
    jax_engine_results = (
        [jax_engine.predict_tails(pairs, top_k=k, return_scores=True) for k in top_ks]
        + [jax_engine.find_similar_entities(entities, top_k=k) for k in top_ks])
    jax_cli = {}
    for label, mesh in (("one", None), ("mesh", "auto")):
        jax_cli[label] = {}
        for task, argv in _cli(native_ckpt_path, mesh=mesh).items():
            path = f"{work}/jax_{label}_{task}.json"
            jax_infer.main(argv + ["--output_file", path])
            with open(path) as f:
                jax_cli[label][task] = json.load(f)
    # the noise of the JAX engine's two predict_tails calls, then of the mesh
    # CLI's one (the one-device CLI's draw is the same draw 0 of seed 3)
    noise = drawn[:2] + drawn[3:4]
    for j, z in enumerate(noise):
        arrays[f"noise.{j}"] = z

    np.savez(work / "inputs.npz", **arrays)
    with open(work / "inputs.json", "w") as f:
        json.dump({"cases": [{"name": name, "n": c[0], "k": c[3], "tp": c[4]}
                             for name, c in CASES.items()],
                   "checkpoint": native_ckpt_path, "pairs": pairs, "entities": entities,
                   "top_ks": top_ks, "noise_draws": len(noise),
                   "cli": _cli(native_ckpt_path, device="cpu", mesh="auto")}, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests/torch_parallel_worker.py"),
                               str(r), str(WORLD), str(work)], cwd=REPO, env=env,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]

    with ThreadPoolExecutor(len(CASES)) as pool:
        jax_out = dict(zip(CASES, pool.map(
            lambda name: _jax_case(name, arrays[f"{name}.table"], arrays[f"{name}.query"]),
            CASES)))
    # the port in this process, one device, the same noise
    _replaying_noise(mp, noise)
    port_engine = InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    port_engine_results = (
        [port_engine.predict_tails(pairs, top_k=k, return_scores=True) for k in top_ks]
        + [port_engine.find_similar_entities(entities, top_k=k) for k in top_ks])
    port_cli = {}
    for task, argv in _cli(native_ckpt_path, device="cpu").items():
        path = f"{work}/port_one_{task}.json"
        port_infer.main(argv + ["--output_file", path])
        with open(path) as f:
            port_cli[task] = json.load(f)
    mp.undo()

    errs = [p.communicate(timeout=120)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    ranks = []
    for r in range(WORLD):
        with open(work / f"rank{r}.json") as f:
            ranks.append((json.load(f), dict(np.load(work / f"rank{r}.npz"))))
    cli_mesh = {}
    for task in ("predict_tails", "similar_entities"):
        with open(work / f"cli_{task}.json") as f:
            cli_mesh[task] = json.load(f)
    return {"jax": jax_out, "ranks": ranks, "jax_engine": jax_engine_results,
            "port_engine": port_engine_results, "jax_cli": jax_cli, "port_cli": port_cli,
            "cli_mesh": cli_mesh}


def _same(got, want, path="result"):
    """Equal structure, keys, ints and strings; floats within ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            _same(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for j, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{j}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= ATOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_rank_matches_jax(four_ranks, name):
    rows, _, queries, k, tp = CASES[name]
    want_v, want_i = four_ranks["jax"][name]
    local_n = -(-rows // tp)
    for r, (info, arrays) in enumerate(four_ranks["ranks"]):
        v, i = arrays[f"{name}.values"], arrays[f"{name}.ids"]
        assert v.shape == i.shape == (queries, k)
        np.testing.assert_array_equal(i, want_i, err_msg=f"rank {r}")
        np.testing.assert_allclose(v, want_v, atol=ATOL)
        assert i.max() < rows  # no pad row or filler leaked
        # every rank holds the same result, bit for bit
        np.testing.assert_array_equal(v, four_ranks["ranks"][0][1][f"{name}.values"])
        assert info[name]["shard_rows"] == local_n
        # the shard's call: B4 within its bound on k, at this shard's nvalid
        nvalid = min(max(rows - (r % tp) * local_n, 0), local_n)
        want_calls = [[min(k, local_n), nvalid]] if k <= rank_fused.MAX_K else []
        assert info[name]["local_calls"] == want_calls


def test_sharded_rank_refuses_k_above_the_entities(four_ranks):
    """N 9 over tp 2 at top_k 10: a ValueError on every rank, as the
    one-device rank raises on the same call, and not the 9 entities with a
    -inf filler as a tenth."""
    for info, _ in four_ranks["ranks"]:
        assert "k=10 must be in 1..num_entities=9" in info["k_above_n"]
    with pytest.raises(ValueError, match="k=10"):
        rank_fused.rank_topk(torch.zeros((4, 64)), torch.zeros((9, 64)), 10, 9)


def test_the_cases_reach_nvalid_below_k_and_zero(four_ranks):
    """The uneven cases really put a shard below k (10 rows: the last shard
    at nvalid 1 < k_local 3) and a shard at nvalid 0 (9 rows)."""
    calls = [four_ranks["ranks"][r][0][name]["local_calls"][0]
             for name in ("uneven10_tp4", "uneven9_tp4") for r in range(WORLD)]
    assert [3, 1] in calls and [3, 0] in calls


def test_meshes_over_four_ranks(four_ranks):
    for info, _ in four_ranks["ranks"]:
        shapes = info["meshes"]
        assert shapes["default"] == [["data", "model"], [2, 2]]
        assert shapes["dp"] == [["data", "model"], [4, 1]]
        assert shapes["tp"] == [["data", "model"], [1, 4]]
        assert shapes["auto"] == shapes["default"] and shapes["count"] == [2, 2]
        assert shapes["prebuilt"]
        assert "torchrun --nproc-per-node 2" in shapes["two_of_four"]
        assert "axis names" in shapes["other_names"]


def test_engine_mesh_matches_jax_and_one_process(four_ranks):
    """InferenceEngine(mesh="auto") on four ranks (data 2, model 2): the
    one-process engine's results bit for bit, and JAX's mesh engine's (data
    2, model 4) ids with values within 1e-6; predict_tails and
    find_similar_entities at top_k 5 (B4) and 20 (B7)."""
    for info, _ in four_ranks["ranks"]:
        engine = info["engine"]
        assert engine["device"] == "mesh(data=2,model=2)"
        assert engine["sharded_rows"] == -(-NUM_ENTITIES // 2) and engine["bf16"]
        assert engine["results"] == four_ranks["port_engine"]
        _same(engine["results"], four_ranks["jax_engine"])


def test_cli_mesh_json_matches_jax_and_one_process(four_ranks):
    """cli.infer --mesh auto under four ranks: rank 0's JSON equals the
    one-process port's and JAX's (one device and mesh: the same JSON) with
    ids equal and floats within 1e-6."""
    jax_cli = four_ranks["jax_cli"]
    assert jax_cli["one"] == jax_cli["mesh"]
    for task, got in four_ranks["cli_mesh"].items():
        assert got == four_ranks["port_cli"][task]
        _same(got, jax_cli["mesh"][task], task)
