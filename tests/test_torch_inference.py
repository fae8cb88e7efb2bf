"""The port's InferenceEngine against the JAX package's on the fixture
checkpoint, on the CPU.

Both engines get the same generator noise: the JAX engine's draws are
captured as numpy arrays and replayed into the port through a test-only
override of its ``_noise``. Ids, relation ids and dict keys must be equal;
floats agree to atol 1e-5 (fp32 sums taken in another order).
"""

import json
import os

import numpy as np
import pytest
import torch

from probgan_tpu.engine import InferenceEngine as JaxEngine
from probgan_tpu_torch.engine import InferenceEngine
from probgan_tpu_torch.engine import inference as port_inference
from probgan_tpu_torch.ops import rank_fused
from tests.conftest import NUM_ENTITIES, NUM_RELATIONS

ATOL = 1e-5
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)


def _assert_same(got, want, path="result"):
    """Equal structure, keys, ints and strings; floats within ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert got == pytest.approx(want, abs=ATOL), path
    else:
        assert type(got) is type(want) and got == want, path


def _share_noise(monkeypatch, jax_engine, port_engine):
    """Record the JAX engine's noise draws and replay them, in order, as the
    port engine's."""
    drawn = []
    jax_noise = jax_engine._noise

    def record(batch, task):
        z = jax_noise(batch, task)
        drawn.append((task, np.array(z)))
        return z

    def replay(batch, task):
        drawn_task, z = drawn.pop(0)
        assert drawn_task == task and z.shape[0] == batch
        return torch.from_numpy(z)

    monkeypatch.setattr(jax_engine, "_noise", record)
    monkeypatch.setattr(port_engine, "_noise", replay)


@pytest.fixture
def engines(native_ckpt_path, monkeypatch):
    jax_engine = JaxEngine(native_ckpt_path, device="cpu", seed=0)
    port_engine = InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    _share_noise(monkeypatch, jax_engine, port_engine)
    return jax_engine, port_engine


@pytest.fixture(scope="module")
def engine(native_ckpt_path):
    return InferenceEngine(native_ckpt_path, device="cpu", seed=0)


def test_banners_match_the_jax_engine(native_ckpt_path, capsys):
    JaxEngine(native_ckpt_path, device="cpu", seed=0)
    want = capsys.readouterr().out
    InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    assert capsys.readouterr().out == want
    assert "Inference ready!" in want and "Device: cpu:0" in want


@pytest.mark.parametrize("pairs,top_k", [([(0, 1), (2, 3)], 5), ([(7, 6)], 1),
                                          ([(i, i % NUM_RELATIONS) for i in range(11)], 10),
                                          ([(3, 2), (49, 0)], 20)])
def test_predict_tails_matches_jax(engines, pairs, top_k):
    jax_engine, port = engines
    want = jax_engine.predict_tails(pairs, top_k=top_k, return_scores=True)
    got = port.predict_tails(pairs, top_k=top_k, return_scores=True)
    _assert_same(got, want)
    assert "scores" not in port.predict_tails([], top_k=top_k)


def test_predict_tails_golden_under_jax_noise(engines):
    """The noise-dependent golden is met when the port is fed the JAX
    package's noise (its own stream has other bits: the allowed RNG gap)."""
    jax_engine, port = engines
    jax_engine.predict_tails([(0, 1), (2, 3)], top_k=5, return_scores=True)
    got = port.predict_tails([(0, 1), (2, 3)], top_k=5, return_scores=True)
    _assert_same(json.loads(json.dumps(got)), _golden("predict_tails.json"))


@pytest.mark.parametrize("method", ["both", "generator", "discriminator"])
def test_score_triplets_matches_jax(engines, method):
    jax_engine, port = engines
    trips = [(0, 1, 2), (3, 4, 5), (49, 6, 0)]
    want = jax_engine.score_triplets(trips, method=method)
    got = port.score_triplets(trips, method=method)
    _assert_same(got, want)
    if method == "both":  # the second draw of the same task
        want = jax_engine.score_triplets(trips[:2])
        _assert_same(port.score_triplets(trips[:2]), want)


def test_score_triplets_golden_under_jax_noise(engines):
    jax_engine, port = engines
    jax_engine.score_triplets([(0, 1, 2), (3, 4, 5)], method="both")
    got = port.score_triplets([(0, 1, 2), (3, 4, 5)], method="both")
    _assert_same(json.loads(json.dumps(got)), _golden("score_triplets.json"))


@pytest.mark.parametrize("ids,top_k", [([0, 7], 4), ([5], 1), (list(range(9)), 10),
                                        ([1, 2], 30)])
def test_find_similar_entities_matches_jax(engines, ids, top_k):
    jax_engine, port = engines
    want = jax_engine.find_similar_entities(ids, top_k=top_k)
    got = port.find_similar_entities(ids, top_k=top_k)
    _assert_same(got, want)
    for entry in got["similar_entities"]:
        assert entry["query_entity"] not in entry["similar_entities"]


@pytest.mark.parametrize("heads,tails,top_k", [([1], [2], 3), ([0, 4, 9], [1, 2, 3], 5),
                                                ([3], [3], 7)])
def test_analyze_relations_matches_jax(engines, heads, tails, top_k):
    jax_engine, port = engines
    want = jax_engine.analyze_relations(heads, tails, top_k=top_k)
    got = port.analyze_relations(heads, tails, top_k=top_k)
    _assert_same(got, want)


def test_golden_similar_entities(engine):
    got = engine.find_similar_entities([0, 7], top_k=4)
    _assert_same(json.loads(json.dumps(got)), _golden("similar_entities.json"))


def test_golden_analyze_relations(engine):
    got = engine.analyze_relations([1], [2], top_k=3)
    _assert_same(json.loads(json.dumps(got)), _golden("analyze_relations.json"))


def test_golden_model_info(engine, native_ckpt_path):
    golden = _golden("model_info.json")
    golden["checkpoint_path"] = native_ckpt_path  # tmp path varies per run
    assert json.loads(json.dumps(engine.get_model_info())) == golden
    assert golden["device"] == "cpu:0"


def test_pt_and_msgpack_checkpoints_give_the_same_results(native_ckpt_path, torch_ckpt_path):
    a = InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    b = InferenceEngine(torch_ckpt_path, device="cpu", seed=0)
    assert a.predict_tails([(0, 1), (2, 3)], 5, True) == b.predict_tails([(0, 1), (2, 3)], 5, True)


def test_empty_inputs_match_jax(engines):
    jax_engine, port = engines
    assert port.predict_tails([], 5, return_scores=True) == jax_engine.predict_tails(
        [], 5, return_scores=True)
    assert port.score_triplets([]) == jax_engine.score_triplets([])
    assert port.score_triplets([], "generator") == jax_engine.score_triplets([], "generator")
    assert port.find_similar_entities([]) == jax_engine.find_similar_entities([])
    assert port.analyze_relations([], [1]) == jax_engine.analyze_relations([], [1])
    assert port.analyze_relations([1], []) == jax_engine.analyze_relations([1], [])


@pytest.mark.parametrize("call", [
    lambda e: e.predict_tails([(0, 1), (NUM_ENTITIES, 0)]),
    lambda e: e.predict_tails([(0, NUM_RELATIONS)]),
    lambda e: e.predict_tails([(-1, 0)]),
    lambda e: e.score_triplets([(0, 0, NUM_ENTITIES + 3)]),
    lambda e: e.score_triplets([(0, -2, 0)]),
    lambda e: e.find_similar_entities([0, 99]),
    lambda e: e.analyze_relations([0], [NUM_ENTITIES]),
    lambda e: e.analyze_relations([-5], [0]),
])
def test_out_of_range_ids_raise_the_same_index_error(engines, call):
    jax_engine, port = engines
    with pytest.raises(IndexError) as want:
        call(jax_engine)
    with pytest.raises(IndexError) as got:
        call(port)
    assert str(got.value) == str(want.value)
    assert "out of range [0, " in str(got.value)


def test_bucket_padding_does_not_leak(native_ckpt_path, monkeypatch):
    """3 queries ride in a bucket of 8: rows 3..7 never show, and the first
    three rows do not depend on what the padding rows hold."""
    port = InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    z = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    pairs = [(4, 1), (5, 2), (6, 3)]
    monkeypatch.setattr(port, "_noise", lambda batch, task: z.clone())
    a = port.predict_tails(pairs, top_k=5, return_scores=True)
    assert len(a["predictions"]) == 3 and len(a["scores"]) == 3
    z2 = z.clone()
    z2[3:] = 100.0  # other noise in the padding rows only
    monkeypatch.setattr(port, "_noise", lambda batch, task: z2.clone())
    assert port.predict_tails(pairs, top_k=5, return_scores=True) == a
    assert port_inference._bucket(1) == 8 and port_inference._bucket(9) == 16
    assert port_inference._bucket(64) == 64 and port_inference._bucket(65) == 128
    np.testing.assert_array_equal(port_inference._pad_ids([3, 4], 4), [3, 4, 0, 0])


def test_top_k_is_clamped_to_entities_and_relations(engines):
    jax_engine, port = engines
    want = jax_engine.find_similar_entities([3], top_k=NUM_ENTITIES + 10)
    got = port.find_similar_entities([3], top_k=NUM_ENTITIES + 10)
    _assert_same(got, want)
    assert len(got["similar_entities"][0]["similar_entities"]) == NUM_ENTITIES - 1
    want = jax_engine.analyze_relations([0], [1], top_k=NUM_RELATIONS + 5)
    got = port.analyze_relations([0], [1], top_k=NUM_RELATIONS + 5)
    _assert_same(got, want)
    rels = [r["relation_id"] for r in got["relation_analysis"][0]["top_relations"]]
    assert sorted(rels) == list(range(NUM_RELATIONS))  # padded relations never show


def test_own_stream_is_deterministic_and_task_order_independent(native_ckpt_path):
    """With its own noise stream a fresh engine repeats itself, and a task's
    i-th draw does not depend on which other tasks ran before it."""
    a = InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    b = InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    pairs, trips = [(0, 1), (2, 3)], [(0, 1, 2), (3, 4, 5)]
    pred_a = a.predict_tails(pairs, top_k=5, return_scores=True)
    score_a = a.score_triplets(trips)
    score_b = b.score_triplets(trips)  # inverted order
    pred_b = b.predict_tails(pairs, top_k=5, return_scores=True)
    assert pred_a == pred_b and score_a == score_b
    assert a.predict_tails(pairs, top_k=5, return_scores=True) != pred_a  # next draw
    other = InferenceEngine(native_ckpt_path, device="cpu", seed=1)
    assert other.score_triplets(trips)["generator_scores"] != score_a["generator_scores"]


def test_results_are_json_ready_python_types(engine):
    res = engine.predict_tails([(0, 1)], top_k=3, return_scores=True)
    assert all(type(i) is int for i in res["predictions"][0])
    assert all(type(s) is float for s in res["scores"][0])
    sim = engine.find_similar_entities([2], top_k=3)["similar_entities"][0]
    assert all(type(i) is int for i in sim["similar_entities"])
    json.dumps([res, sim, engine.analyze_relations([0], [1], 2), engine.score_triplets([(0, 1, 2)])])


def test_cpu_engine_launches_no_kernel(engine):
    before = dict(rank_fused.launches)
    engine.predict_tails([(0, 1)], top_k=3)
    engine.predict_tails([(0, 1)], top_k=20)
    engine.find_similar_entities([1], top_k=3)
    assert rank_fused.launches == before


@pytest.mark.parametrize("mesh", [4, "auto", "2"])
def test_mesh_is_not_ported(native_ckpt_path, mesh):
    """Outside a launched world: a device count raises, naming how to launch
    one (no fallback to one device); "auto" is the world of one, the one
    device. tests/test_torch_parallel.py drives the mesh over four ranks."""
    if mesh == "auto":
        engine = InferenceEngine(native_ckpt_path, device="cpu", mesh=mesh)
        assert engine.mesh is None and engine.get_model_info()["device"] == "cpu:0"
    else:
        with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
            InferenceEngine(native_ckpt_path, device="cpu", mesh=mesh)


@pytest.mark.parametrize("mesh", [None, "", 1])
def test_one_device_mesh_values_are_accepted(native_ckpt_path, mesh):
    engine = InferenceEngine(native_ckpt_path, device="cpu", mesh=mesh)
    assert engine.get_model_info()["device"] == "cpu:0"


def test_auto_device_raises_without_a_card(native_ckpt_path):
    if torch.cuda.is_available():
        assert InferenceEngine(native_ckpt_path, device="auto").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            InferenceEngine(native_ckpt_path, device="auto")


# -- the bf16 rank stream (PROBGAN_BF16_RANK) -----------------------------------

def test_bf16_rank_gate_needs_the_switch_and_a_large_table(native_ckpt_path, monkeypatch):
    """No bf16 copy without the switch, and none below BF16_MIN_N entities
    even with it (the fixture has 50)."""
    monkeypatch.delenv("PROBGAN_BF16_RANK", raising=False)
    assert InferenceEngine(native_ckpt_path, device="cpu").entity_norm_bf16 is None
    monkeypatch.setenv("PROBGAN_BF16_RANK", "1")
    assert NUM_ENTITIES < rank_fused.BF16_MIN_N
    assert InferenceEngine(native_ckpt_path, device="cpu").entity_norm_bf16 is None


def test_bf16_rank_engine_serves_the_fp32_ids(tmp_path, monkeypatch):
    """At BF16_MIN_N entities the switch, read when the engine is built,
    caches a bf16 copy of the normalized table; predict_tails and
    find_similar_entities then go through rank_topk_fused(table_bf16=...) and
    return the fp32 engine's ids (scores to 2e-6); the fp32 engine's go
    through rank_topk_local(normalize=True), the same fp32 B4 launch. Above
    k = 16 the two-step path is taken as before."""
    from probgan_tpu_torch.core.checkpoint import save_checkpoint
    from probgan_tpu_torch.utils.demo_checkpoint import make_kg_checkpoint

    path = str(tmp_path / "big.msgpack")
    n = rank_fused.BF16_MIN_N
    save_checkpoint(path, make_kg_checkpoint(n, 5, embed_dim=16, noise_dim=8,
                                             hidden_dim=32, seed=3))
    monkeypatch.delenv("PROBGAN_BF16_RANK", raising=False)
    plain = InferenceEngine(path, device="cpu", seed=0)
    assert plain.entity_norm_bf16 is None
    monkeypatch.setenv("PROBGAN_BF16_RANK", "1")
    engine = InferenceEngine(path, device="cpu", seed=0)
    monkeypatch.delenv("PROBGAN_BF16_RANK")  # read at build time only
    bf16 = engine.entity_norm_bf16
    assert bf16 is not None and bf16.dtype == torch.bfloat16
    assert tuple(bf16.shape) == (n, 16)
    assert torch.equal(bf16, engine.entity_norm.to(torch.bfloat16))

    seen = []
    fused, local = rank_fused.rank_topk_fused, rank_fused.rank_topk_local
    monkeypatch.setattr(rank_fused, "rank_topk_fused", lambda *a, table_bf16=None: (
        seen.append(table_bf16), fused(*a, table_bf16=table_bf16))[1])
    monkeypatch.setattr(rank_fused, "rank_topk_local", lambda *a, normalize: (
        seen.append(None) if normalize else None, local(*a, normalize=normalize))[1])
    pairs = [(0, 1), (n - 1, 4), (12345, 0)]
    got = engine.predict_tails(pairs, top_k=10, return_scores=True)
    want = plain.predict_tails(pairs, top_k=10, return_scores=True)
    assert seen == [bf16, None]
    assert got["predictions"] == want["predictions"]
    np.testing.assert_allclose(got["scores"], want["scores"], atol=2e-6)
    got = engine.find_similar_entities([7, n - 2], top_k=5)
    want = plain.find_similar_entities([7, n - 2], top_k=5)
    assert seen[2] is bf16 and seen[3] is None
    for g, w in zip(got["similar_entities"], want["similar_entities"]):
        assert g["similar_entities"] == w["similar_entities"]
        np.testing.assert_allclose(g["similarity_scores"], w["similarity_scores"], atol=2e-6)
    engine.predict_tails(pairs[:1], top_k=20)  # k > 16: rank_scores + sort
    assert len(seen) == 4


# -- use_pallas / PROBGAN_PALLAS_RANK ---------------------------------------------

def _refuse_rank_fused(monkeypatch):
    """Make every entry of ops/rank_fused.py raise: the plain path must not
    reach one."""
    def refuse(*args, **kwargs):
        raise AssertionError("use_pallas=False reached ops/rank_fused.py")

    for name in ("rank_topk_fused", "rank_topk_local", "rank_scores_fused"):
        monkeypatch.setattr(rank_fused, name, refuse)


@pytest.mark.parametrize("switch", ["argument", "environment"])
def test_use_pallas_false_ranks_with_the_plain_ops(native_ckpt_path, monkeypatch, switch):
    """``use_pallas=False``, or ``PROBGAN_PALLAS_RANK=0`` with the default None,
    ranks through ops/rank.py and never reaches rank_fused; the results equal
    the JAX engine's built with use_pallas=False (tests/test_engine.py builds
    both kinds), top_k above and below the fused kernel's bound of 16."""
    monkeypatch.delenv("PROBGAN_PALLAS_RANK", raising=False)
    jax_engine = JaxEngine(native_ckpt_path, device="cpu", seed=0, use_pallas=False)
    if switch == "argument":
        port = InferenceEngine(native_ckpt_path, device="cpu", seed=0, use_pallas=False)
    else:
        monkeypatch.setenv("PROBGAN_PALLAS_RANK", "0")
        port = InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    _share_noise(monkeypatch, jax_engine, port)
    _refuse_rank_fused(monkeypatch)
    pairs = [(0, 1), (2, 3), (49, 6)]
    for top_k in (5, 20):
        want = jax_engine.predict_tails(pairs, top_k=top_k, return_scores=True)
        _assert_same(port.predict_tails(pairs, top_k=top_k, return_scores=True), want)
    _assert_same(port.find_similar_entities([4, 9], top_k=5),
                 jax_engine.find_similar_entities([4, 9], top_k=5))


def test_use_pallas_default_takes_the_kernels_and_gates_bf16(native_ckpt_path, monkeypatch):
    """None means the kernels unless PROBGAN_PALLAS_RANK=0 (on the CPU their
    wrappers take the plain twins), and the bf16 table copy exists only where
    the kernels do, as in the JAX engine."""
    monkeypatch.delenv("PROBGAN_PALLAS_RANK", raising=False)
    monkeypatch.setenv("PROBGAN_BF16_RANK", "1")
    monkeypatch.setattr(rank_fused, "BF16_MIN_N", NUM_ENTITIES)
    seen = []
    fused = rank_fused.rank_topk_fused
    monkeypatch.setattr(rank_fused, "rank_topk_fused", lambda *a, table_bf16=None: (
        seen.append(table_bf16), fused(*a, table_bf16=table_bf16))[1])
    engine = InferenceEngine(native_ckpt_path, device="cpu", seed=0)
    assert engine.entity_norm_bf16 is not None
    engine.predict_tails([(0, 1)], top_k=3)
    assert len(seen) == 1 and seen[0] is engine.entity_norm_bf16
    plain = InferenceEngine(native_ckpt_path, device="cpu", seed=0, use_pallas=False)
    assert plain.entity_norm_bf16 is None
    plain.predict_tails([(0, 1)], top_k=3)
    assert len(seen) == 1
    assert InferenceEngine(native_ckpt_path, device="cpu", seed=0,
                           use_pallas=True).entity_norm_bf16 is not None


@pytest.mark.parametrize("d,k", [(8, 20), (8, 3), (6, 20), (6, 3)])
def test_use_pallas_true_never_ranks_with_the_plain_ops(monkeypatch, d, k):
    """With the kernels on, the engine's rank functions reach the fused
    wrappers for every shape and never ops/rank.py's ``cosine_scores``: a
    feature dim the kernels do not take (6: not a multiple of 4) raises in the
    wrapper instead of giving way to the plain product, on any device."""
    def refuse(*args, **kwargs):
        raise AssertionError("use_pallas=True reached ops/rank.py's cosine_scores")

    monkeypatch.setattr(port_inference.rank_ops, "cosine_scores", refuse)
    rng = np.random.default_rng(0)
    pred = torch.from_numpy(rng.standard_normal((3, d)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((40, d)).astype(np.float32))
    table = table / table.norm(dim=1, keepdim=True)
    if d % 4:
        with pytest.raises(ValueError, match="D % 4 == 0"):
            port_inference._rank_topk(pred, table, k, 40, use_pallas=True)
        with pytest.raises(ValueError, match="D % 4 == 0"):
            port_inference._rank_scores(pred, table, 40, use_pallas=True)
        return
    values, ids = port_inference._rank_topk(pred, table, k, 40, use_pallas=True)
    want = rank_fused.rank_scores_fused_plain(pred, table)
    np.testing.assert_allclose(values.numpy(), np.sort(want.numpy(), axis=1)[:, ::-1][:, :k],
                               atol=1e-6)
    assert port_inference._rank_scores(pred, table, 40, use_pallas=True).shape == (3, 40)
