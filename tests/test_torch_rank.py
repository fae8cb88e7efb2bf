"""The port's rank ops and the plain twins of its fused rank kernels against
the JAX package, on the CPU (the Pallas kernels run in interpret mode).

Inputs come from numpy seeds and go to both packages. Ids must be equal;
values agree to atol 2e-6 (fp32 dots summed in another order, the JAX
tests' own tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.ops import pallas_rank
from probgan_tpu.ops import rank as jax_rank
from probgan_tpu_torch.engine import inference as port_inference
from probgan_tpu_torch.ops import rank, rank_fused

ATOL = 2e-6


def _table(seed, n, d, n_valid=None):
    """A normalized [n, d] table (rows at or past n_valid zeroed) and its raw
    form, as numpy."""
    raw = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    norm = raw / np.maximum(np.linalg.norm(raw, axis=1, keepdims=True), 1e-12)
    if n_valid is not None:
        norm[n_valid:] = 0.0
    return norm.astype(np.float32)


def _pred(seed, b, d):
    return np.random.default_rng(seed).standard_normal((b, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_l2_normalize_matches_jax_and_keeps_zero_rows():
    x = _pred(0, 6, 16) * 3.0
    x[2] = 0.0
    got = rank.l2_normalize(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_rank.l2_normalize(jnp.asarray(x))),
                               atol=1e-6)
    assert np.all(got[2] == 0.0)


def test_cosine_similarity_matches_jax_with_clamped_norms():
    a, b = _pred(1, 5, 16), _pred(2, 5, 16)
    a[0] = 0.0  # both norms are clamped at 1e-8: a zero row gives 0, not NaN
    got = rank.cosine_similarity(_t(a), _t(b)).numpy()
    want = np.asarray(jax_rank.cosine_similarity(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] == 0.0


def test_rank_topk_matches_jax():
    q = rank.l2_normalize(_t(_pred(3, 4, 16)))
    table = _table(4, 50, 16)
    v, i = rank.rank_topk(q, _t(table), 5)
    wv, wi = jax_rank.rank_topk(jnp.asarray(q.numpy()), jnp.asarray(table), 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=ATOL)


def test_top_k_lowest_index_breaks_ties_like_lax_top_k():
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf],
                       [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    v, i = rank.top_k_lowest_index(_t(scores), 4)
    wv, wi = jax.lax.top_k(jnp.asarray(scores), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
    with pytest.raises(ValueError):
        rank.top_k_lowest_index(_t(scores), 7)


@pytest.mark.parametrize("k", [1, 10, 16])
def test_rank_topk_fused_matches_pallas(k):
    """N = 4000 real rows zero-padded to 4096: two Pallas tiles."""
    pred, table = _pred(10, 16, 128), _table(11, 4096, 128, n_valid=4000)
    wv, wi = pallas_rank.rank_topk_fused(jnp.asarray(pred), jnp.asarray(table), k, 4000,
                                         interpret=True)
    for fn in (rank_fused.rank_topk_fused, rank_fused.rank_topk_fused_plain):
        v, i = fn(_t(pred), _t(table), k, 4000)
        assert v.dtype == torch.float32 and i.dtype == torch.int64
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=ATOL)


def test_rank_topk_fused_tie_break_across_tile_boundary():
    """Duplicate table rows give bit-equal scores; ties go to the lowest
    entity id, across the Pallas kernel's 2048-row tile boundary too."""
    raw = np.random.default_rng(12).standard_normal((4096, 128)).astype(np.float32)
    for dup in (2047, 2048, 3000):
        raw[dup] = raw[5]
    table = (raw / np.maximum(np.linalg.norm(raw, axis=1, keepdims=True), 1e-12)
             ).astype(np.float32)
    pred = np.tile(raw[5:6], (8, 1))
    wv, wi = pallas_rank.rank_topk_fused(jnp.asarray(pred), jnp.asarray(table), 6, 4096,
                                         interpret=True)
    v, i = rank_fused.rank_topk_fused(_t(pred), _t(table), 6, 4096)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    assert i[0, :4].tolist() == [5, 2047, 2048, 3000]


def test_rank_topk_nvalid_masks_zero_rows_under_negative_scores():
    """A zero padding row scores exactly 0 and would beat every negative
    cosine: rows at or past nvalid must never win."""
    table = _table(13, 4096, 128, n_valid=4000)
    pred = np.tile(-table[:4000].mean(axis=0, keepdims=True) * 50.0, (8, 1))
    pred = pred.astype(np.float32)
    wv, wi = pallas_rank.rank_topk_fused(jnp.asarray(pred), jnp.asarray(table), 10, 4000,
                                         interpret=True)
    v, i = rank_fused.rank_topk_fused(_t(pred), _t(table), 10, 4000)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=ATOL)
    assert int(i.max()) < 4000


def test_rank_topk_local_matches_pallas():
    """Pre-normalized queries, local ids, nvalid below the shard's rows."""
    pred = rank.l2_normalize(_t(_pred(14, 8, 128))).numpy()
    shard = _table(15, 2048, 128, n_valid=1500)
    wv, wi = pallas_rank.rank_topk_local(jnp.asarray(pred), jnp.asarray(shard), 7, 1500,
                                         interpret=True)
    for fn in (rank_fused.rank_topk_local, rank_fused.rank_topk_local_plain):
        v, i = fn(_t(pred), _t(shard), 7, 1500)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=ATOL)


def test_rank_scores_fused_matches_pallas():
    pred, table = _pred(16, 16, 128), _table(17, 2048, 128)
    want = pallas_rank.rank_scores_fused(jnp.asarray(pred), jnp.asarray(table),
                                         interpret=True)
    for fn in (rank_fused.rank_scores_fused, rank_fused.rank_scores_fused_plain):
        got = fn(_t(pred), _t(table))
        assert tuple(got.shape) == (16, 2048)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rank_scores_fused_zero_query_row_gives_zeros():
    pred = np.zeros((8, 128), np.float32)
    got = rank_fused.rank_scores_fused(_t(pred), _t(_table(18, 512, 128)))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-6)


def test_engine_rank_topk_above_16_takes_the_two_step_path():
    """k = 17 is off the fused kernel's gate: the engine scores then ranks,
    and matches the JAX package's own off-gate path."""
    pred, table = _pred(19, 8, 128), _table(20, 4096, 128, n_valid=4000)
    assert rank_fused.supports_topk((8, 128), 4096, 16)
    assert not rank_fused.supports_topk((8, 128), 4096, 17)
    before = dict(rank_fused.launches)
    v, i = port_inference._rank_topk(_t(pred), _t(table), 17, 4000)
    assert rank_fused.launches == before  # CPU: plain twins, no kernel launches
    wv, wi = pallas_rank.rank_topk_fused(jnp.asarray(pred), jnp.asarray(table), 17, 4000)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=ATOL)


def test_supports_gates():
    assert rank_fused.supports((1, 4), 1)
    assert rank_fused.supports((1000, 128), 1_000_003)  # no tiling gates
    assert not rank_fused.supports((8, 50), 100)        # D % 4
    assert not rank_fused.supports((8, 512), 100)       # D above MAX_D
    assert not rank_fused.supports((8, 128), 0)
    assert not rank_fused.supports_topk((8, 128), 100, 0)


@pytest.mark.parametrize("case", ["dtype", "non_contiguous", "d_mod_4", "k_17",
                                  "k_above_nvalid", "nvalid_above_rows", "dims_differ"])
def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    pred, table = _t(_pred(21, 8, 128)), _t(_table(22, 256, 128))
    k, nvalid = 5, 256
    if case == "dtype":
        pred = pred.double()
    elif case == "non_contiguous":
        table = _t(_table(22, 128, 256)).T
    elif case == "d_mod_4":
        pred, table = _t(_pred(21, 8, 50)), _t(_table(22, 256, 50))
    elif case == "k_17":
        k = 17
    elif case == "k_above_nvalid":
        nvalid = 3
    elif case == "nvalid_above_rows":
        nvalid = 257
    elif case == "dims_differ":
        pred = _t(_pred(21, 8, 64))
    with pytest.raises(ValueError):
        rank_fused.rank_topk_fused(pred, table, k, nvalid)
    if case not in ("k_17", "k_above_nvalid", "nvalid_above_rows"):
        with pytest.raises(ValueError):
            rank_fused.rank_scores_fused(pred, table)
        with pytest.raises(ValueError):
            rank_fused.rank_topk_local(pred, table, k, nvalid)


# -- the bf16 table stream ------------------------------------------------------

def _bf16_both(table):
    """The same bf16 copy of a normalized table for JAX and for the port
    (both round to nearest even: the bits are equal)."""
    jax_bf16 = jnp.asarray(table).astype(jnp.bfloat16)
    port_bf16 = _t(table).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jax_bf16).view(np.uint16),
                                  port_bf16.view(torch.int16).numpy().view(np.uint16))
    return jax_bf16, port_bf16


def _planted_table():
    """The case of tests/test_pallas_kernels.py: each query's top-10 rows
    planted at scattered ids with distinct cosines 0.98, 0.95, ..."""
    rng = np.random.RandomState(21)
    n, n_pad, d, b, k = 4000, 4096, 128, 16, 10
    base = rng.standard_normal((n_pad, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    spots = rng.choice(n, size=(b, k), replace=False)
    for bi in range(b):
        qn = q[bi] / np.linalg.norm(q[bi])
        for pos, ent in enumerate(spots[bi]):
            r = base[ent] - np.dot(base[ent], qn) * qn
            r /= np.linalg.norm(r)
            c = 0.98 - 0.03 * pos
            base[ent] = c * qn + np.sqrt(1.0 - c * c) * r
    table = base / np.maximum(np.linalg.norm(base, axis=1, keepdims=True), 1e-12)
    table[n:] = 0.0
    return q, table.astype(np.float32), n, k, spots


def _bf16_case(name):
    if name == "planted":
        pred, table, n, k, _ = _planted_table()
        return pred, table, n, k
    if name == "duplicates":  # bit-equal rows across the JAX kernel's tile boundary
        base = np.random.default_rng(22).standard_normal((4096, 128)).astype(np.float32)
        for dup in (2047, 2048, 3000):
            base[dup] = base[5]
        table = base / np.maximum(np.linalg.norm(base, axis=1, keepdims=True), 1e-12)
        return np.tile(base[5:6], (8, 1)), table.astype(np.float32), 4096, 6
    # "masked": nvalid barely over one JAX tile, zero rows past it
    table = _table(23, 4096, 128, n_valid=2050)
    return _pred(24, 8, 128), table, 2050, 10


@pytest.mark.parametrize("case", ["planted", "duplicates", "masked"])
def test_rank_topk_fused_bf16_matches_pallas(case):
    """rank_topk_fused(table_bf16=...) against the JAX function in interpret
    mode and against both packages' fp32 paths: ids equal, values to 2e-6;
    exact duplicates in ascending id; rows at or past nvalid never returned."""
    pred, table, n, k = _bf16_case(case)
    jax_bf16, port_bf16 = _bf16_both(table)
    wv, wi = pallas_rank.rank_topk_fused(jnp.asarray(pred), jnp.asarray(table), k, n,
                                         table_bf16=jax_bf16, interpret=True)
    before = dict(rank_fused.launches)
    v, i = rank_fused.rank_topk_fused(_t(pred), _t(table), k, n, table_bf16=port_bf16)
    assert rank_fused.launches == before  # CPU tensors take the plain twin
    assert v.dtype == torch.float32 and i.dtype == torch.int64 and tuple(i.shape) == (len(pred), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    np.testing.assert_allclose(v.numpy(), np.asarray(wv), atol=ATOL)
    fv, fi = rank_fused.rank_topk_fused(_t(pred), _t(table), k, n)
    np.testing.assert_array_equal(i.numpy(), fi.numpy())
    np.testing.assert_allclose(v.numpy(), fv.numpy(), atol=ATOL)
    assert int(i.max()) < n
    for row in i.numpy():
        assert len(set(row.tolist())) == k
    if case == "duplicates":
        assert i[0, :4].tolist() == [5, 2047, 2048, 3000]


def test_rank_topk_bf16_rescore_orders_what_bf16_cannot():
    """Rows whose cosines differ by 1e-4, far below bf16's 2**-8 steps, tie
    or cross in the approximate score; the pool of k + 16 holds them all and
    the fp32 rescore orders them. A pool of only k would lose true members."""
    rng = np.random.default_rng(30)
    d, n, k = 128, 3000, 10
    table = _table(31, n, d)
    q = rng.standard_normal(d).astype(np.float32)
    qn = q / np.linalg.norm(q)
    spots = rng.choice(n, size=20, replace=False)
    for pos, ent in enumerate(spots):
        r = table[ent] - np.dot(table[ent], qn) * qn
        r /= np.linalg.norm(r)
        c = 0.9 + 1e-4 * pos
        table[ent] = (c * qn + np.sqrt(1.0 - c * c) * r).astype(np.float32)
    table = (table / np.linalg.norm(table, axis=1, keepdims=True)).astype(np.float32)
    pred = np.tile(q, (8, 1))
    tb = _t(table).to(torch.bfloat16)
    v, i = rank_fused.rank_topk_fused(_t(pred), _t(table), k, n, table_bf16=tb)
    fv, fi = rank_fused.rank_topk_fused(_t(pred), _t(table), k, n)
    np.testing.assert_array_equal(i.numpy(), fi.numpy())
    assert i[0].tolist() == spots[::-1][:k].tolist()
    np.testing.assert_allclose(v.numpy(), fv.numpy(), atol=ATOL)
    # the approximate order alone is another one
    approx = rank.cosine_scores(rank.l2_normalize(_t(pred)).to(torch.bfloat16).float(),
                                tb.float())
    assert rank.top_k_lowest_index(approx, k)[1][0].tolist() != i[0].tolist()


def test_rank_topk_bf16_small_tables_and_gates():
    table = _table(40, 20, 32)
    pred = _pred(41, 3, 32)
    tb = _t(table).to(torch.bfloat16)
    # pool m = min(k + 16, nvalid) = nvalid: everything is rescored
    v, i = rank_fused.rank_topk_fused(_t(pred), _t(table), 5, 12, table_bf16=tb)
    fv, fi = rank_fused.rank_topk_fused(_t(pred), _t(table), 5, 12)
    np.testing.assert_array_equal(i.numpy(), fi.numpy())
    np.testing.assert_allclose(v.numpy(), fv.numpy(), atol=ATOL)
    assert rank_fused.BF16_MIN_N == pallas_rank.BF16_MIN_N == 200_000
    assert rank_fused.BF16_RESCORE_POOL == pallas_rank._BF16_RESCORE_POOL
    assert rank_fused.supports_topk_bf16((8, 128), 1000, 10)
    assert not rank_fused.supports_topk_bf16((8, 24), 1000, 10)   # D % 16
    assert not rank_fused.supports_topk_bf16((8, 128), 1000, 17)  # k > 16
    with pytest.raises(ValueError, match="bfloat16"):
        rank_fused.rank_topk_fused(_t(pred), _t(table), 5, 12, table_bf16=_t(table))
    with pytest.raises(ValueError, match="mirror"):
        rank_fused.rank_topk_fused(_t(pred), _t(table), 5, 12, table_bf16=tb[:10])
    t24 = _table(42, 20, 24)
    with pytest.raises(ValueError, match="D % 16"):
        rank_fused.rank_topk_fused(_t(_pred(43, 3, 24)), _t(t24), 5, 12,
                                   table_bf16=_t(t24).to(torch.bfloat16))


# -- the merge and rescore of the bf16 stream's pools ---------------------------

_FILL_ID = np.iinfo(np.int32).max


def _merge(cand_v, cand_i, pred, table, k, m):
    """merge_rescore_bf16 on CPU tensors: its plain twin, no launch."""
    before = dict(rank_fused.launches)
    args = (_t(np.asarray(cand_v, np.float32)), _t(np.asarray(cand_i, np.int32)), _t(pred),
            _t(table), k, m)
    v, i = rank_fused.merge_rescore_bf16(*args)
    assert rank_fused.launches == before
    pv, pi = rank_fused.merge_rescore_bf16_plain(*args)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    assert v.dtype == torch.float32 and i.dtype == torch.int64 and tuple(i.shape) == (len(pred), k)
    return v.numpy(), i.numpy()


def test_merge_rescore_plain_takes_equal_approximate_scores_by_position():
    """Three blocks' pools of m = 2 with one approximate score everywhere:
    the pool is the first m candidates by position (blocks in ascending row
    order, so the lowest ids), even where a later row scores higher exactly."""
    table = _table(50, 40, 16)
    pred = table[[30]] * 2.0  # row 30 scores 1.0 exactly, the others less
    cand_v = [[0.5, 0.5, 0.5, 0.5, 0.5, 0.5]]
    cand_i = [[2, 9, 11, 17, 30, 33]]  # rows of blocks [0, 10), [10, 20), [20, 40)
    v, i = _merge(cand_v, cand_i, pred, table, 2, 2)
    exact = table[[2, 9]] @ table[30]
    assert set(i[0].tolist()) == {2, 9} and 30 not in i[0]
    np.testing.assert_allclose(v[0], np.sort(exact)[::-1], atol=ATOL)


def test_merge_rescore_plain_keeps_fillers_at_minus_inf():
    """Pools padded with (-inf, INT32_MAX) where a block held fewer valid rows
    (nvalid below the table's rows): a filler slot that reaches the top k
    comes out as (-inf, 0), after every real row, and no row at or past
    nvalid appears."""
    nvalid, table = 5, _table(51, 12, 16, n_valid=5)  # rows 5.. are padding
    pred = _pred(52, 2, 16)
    ninf = -np.inf
    cand_v = [[0.9, 0.1, ninf, 0.3, ninf, ninf], [0.2, ninf, 0.4, 0.3, ninf, ninf]]
    cand_i = [[0, 4, _FILL_ID, 2, _FILL_ID, _FILL_ID], [3, _FILL_ID, 1, 0, _FILL_ID, _FILL_ID]]
    v, i = _merge(cand_v, cand_i, pred, table, 4, 6)
    pn = pred / np.linalg.norm(pred, axis=1, keepdims=True)
    for q, real in ((0, [0, 4, 2]), (1, [3, 1, 0])):
        exact = table[real] @ pn[q]
        order = np.argsort(-exact, kind="stable")
        assert i[q, :3].tolist() == [real[j] for j in order]
        np.testing.assert_allclose(v[q, :3], exact[order], atol=ATOL)
        assert i[q, 3] == 0 and v[q, 3] == -np.inf
    assert int(i.max()) < nvalid


def test_merge_rescore_plain_resolves_exact_duplicates_to_the_lowest_id():
    """Rows 3, 7 and 12 are bit-equal, so their exact scores tie; whatever
    their order in the pools, they come out as 3, 7, 12."""
    table = _table(53, 16, 16)
    table[[7, 12]] = table[3]
    pred = table[[3]] * 5.0
    cand_v = [[0.99, 0.7, 0.99, 0.2, 0.98, 0.1]]
    cand_i = [[12, 1, 7, 0, 3, 2]]
    v, i = _merge(cand_v, cand_i, pred, table, 4, 6)
    assert i[0, :3].tolist() == [3, 7, 12]
    assert v[0, 0] == v[0, 1] == v[0, 2]


def _stream_pools(pred, table_bf16, m, nvalid, rows_per_block):
    """What the stream kernel writes, by its contract: per block of
    ``rows_per_block`` rows below nvalid, the best m by approximate score
    (ties by ascending id), padded with (-inf, INT32_MAX)."""
    approx = rank.cosine_scores(rank.l2_normalize(_t(pred)).to(torch.bfloat16).float(),
                                table_bf16[:nvalid].float())
    vs, ids = [], []
    for r0 in range(0, nvalid, rows_per_block):
        block = approx[:, r0:r0 + rows_per_block]
        n = min(m, block.shape[1])
        v, i = rank.top_k_lowest_index(block, n)
        pad = m - n
        vs.append(torch.cat([v, torch.full((len(pred), pad), float("-inf"))], 1))
        ids.append(torch.cat([(i + r0).to(torch.int32),
                              torch.full((len(pred), pad), _FILL_ID, dtype=torch.int32)], 1))
    return torch.cat(vs, 1).numpy(), torch.cat(ids, 1).numpy()


@pytest.mark.parametrize("rows_per_block", [128, 1920])
@pytest.mark.parametrize("case", ["planted", "duplicates", "masked"])
def test_bf16_pools_by_block_then_merge_match_pallas(case, rows_per_block):
    """The two kernels' split of the bf16 path: pools per block of rows, then
    the merge and rescore of all of them, give JAX's
    rank_topk_fused(table_bf16=...) in interpret mode (ids equal, values to
    2e-6), for blocks of one 128-row tile and of fifteen."""
    pred, table, n, k = _bf16_case(case)
    jax_bf16, port_bf16 = _bf16_both(table)
    wv, wi = pallas_rank.rank_topk_fused(jnp.asarray(pred), jnp.asarray(table), k, n,
                                         table_bf16=jax_bf16, interpret=True)
    m = min(k + rank_fused.BF16_RESCORE_POOL, n)
    cand_v, cand_i = _stream_pools(pred, port_bf16, m, n, rows_per_block)
    v, i = _merge(cand_v, cand_i, pred, table, k, m)
    np.testing.assert_array_equal(i, np.asarray(wi))
    np.testing.assert_allclose(v, np.asarray(wv), atol=ATOL)
