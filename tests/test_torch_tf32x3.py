"""The 3xTF32 grade of the port's B7 ``rank_scores``, B4 ``rank_topk`` and B2
``packed_conv`` "none" kernels (csrc/tf32x3.cuh), emulated on the CPU, and
the geometry their wrappers hand to the kernels.

The kernels run only on the card; here their arithmetic is emulated: each
fp32 operand v split into hi = tf32(v) (to nearest, ties away from zero) and
lo = v - hi read truncated to TF32, each product taken as lo*hi + hi*lo +
hi*hi with fp32 sums. That must lie within the kernels' bounds of the exact
sum and of the JAX package's kernels (interpret mode, "highest"): 2e-6
absolute for cosine scores, 1e-5 of the largest entry for a conv. One TF32
product (hi*hi alone) must not.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu.ops import pallas_rank
from probgan_tpu_torch.ops import packed as tpk
from probgan_tpu_torch.ops import rank_fused
from tests.test_torch_packed import _nchw, _nhwc, _oihw, _phase_blocked, _rand
from tests.test_torch_rank import _pred, _t, _table

RANK_ATOL = 2e-6   # chip_smoke.py's bound for the rank kernels
CONV_REL = 1e-5    # of the output's largest entry, as WGRAD_REL for B6


def _tf32(v: torch.Tensor, truncate: bool = False) -> torch.Tensor:
    """fp32 -> TF32: to nearest, ties away from zero (split_tf32's hi), or
    with ``truncate`` the low 13 bits dropped (how the tensor cores read a
    low part). A test-only emulation."""
    bits = v.contiguous().view(torch.int32)
    return ((bits if truncate else bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(v)
    return hi, _tf32(v - hi, truncate=True)


@pytest.mark.parametrize("d", [128, 100])
def test_rank_scores_3xtf32_is_within_2e6(d):
    """Normalized queries against normalized rows: the three-term product
    within 2e-6 of the float64 scores and of the JAX kernel; hi*hi alone
    not. D = 100 is padded with zeros to 104 in the kernel, which adds
    nothing."""
    pred, table = _pred(80, 16, d), _table(81, 2048, d)
    pred[3] = 2.5 * table[77]  # a score of 1: the largest sums
    q = rank_fused.l2_normalize(_t(pred))
    t = _t(table)
    want = q.double() @ t.double().T
    k = rank_fused.scores_k(d)
    qp, tp = (torch.nn.functional.pad(a, (0, k - d)) for a in (q, t))
    (qh, ql), (th, tl) = _split(qp), _split(tp)
    three = ql @ th.T + qh @ tl.T + qh @ th.T
    one = qh @ th.T
    assert (three.double() - want).abs().max().item() <= RANK_ATOL
    assert (one.double() - want).abs().max().item() > RANK_ATOL
    jax_scores = pallas_rank.rank_scores_fused(jnp.asarray(pred), jnp.asarray(table),
                                               interpret=True)
    np.testing.assert_allclose(three.numpy(), np.asarray(jax_scores), atol=RANK_ATOL)
    assert abs(three[3, 77].item() - 1.0) <= RANK_ATOL


@pytest.mark.parametrize("cout", [8, 16])
def test_packed_conv_none_3xtf32_is_within_1e5_of_the_largest_entry(cout):
    """conv3x3 SAME + bias in the "none" epilogue from split operands: within
    1e-5 of the output's largest entry of the float64 conv and of the JAX
    kernel; one TF32 pass not."""
    b, c, h, w = 2, 16, 16, 32
    x, wgt, bias = _rand((b, h, w, c), 82), _rand((3, 3, c, cout), 83, 0.2), _rand((cout,), 84)
    xt, wt, bt = _nchw(x), _oihw(wgt), torch.from_numpy(bias)
    want = tpk.packed_conv_plain(xt.double(), wt.double(), bt.double(), "none")
    (xh, xl), (wh, wl) = _split(xt), _split(wt)
    zero = torch.zeros_like(bt)
    three = (tpk.packed_conv_plain(xl, wh, zero, "none") + tpk.packed_conv_plain(xh, wl, zero, "none")
             + tpk.packed_conv_plain(xh, wh, zero, "none")) + bt[:, None, None]
    one = tpk.packed_conv_plain(xh, wh, bt, "none")
    scale = want.abs().max().item()
    assert (three.double() - want).abs().max().item() <= CONV_REL * scale
    assert (one.double() - want).abs().max().item() > CONV_REL * scale
    jax_out = pk.packed_conv(_phase_blocked(x, 2), jnp.asarray(wgt), jnp.asarray(bias), 2,
                             mode="highest", epilogue="none", interpret=True)
    np.testing.assert_allclose(_nhwc(three), np.asarray(pk.packed_rgb_to_nhwc(jax_out, 2)),
                               rtol=0, atol=CONV_REL * scale)


def test_none_tiling_takes_the_kernels_slabs():
    """Cout % 64 == 0 takes 64-channel slabs of 8-row tiles, other multiples
    of 32 take 32-channel slabs of 16-row tiles: the slab of the weights'
    layout (convpool_kernel_weights) and the rows the wrapper's checks ask
    H to be a multiple of."""
    assert tpk.conv_tiling(32) == (32, 16)
    assert tpk.conv_tiling(64) == (64, 8)
    assert tpk.conv_tiling(128) == (64, 8)
    assert tpk.conv_tiling(96) == (32, 16)
    for cout in (32, 64, 96, 128):
        o_slab, rows = tpk.conv_tiling(cout)
        assert o_slab == tpk._pool_slab(cout) and rows == tpk._tile_rows(o_slab)


def _none_tile_origin(t, cout, h, wd):
    """(image, first row, first column, first output channel) of tile ``t``
    in the "none" kernel's walk (``none_tile`` in csrc/packed_conv.cu): the
    slab fastest, then columns, rows and images."""
    o_slab, rows = tpk.conv_tiling(cout)
    t, slab = divmod(t, cout // o_slab)
    t, tx = divmod(t, wd // 32)
    b, ty = divmod(t, h // rows)
    return b, ty * rows, tx * 32, slab * o_slab


@pytest.mark.parametrize("bsz,cout,h,wd", [(2, 32, 32, 64), (2, 64, 16, 96), (1, 128, 24, 32),
                                           (3, 96, 48, 32)])
def test_none_grid_covers_every_pixel_and_channel_once(bsz, cout, h, wd):
    """The tiles of the kernel's walk cover every (image, row, column, output
    channel) exactly once, and the persistent blocks' strides cover every
    tile once, with as many blocks as SMs or as tiles."""
    o_slab, rows = tpk.conv_tiling(cout)
    n_tiles = tpk.conv_tile_count(bsz, cout, h, wd)
    seen = np.zeros((bsz, cout, h, wd), np.int32)
    for t in range(n_tiles):
        b, y0, x0, o0 = _none_tile_origin(t, cout, h, wd)
        seen[b, o0:o0 + o_slab, y0:y0 + rows, x0:x0 + 32] += 1
    assert (seen == 1).all()
    for sms in (1, 5, 132, 10_000):
        blocks = tpk.persistent_blocks(n_tiles, sms)
        assert blocks == min(n_tiles, sms)
        walked = sorted(t for k in range(blocks) for t in range(k, n_tiles, blocks))
        assert walked == list(range(n_tiles))


def test_none_grid_at_the_train_steps_shapes():
    """The six (C, Cout, H) of the 1024² train step's "none" launches at
    batch 2: whole tiles, each tile's 32 x rows pixels in the image."""
    for cout, h in ((32, 1024), (64, 1024), (32, 1024), (64, 512), (128, 512), (64, 512)):
        o_slab, rows = tpk.conv_tiling(cout)
        assert h % rows == 0
        n = tpk.conv_tile_count(2, cout, h, h)
        assert n == 2 * (h // rows) * (h // 32) * (cout // o_slab)
        assert _none_tile_origin(n - 1, cout, h, h) == (1, h - rows, h - 32, cout - o_slab)


@pytest.mark.parametrize("n", [1, 129, 1_000_003])
@pytest.mark.parametrize("d", [4, 100, 128, 132, 256])
@pytest.mark.parametrize("b", [8, 33])
def test_rank_scores_tiles_cover_every_row(n, d, b):
    """rank_scores' tilings: 128-row tiles (3 stages, one block an SM) for
    B > 32 up to a padded D of 128, else 64-row tiles (2 stages, two blocks
    an SM up to a padded D of 128, one above); contiguous runs that cover
    every row with no block empty, on 132 SMs; the shared memory of a block
    fits the blocks an SM. D % 4 pads to a multiple of 8."""
    k = rank_fused.scores_k(d)
    assert k % 8 == 0 and d <= k < d + 8
    tile_rows, per_sm = rank_fused.scores_tiling(b, d)
    assert (tile_rows, per_sm) == ((128, 1) if k <= 128 and b > 32
                                   else (64, 2) if k <= 128 else (64, 1))
    per_block, blocks = rank_fused.tile_runs(n, tile_rows, per_sm * 132)
    assert 1 <= blocks <= per_sm * 132
    assert blocks * per_block * tile_rows >= n > (blocks - 1) * per_block * tile_rows
    # shared memory (csrc/rank_scores.cu): the padded queries and the stages,
    # each the tile's 8 bulk copies or its staged scores, beside the stages'
    # mbarriers and the 1 KB the card reserves a block
    stages = 3 if tile_rows == 128 else 2
    stage = max(tile_rows * d + 32, 64 * (tile_rows + 20))
    block = 4 * (64 * (k + 4) + stages * stage) + 8 * stages
    assert block <= 232_448 and per_sm * (block + 1024) <= 233_472


# ---------------------------------------------------------------------------
# rank_topk (B4): B7's product, then a top-k per block and a stable merge
# ---------------------------------------------------------------------------

def _scores_3xtf32(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Emulated 3xTF32 cosine scores of normalized queries [B, D] against
    table rows [N, D], each summed row by row in one order (an elementwise
    product and a sum over D), so bit-equal rows get bit-equal scores, as
    on the card."""
    k = rank_fused.scores_k(q.shape[1])
    qp, tp = (torch.nn.functional.pad(a, (0, k - a.shape[1])) for a in (q, t))
    (qh, ql), (th, tl) = _split(qp), _split(tp)

    def dot(a, b):
        return (a[:, None, :] * b[None, :, :]).sum(-1)

    return dot(ql, th) + dot(qh, tl) + dot(qh, th)


def _topk_by_blocks(scores: torch.Tensor, k: int, nvalid: int, tile_rows: int,
                    blocks: int) -> tuple[torch.Tensor, torch.Tensor]:
    """rank_topk's selection as csrc/rank_topk.cu makes it: each block's top
    k of its contiguous run of tiles below nvalid (descending value,
    ascending id, padded with (-inf, INT32_MAX)), laid out [B, n_blocks * k]
    in block order, then the wrapper's merge."""
    per_block, n_blocks = rank_fused.tile_runs(nvalid, tile_rows, blocks)
    run = per_block * tile_rows
    cand_v, cand_i = [], []
    for blk in range(n_blocks):
        lo, hi = blk * run, min((blk + 1) * run, nvalid)
        kk = min(k, hi - lo)
        v, i = rank_fused.top_k_lowest_index(scores[:, lo:hi], kk)
        cand_v.append(torch.nn.functional.pad(v, (0, k - kk), value=float("-inf")))
        cand_i.append(torch.nn.functional.pad((i + lo).to(torch.int32), (0, k - kk),
                                              value=2**31 - 1))
    return rank_fused.merge_candidates(torch.cat(cand_v, 1), torch.cat(cand_i, 1), k)


def _dup_table():
    """4096 rows, with row 5 repeated at 2047, 2048 and 3000 (across the
    Pallas kernel's 2048-row tiles and the port's 64- and 128-row tiles)."""
    raw = np.random.default_rng(12).standard_normal((4096, 128)).astype(np.float32)
    for dup in (2047, 2048, 3000):
        raw[dup] = raw[5]
    return (raw / np.maximum(np.linalg.norm(raw, axis=1, keepdims=True), 1e-12)
            ).astype(np.float32), raw


def _masked_case():
    """Zero padding rows past nvalid = 4000 score exactly 0 and would beat
    every negative cosine."""
    table = _table(13, 4096, 128, n_valid=4000)
    pred = np.tile(-table[:4000].mean(axis=0, keepdims=True) * 50.0, (8, 1))
    return pred.astype(np.float32), table, 4000


@pytest.mark.parametrize("case,k", [("planted", 1), ("planted", 10), ("planted", 16),
                                    ("duplicates", 6), ("masked", 10), ("local", 10)])
def test_rank_topk_blocks_of_3xtf32_scores_match_pallas(case, k):
    """The emulated 3xTF32 scores through a per-block top-k over the
    wrapper's tile runs (its tiling at this batch on 132 SMs, and the same
    runs on 3 SMs, many tiles a block) and the stable merge: the ids of
    JAX's rank_topk_fused (and rank_topk_local) in interpret mode, values
    within 2e-6; duplicate rows in ascending id."""
    if case == "planted":
        pred, table, nvalid = _pred(10, 33, 128), _table(11, 4096, 128, n_valid=4000), 4000
    elif case == "duplicates":
        table, raw = _dup_table()
        pred, nvalid = np.tile(raw[5:6], (8, 1)), 4096
    elif case == "masked":
        pred, table, nvalid = _masked_case()
    else:
        pred, table, nvalid = _pred(14, 16, 128), _table(15, 4096, 128), 3000
    q = rank_fused.l2_normalize(_t(pred))
    if case == "local":
        want_v, want_i = pallas_rank.rank_topk_local(jnp.asarray(q.numpy()), jnp.asarray(table),
                                                     k, nvalid, interpret=True)
    else:
        want_v, want_i = pallas_rank.rank_topk_fused(jnp.asarray(pred), jnp.asarray(table), k,
                                                     nvalid, interpret=True)
    scores = _scores_3xtf32(q, _t(table))
    tile_rows, per_sm = rank_fused.scores_tiling(*pred.shape)
    for sms in (132, 3):
        v, i = _topk_by_blocks(scores, k, nvalid, tile_rows, per_sm * sms)
        assert i.dtype == torch.int64
        np.testing.assert_array_equal(i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(v.numpy(), np.asarray(want_v), atol=RANK_ATOL)
        if case == "duplicates":
            assert i[0, :4].tolist() == [5, 2047, 2048, 3000]
        if case == "masked":
            assert int(i.max()) < nvalid


@pytest.mark.parametrize("n", [1, 129, 1_000_003])
@pytest.mark.parametrize("b", [8, 33])
def test_rank_topk_tiles_cover_every_row_below_nvalid_once(n, b):
    """rank_topk's tiling (rank_scores') at D = 128 and its contiguous runs
    on 132 SMs, at nvalid = n and below it: every row below nvalid in exactly
    one block's run, no block empty, none past the blocks the SMs hold; the
    block's shared memory (rank_ring.cuh: queries and stages, each the tile's
    copies or its staged scores) fits the blocks an SM."""
    tile_rows, per_sm = rank_fused.scores_tiling(b, 128)
    for nvalid in sorted({n, max(1, n - 100)}):
        per_block, blocks = rank_fused.tile_runs(nvalid, tile_rows, per_sm * 132)
        run = per_block * tile_rows
        assert 1 <= blocks <= per_sm * 132
        starts = np.arange(blocks) * run
        ends = np.minimum(starts + run, nvalid)
        assert starts[0] == 0 and ends[-1] == nvalid and (ends > starts).all()
        assert (starts[1:] == ends[:-1]).all()
    stages = 3 if tile_rows == 128 else 2
    block = 4 * (64 * (128 + 4) + stages * max(tile_rows * 128 + 32, 64 * (tile_rows + 20)))
    assert block + 8 * stages <= 232_448 and per_sm * (block + 8 * stages + 1024) <= 233_472


def test_rank_argtypes_match_the_c_entry_points():
    """Each rank wrapper's ctypes argument list has as many entries as its
    kernel's extern "C" function (the stream last)."""
    csrc = Path(rank_fused.__file__).resolve().parent.parent / "csrc"
    for name, argtypes in rank_fused._ARGTYPES.items():
        m = re.search(rf'extern "C" int probgan_{name}\(([^)]*)\)',
                      (csrc / f"{name}.cu").read_text())
        assert m is not None, name
        assert len(m.group(1).split(",")) == len(argtypes), name
