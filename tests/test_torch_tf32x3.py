"""The 3xTF32 grade of the port's B7 ``rank_scores`` and B2 ``packed_conv``
"none" kernels (csrc/tf32x3.cuh), emulated on the CPU, and the geometry their
wrappers hand to the kernels.

The kernels run only on the card; here their arithmetic is emulated: each
fp32 operand v split into hi = tf32(v) (to nearest, ties away from zero) and
lo = v - hi read truncated to TF32, each product taken as lo*hi + hi*lo +
hi*hi with fp32 sums. That must lie within the kernels' bounds of the exact
sum and of the JAX package's kernels (interpret mode, "highest"): 2e-6
absolute for cosine scores, 1e-5 of the largest entry for a conv. One TF32
product (hi*hi alone) must not.
"""

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
