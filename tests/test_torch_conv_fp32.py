"""The schedule and shared memory of the pipelined fp32 main loop that
packed_conv's "lrelu" / "lrelu_norm" epilogues, packed_conv_rgb and
packed_upconv run on the card (csrc/conv_ring.cuh), and the call that
convpool_lrelu's backward makes for its mask.

The kernels run only on the card; what their wrappers hand them is plain
Python: the tiling, the tile walk of the persistent blocks and the ring's
shared-memory bytes (checked against the kernel's own constant at launch).
Here the walk must cover every output pixel and channel exactly once, and
the ring must fit the blocks an SM the source note states.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from probgan_tpu_torch.ops import packed as tpk
from probgan_tpu_torch.ops import packed_vjp

CSRC = Path(tpk.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132

# (batch, C, Cout, H): packed_conv's fp32 launches on the paths at 1024²
CONV_SHAPES = {
    "train step lrelu": [(2, 32, 32, 1024), (2, 64, 64, 512)],
    "train step recompute": [(2, 32, 64, 1024), (2, 64, 128, 512)],
    "train step lrelu_norm": [(2, 64, 64, 512)],
    "generate lrelu_norm": [(8, 64, 64, 512)],
    "score lrelu": [(8, 32, 32, 1024), (8, 64, 64, 512)],
}
# (batch, C, Cout, H): packed_conv_rgb's, the final stage of a generator that
# ends at 1024² (stage 8) or 512² (stage 7), in generate and at the kernels'
# test batch
CONV_RGB_SHAPES = [(8, 32, 32, 1024), (8, 64, 64, 512), (2, 32, 32, 1024), (2, 64, 64, 512)]
# (batch, C, Cout, input H): packed_upconv's, stages 7 and 8
UPCONV_SHAPES = {
    "train step": [(2, 128, 64, 256), (2, 64, 32, 512)],
    "generate": [(8, 128, 64, 256), (8, 64, 32, 512)],
}


def _walk_covers_tiles_once(n_tiles: int) -> None:
    """The persistent blocks' strides visit every tile once."""
    for sms in (1, 7, H100_SMS):
        blocks = tpk.persistent_blocks(n_tiles, sms)
        assert blocks == min(n_tiles, tpk.RING_BLOCKS_PER_SM * sms)
        visits = np.zeros(n_tiles, np.int64)
        for k in range(blocks):
            visits[k::blocks] += 1
        assert (visits == 1).all()


def _conv_origins(bsz, cout, h, wd):
    n = tpk.conv_tile_count(bsz, cout, h, wd)
    return n, [tpk.conv_tile_origin(t, cout, h, wd) for t in range(n)]


def _upconv_origins(bsz, cout, h, wd):
    n = tpk.upconv_tile_count(bsz, cout, h, wd)
    return n, [tpk.upconv_tile_origin(t, cout, h, wd) for t in range(n)]


@pytest.mark.parametrize("bsz,cout,h,wd", [(1, 32, 16, 32), (3, 96, 48, 64), (2, 128, 24, 96),
                                           (1, 64, 8, 32)])
def test_conv_walk_covers_every_output_once_ragged(bsz, cout, h, wd):
    """Small shapes, Cout 96 in three 32-channel slabs, tile counts that no
    block count divides: every (image, channel, row, column) once."""
    o_slab, rows = tpk.conv_tiling(cout)
    n, origins = _conv_origins(bsz, cout, h, wd)
    seen = np.zeros((bsz, cout, h, wd), np.int32)
    for b, y0, x0, o0 in origins:
        seen[b, o0:o0 + o_slab, y0:y0 + rows, x0:x0 + 32] += 1
    assert (seen == 1).all()
    _walk_covers_tiles_once(n)


@pytest.mark.parametrize("path", sorted(CONV_SHAPES))
def test_conv_walk_covers_the_paths_shapes(path):
    """At the shapes of the train step, generate and score: distinct tiles
    on the tile grid, inside the output, as many as the grid has, so they
    cover each output once; and the blocks' walk covers each tile once."""
    for bsz, _, cout, h in CONV_SHAPES[path]:
        o_slab, rows = tpk.conv_tiling(cout)
        assert h % rows == 0 and cout % o_slab == 0
        n, origins = _conv_origins(bsz, cout, h, h)
        assert n == bsz * (h // rows) * (h // 32) * (cout // o_slab)
        assert len(set(origins)) == n
        for b, y0, x0, o0 in origins:
            assert 0 <= b < bsz and y0 % rows == 0 and x0 % 32 == 0 and o0 % o_slab == 0
            assert y0 + rows <= h and x0 + 32 <= h and o0 + o_slab <= cout
        # the slab fastest: tiles that read one patch run side by side
        assert [o[3] for o in origins[:cout // o_slab]] == list(range(0, cout, o_slab))
        _walk_covers_tiles_once(n)


@pytest.mark.parametrize("bsz,cout,h,wd", [*((b, co, h, h) for b, _, co, h in CONV_RGB_SHAPES),
                                           (1, 32, 48, 96), (3, 64, 24, 64), (2, 32, 16, 32)])
def test_conv_rgb_walk_writes_every_pixel_once(bsz, cout, h, wd):
    """packed_conv_rgb walks packed_conv's tiles with one slab (Cout 32 or
    64): a tile writes rows y0 .. y0 + rows - 1, columns x0 .. x0 + 31 of the
    NHWC output, all three channels. Every pixel once, at the generator's
    final-stage shapes and at ragged tile counts, and every tile once in the
    persistent blocks' walk."""
    o_slab, rows = tpk.conv_tiling(cout)
    assert o_slab == cout and rows == tpk._tile_rows(cout)
    n, origins = _conv_origins(bsz, cout, h, wd)
    assert n == bsz * (h // rows) * (wd // 32)
    seen = np.zeros((bsz, h, wd), np.int32)
    for b, y0, x0, o0 in origins:
        assert o0 == 0
        seen[b, y0:y0 + rows, x0:x0 + 32] += 1
    assert (seen == 1).all()
    _walk_covers_tiles_once(n)


@pytest.mark.parametrize("bsz,cout,h,wd", [(1, 32, 32, 16), (3, 64, 32, 48), (2, 32, 64, 64)])
def test_upconv_walk_covers_every_output_once_ragged(bsz, cout, h, wd):
    """Each tile writes output rows 2 * (i0 + r) + py, columns 2 * j0 ..
    2 * j0 + 31: every output pixel of the 2h x 2wd map once."""
    rows, cols = tpk.upconv_tiling(cout)
    n, origins = _upconv_origins(bsz, cout, h, wd)
    seen = np.zeros((bsz, 2 * h, 2 * wd), np.int32)
    for b, i0, j0, py in origins:
        seen[b, 2 * i0 + py:2 * (i0 + rows) + py:2, 2 * j0:2 * (j0 + cols)] += 1
    assert (seen == 1).all()
    _walk_covers_tiles_once(n)


@pytest.mark.parametrize("path", sorted(UPCONV_SHAPES))
def test_upconv_walk_covers_the_paths_shapes(path):
    for bsz, _, cout, h in UPCONV_SHAPES[path]:
        rows, cols = tpk.upconv_tiling(cout)
        n, origins = _upconv_origins(bsz, cout, h, h)
        assert n == 2 * bsz * (h // rows) * (h // cols)
        assert len(set(origins)) == n
        for b, i0, j0, py in origins:
            assert 0 <= b < bsz and py in (0, 1) and i0 % rows == 0 and j0 % cols == 0
            assert i0 + rows <= h and j0 + cols <= h
        # both parities of one patch one after the other
        assert [o[3] for o in origins[:4]] == [0, 1, 0, 1]
        assert origins[0][:3] == origins[1][:3]
        _walk_covers_tiles_once(n)


@pytest.mark.parametrize("kind,cout,want", [("conv", 32, 207_360), ("conv", 64, 195_072),
                                            ("conv", 128, 195_072), ("upconv", 32, 205_824),
                                            ("upconv", 64, 139_776), ("conv_rgb", 32, 207_360),
                                            ("conv_rgb", 64, 195_072)])
def test_ring_fits_one_block_an_sm(kind, cout, want):
    """The bytes the wrappers pass (and the kernels check against their own
    kBytes): under a block's 232,448, room for the RING_BLOCKS_PER_SM the
    source note states and not for one more; the note's arithmetic names
    the same figure. Cout 128 is the recompute's walk over two 64-channel
    slabs; packed_conv_rgb's ring (ConvRgbRing) keeps packed_conv's stages."""
    if kind == "conv_rgb":
        src = (CSRC / "packed_conv_rgb.cu").read_text()
        assert "using Ring = ConvRgbRing<COUT, U8>;" in src and "smem != Ring::kBytes" in src
    got = tpk.upconv_ring_bytes(cout) if kind == "upconv" else tpk.conv_ring_bytes(cout)
    assert got == want
    assert got <= tpk.SMEM_PER_BLOCK
    per_block = got + tpk.SMEM_RESERVED
    assert tpk.RING_BLOCKS_PER_SM * per_block <= tpk.SMEM_PER_SM
    assert (tpk.RING_BLOCKS_PER_SM + 1) * per_block > tpk.SMEM_PER_SM
    assert f"{want:,}" in (CSRC / "conv_ring.cuh").read_text()
    assert tpk.RING_CC > 8  # the old loop staged 8 input channels a step


def test_argtypes_match_the_c_entry_points():
    """Each wrapper's ctypes argument list has as many entries as its
    kernel's extern "C" function (the stream last)."""
    for name, argtypes in tpk._ARGTYPES.items():
        src = (CSRC / f"{name}.cu").read_text()
        m = re.search(rf'extern "C" int probgan_{name}\(([^)]*)\)', src)
        assert m is not None, name
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_convpool_backward_recomputes_its_mask_with_lrelu(monkeypatch):
    """_ConvPoolLrelu.backward asks packed_conv for epilogue "lrelu" (the
    kernel whose sums equal packed_convpool's forward, at the forward's
    mode), on the saved input and weights, and "none" only for the input
    gradient, at the forward's mode too."""
    calls = []
    real = tpk.packed_conv

    def spy(x, w, b, epilogue="lrelu_norm", mode="high"):
        calls.append((epilogue, x, w, mode))
        return real(x, w, b, epilogue, mode)

    monkeypatch.setattr(tpk, "packed_conv", spy)
    g = torch.Generator().manual_seed(5)
    x = torch.randn((2, 8, 8, 16), generator=g, requires_grad=True)
    w = (0.2 * torch.randn((16, 8, 3, 3), generator=g)).requires_grad_(True)
    b = torch.randn(16, generator=g, requires_grad=True)
    for mode in ("highest", "mid"):
        calls.clear()
        y = packed_vjp.convpool_lrelu(x, w, b, mode)
        assert calls == []  # the forward is packed_convpool alone
        y.backward(torch.randn(y.shape, generator=g))
        assert [c[0] for c in calls] == ["lrelu", "none"]
        assert torch.equal(calls[0][1], x.detach()) and torch.equal(calls[0][2], w.detach())
        assert [c[3] for c in calls] == [mode, mode]
