"""B5 packed_convpool on the pipelined rings: fp32 (csrc/conv_ring.cuh
ConvPoolRing) at "high"/"highest", bf16 (csrc/bf16_ring.cuh
ConvPoolBf16Ring) at "default" and "mid".

The kernels run only on the card; what their wrappers hand them is plain
Python: packed_conv's tiling and tile walk, the persistent blocks and the
ring's bytes (checked against the kernel's own constant at launch). Here the
walk must cover every pooled output once, each thread's pixels must hold
whole 2x2 windows (fp32: in one thread; bf16: in a lane and its xor-4
partner), the float4 reads of the fp32 pool map must cost no more
shared-memory wavefronts than their bytes, and the wrappers must launch the
blocks and bytes that the sources state.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from probgan_tpu_torch.ops import packed as tpk

CSRC = Path(tpk.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132

# (epilogue, batch, C, Cout, H): score's (batch 8), the 1024² train step's,
# the narrow generator N's, and B5 "none" at a slab of 8
PATH_SHAPES = [("lrelu", 8, 32, 64, 1024), ("lrelu", 8, 64, 128, 512),
               ("lrelu", 2, 32, 64, 1024), ("lrelu", 2, 64, 128, 512),
               ("none", 2, 32, 64, 1024), ("none", 2, 64, 128, 512),
               ("lrelu", 8, 8, 16, 1024), ("lrelu", 8, 16, 32, 512),
               ("none", 2, 8, 16, 1024), ("none", 2, 8, 8, 1024)]


def _ring_bytes(cout, terms):
    return tpk.bf16_ring_bytes(cout) if terms else tpk.conv_ring_bytes(cout)


def _blocks_visit_each_tile_once(n_tiles, per_sm):
    for sms in (1, 7, H100_SMS):
        blocks = tpk.persistent_blocks(n_tiles, sms, per_sm)
        assert blocks == min(n_tiles, per_sm * sms)
        visits = np.zeros(n_tiles, np.int64)
        for k in range(blocks):
            visits[k::blocks] += 1
        assert (visits == 1).all()


@pytest.mark.parametrize("bsz,cout,h,wd", [(1, 96, 48, 64), (3, 40, 32, 96), (2, 128, 24, 32),
                                           (1, 8, 16, 32)])
def test_walk_covers_every_pooled_output_once_ragged(bsz, cout, h, wd):
    """Small shapes, Cout 96 and 40 in slabs of 32 and 8, tile counts no
    block count divides: the tiles' pooled outputs cover the pooled map
    once, and the persistent blocks (the fp32 ring's count an SM and the
    bf16 ring's) take every tile once."""
    o_slab, rows = tpk.conv_tiling(cout)
    n = tpk.conv_tile_count(bsz, cout, h, wd)
    seen = np.zeros((bsz, cout, h // 2, wd // 2), np.int32)
    for t in range(n):
        b, y0, x0, o0 = tpk.conv_tile_origin(t, cout, h, wd)
        seen[b, o0:o0 + o_slab, y0 // 2:(y0 + rows) // 2, x0 // 2:x0 // 2 + 16] += 1
    assert (seen == 1).all()
    for terms in (0, 1, 2):
        _blocks_visit_each_tile_once(n, tpk.ring_blocks_per_sm(_ring_bytes(cout, terms)))


@pytest.mark.parametrize("epi,bsz,c,cout,h", PATH_SHAPES)
def test_walk_covers_the_paths_shapes(epi, bsz, c, cout, h):
    """At the paths' shapes: distinct tiles of whole pooling windows (even
    rows and columns) inside the input, as many as the grid has, so their
    pooled outputs cover the map once; the blocks' walk covers each tile
    once at each mode's ring."""
    o_slab, rows = tpk.conv_tiling(cout)
    assert o_slab == tpk._pool_slab(cout) and rows % 2 == 0
    n = tpk.conv_tile_count(bsz, cout, h, h)
    assert n == bsz * (h // rows) * (h // 32) * (cout // o_slab)
    origins = np.array([tpk.conv_tile_origin(t, cout, h, h) for t in range(n)])
    assert len({tuple(o) for o in origins}) == n
    b, y0, x0, o0 = origins.T
    assert ((0 <= b) & (b < bsz)).all() and (y0 % rows == 0).all() and (x0 % 32 == 0).all()
    assert (y0 + rows <= h).all() and (x0 + 32 <= h).all() and (o0 + o_slab <= cout).all()
    assert (o0 % o_slab == 0).all()
    for terms in (0, 1, 2):
        _blocks_visit_each_tile_once(n, tpk.ring_blocks_per_sm(_ring_bytes(cout, terms)))


def _fp32_threads(cout):
    """conv_tile.cuh Tile<COUT>: threads, rows, lanes a pixel group, and the
    channel of a lane's n-th accumulator (channel_of)."""
    ncg = cout // 8
    npg = 32 if cout == 64 else 64
    rows = npg // 4

    def channel_of(cg, n):
        return 4 * cg + n if n < 4 else 4 * ncg + 4 * cg + n - 4
    return npg * ncg, rows, ncg, channel_of


@pytest.mark.parametrize("cout", [64, 32, 16, 8])
def test_fp32_pool_map_holds_whole_windows_in_one_thread(cout):
    """ConvPoolRing: thread (pg, cg) holds pixels rows 2 (pg / 8) + r,
    columns 4 (pg % 8) + j (acc[4r + j]): every tile pixel and channel once,
    each 2x2 window whole in one thread, stored at the pooled pixel
    (pg / 8, 2 (pg % 8) + j) as the source says."""
    threads, rows, ncg, channel_of = _fp32_threads(cout)
    owner = np.full((cout, rows, 32), -1)
    stored = np.zeros((cout, rows // 2, 16), np.int32)
    for tid in range(threads):
        cg, pg = tid % ncg, tid // ncg
        py, px = 2 * (pg // 8), 4 * (pg % 8)
        for n in range(8):
            ch = channel_of(cg, n)
            for r in range(2):
                for j in range(4):
                    assert owner[ch, py + r, px + j] == -1
                    owner[ch, py + r, px + j] = tid
            for j in range(2):  # v.x, v.y: acc[0, 1, 4, 5] and acc[2, 3, 6, 7]
                wins = {(py + r) // 2 * 16 + (px + 2 * j + i) // 2 for r in (0, 1) for i in (0, 1)}
                assert wins == {(pg // 8) * 16 + 2 * (pg % 8) + j}
                stored[ch, pg // 8, 2 * (pg % 8) + j] += 1
    assert (owner >= 0).all() and (stored == 1).all()
    win = owner.reshape(cout, rows // 2, 2, 16, 2)
    assert (win == win[:, :, :1, :, :1]).all()  # a window's four pixels: one thread


def _wavefronts(words_per_lane, width):
    """Shared-memory wavefronts of one warp's load: the most distinct
    addresses that fall on one bank (a `width`-word load spans `width`
    banks)."""
    per_bank = {}
    for w in set(words_per_lane):
        for k in range(width):
            per_bank.setdefault((w + k) % 32, set()).add(w)
    return max(len(v) for v in per_bank.values())


@pytest.mark.parametrize("cout", [64, 32, 16, 8])
def test_fp32_pool_reads_cost_their_bytes(cout):
    """The thread's patch rows py .. py + 3 in rows of 44 floats (12 mod 32):
    the warp's aligned float4 reads take no more wavefronts than their
    distinct bytes need (128 a wavefront); the scalar reads at columns
    px + 3 and px + 8 of 2 and 4 rows at Cout 16 and 8 fall on 8 banks (the
    2- and 4-way conflicts the source note states), none above."""
    threads, _, ncg, _ = _fp32_threads(cout)
    sw = 44
    for warp in range(threads // 32):
        pgs = [(warp * 32 + lane) // ncg for lane in range(32)]
        for r in range(4):
            base = [(2 * (pg // 8) + r) * sw + 4 * (pg % 8) + 3 for pg in pgs]
            f4 = [a + 1 for a in base]
            assert all(a % 4 == 0 for a in f4)
            need = -(-16 * len(set(f4)) // 128)
            assert _wavefronts(f4, 4) == need
            rows_in_warp = len({pg // 8 for pg in pgs})
            for off in (0, 5):
                assert _wavefronts([a + off for a in base], 1) == rows_in_warp
    assert sw % 32 == 12


@pytest.mark.parametrize("cout", [64, 32, 16, 8])
def test_bf16_pool_layout_holds_windows_in_a_lane_and_its_partner(cout):
    """ConvPoolBf16Ring (kPool2x8): m16 tile q = warp * MT + mt holds pixel g
    at row 2 (q / 4), column 8 (q % 4) + g and pixel g + 8 one row below;
    over the 8 warps every tile pixel once, a window's two rows in one lane
    (d[0] + d[2]) and its other column in lane ^ 4 (g ^ 1), and the even /
    odd lanes of a pair store channels 2 tq / 2 tq + 1 of the window at
    (q / 4, 4 (q % 4) + g / 2): every pooled value once."""
    rows = 8 if cout == 64 else 16
    mt_n = rows // 4  # BfTile::MT
    owner = -np.ones((4, rows, 32), np.int64)  # [tq][row][column]: the lane's channels 2 tq, + 1
    stored = np.zeros((cout, rows // 2, 16), np.int32)
    for warp in range(8):
        for mt in range(mt_n):
            q = warp * mt_n + mt
            for lane in range(32):
                g, tq = lane >> 2, lane & 3
                r, col = 2 * (q // 4), 8 * (q % 4) + g
                for rr in (r, r + 1):  # pixel g (d[0], d[1]) and g + 8 (d[2], d[3])
                    assert owner[tq, rr, col] == -1
                    owner[tq, rr, col] = warp * 32 + lane
                partner = lane ^ 4
                assert (partner >> 2) == g ^ 1 and (partner & 3) == tq
                assert (r // 2, col // 2) == (q // 4, 4 * (q % 4) + g // 2)
                assert ((partner >> 2) + 8 * (q % 4)) // 2 == col // 2
                for nt in range(cout // 8):
                    stored[8 * nt + 2 * tq + (g & 1), q // 4, 4 * (q % 4) + g // 2] += 1
    assert (owner >= 0).all() and (stored == 1).all()
    # rows 2k and 2k + 1 of a column: one lane; columns 2m and 2m + 1: lanes 4 apart
    assert (owner[:, 0::2] == owner[:, 1::2]).all()
    assert (owner[:, :, 1::2] - owner[:, :, 0::2] == 4).all()


def test_bf16_pool_fragment_loads_on_32_banks():
    """frag_a with `half` = XW (40 floats, the row below): the lanes' words
    are 2t * CS + g (+ XW, + CS, + 8 CS: warp-uniform), CS = SR * 40 + 4."""
    for rows in (10, 18):
        cs = rows * 40 + 4
        for extra in (0, 40, cs, 8 * cs, 40 + 9 * cs):
            banks = {(2 * t * cs + g + extra) % 32 for g in range(8) for t in range(4)}
            assert len(banks) == 32


def test_sources_run_on_the_rings():
    """Both B5 files launch ring structs through the walks, with blocks and
    the ring's bytes in their C entries, and call neither old loop; the old
    loops' pool paths are gone (the synchronous bf16 loop entirely: no csrc/
    file defines or calls it); the bytes the wrappers pass are the figures
    the ring notes state."""
    fp32 = (CSRC / "packed_convpool.cu").read_text()
    bf16 = (CSRC / "packed_convpool_bf16.cu").read_text()
    assert "ConvPoolRing<CT, ACT> cv" in fp32 and "ring_walk(cv" in fp32
    assert "ConvPoolBf16Ring<COUT, NTERM, EPI> cv" in bf16 and "bf16_ring_walk(cv" in bf16
    for name, src in (("packed_convpool", fp32), ("packed_convpool_bf16", bf16)):
        assert "conv3x3_accumulate" not in src and "conv_bf16_tile" not in src
        args = re.search(rf'extern "C" int probgan_{name}\(([^)]*)\)', src).group(1).split(",")
        assert [a.split()[-1] for a in args[-4:]] == ["act", "blocks", "smem", "stream"]
        assert len(args) == len(tpk._ARGTYPES[name])
    assert "bool POOL" not in (CSRC / "conv_tile.cuh").read_text()
    for src in CSRC.glob("*.cu*"):  # the synchronous bf16 loop is gone
        assert "conv_bf16_tile" not in src.read_text(), src.name
    ring, bf16_ring = (CSRC / "conv_ring.cuh").read_text(), (CSRC / "bf16_ring.cuh").read_text()
    for cout in (64, 32, 16, 8):
        assert f"{tpk.conv_ring_bytes(cout):,}" in ring
        assert f"{tpk.bf16_ring_bytes(cout):,}" in bf16_ring
    assert tpk.BF16_RING_STAGES["packed_convpool"] == tpk.BF16_RING_STAGES["packed_conv"]


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers on meta tensors as on the card (132 SMs), the C launch
    recorded instead of run."""
    calls = []
    monkeypatch.setattr(tpk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tpk, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(tpk, "_aligned16", lambda x: x)
    monkeypatch.setattr(tpk, "_ptr", lambda t: t)
    monkeypatch.setattr(tpk._build, "launch", lambda name, argtypes, device, *args:
                        calls.append((name, args)))
    tpk.reset_launches()
    yield calls
    tpk.reset_launches()


@pytest.mark.parametrize("mode", ["high", "highest", "default", "mid"])
def test_wrappers_pass_blocks_and_ring_bytes(recorded, mode):
    """Every path shape and a 2-tile call: blocks min(tiles, 132 x the
    ring's blocks an SM: 1 at slabs of 64 and 32, fp32 2 at 16 and 8), the
    ring's bytes, the weights' layout of the mode, the act flag."""
    terms = tpk.BF16_TERMS.get(mode, 0)
    shapes = PATH_SHAPES + [("none", 1, 16, 8, 16)]
    with torch.no_grad():
        for epi, bsz, c, cout, h in shapes:
            tpk.packed_convpool(torch.zeros((bsz, c, h, h if h > 16 else 64), device="meta"),
                                torch.zeros((cout, c, 3, 3), device="meta"),
                                torch.zeros(cout, device="meta"), epi, mode=mode)
    name = "packed_convpool_bf16" if terms else "packed_convpool"
    assert [n for n, _ in recorded] == [name] * len(shapes)
    for (epi, bsz, c, cout, h), (_, args) in zip(shapes, recorded):
        wd = h if h > 16 else 64
        slab = tpk._pool_slab(cout)
        smem = _ring_bytes(cout, terms)
        per_sm = 1 if terms or slab >= 32 else 2
        tiles = tpk.conv_tile_count(bsz, cout, h, wd)
        assert tpk.ring_blocks_per_sm(smem) == per_sm
        assert args[4:9] == (bsz, c, h, wd, cout)
        assert args[-2:] == (min(tiles, per_sm * H100_SMS), smem)
        assert args[-3] == int(epi == "lrelu")
        if terms:
            assert args[9] == terms
            assert tuple(args[1].shape) == (cout // slab, -(-c // 32), 9, slab, tpk.BF16_ROW)
        else:
            assert tuple(args[1].shape) == (cout // slab, c, 3, 3, slab)
    assert recorded[-1][1][-2] == 2  # 16 rows x 64 columns: 2 tiles, 2 blocks
    suffix = {0: "", 1: "_bf16", 2: "_mid"}[terms]
    assert tpk.launches[f"packed_convpool{suffix}"] == len(shapes)
