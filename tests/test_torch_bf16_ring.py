"""The pipelined bf16 main loop that packed_conv (B2) and packed_upconv (B1)
run on the card at kernel modes "default" and "mid" (csrc/bf16_ring.cuh).

The kernels run only on the card; what their wrappers hand them is plain
Python: the tiling, the persistent blocks' walk and the ring's shared-memory
bytes (checked against the kernel's own constant at launch). Here the walk
must cover every output once, the ring's schedule must never overwrite a
stage before its products ran, and the bytes must fit the blocks an SM the
source note states.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from probgan_tpu_torch.ops import packed as tpk

CSRC = Path(tpk.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132

# (batch, C, Cout, H): packed_conv's bf16 launches: generate's and score's
# (batch 8), the train step's at 1024² and at the narrow generator N
# (batch 2: "lrelu", the mask recompute, "none"), N's serving at 16 and 8
CONV_SHAPES = [(8, 64, 64, 512), (2, 64, 64, 512), (8, 32, 32, 1024), (2, 32, 64, 1024),
               (2, 64, 128, 512), (2, 32, 32, 1024), (2, 64, 32, 1024), (2, 128, 64, 512),
               (8, 16, 16, 512), (8, 8, 8, 1024), (2, 16, 8, 1024), (2, 32, 16, 512)]
# (batch, C, Cout, input H): packed_upconv's, stages 7 and 8 and N's
UPCONV_SHAPES = [(8, 128, 64, 256), (8, 64, 32, 512), (2, 128, 64, 256), (2, 64, 32, 512),
                 (8, 32, 16, 256), (8, 16, 8, 512)]
# bytes a block of each ring, the figures csrc/bf16_ring.cuh states
RING_BYTES = {("packed_conv", 64): 195_584, ("packed_conv", 32): 231_424,
              ("packed_conv", 16): 208_384, ("packed_conv", 8): 196_864,
              ("packed_upconv", 64): 207_360, ("packed_upconv", 32): 219_648,
              ("packed_upconv", 16): 188_928, ("packed_upconv", 8): 173_568}


def _ring_bytes(name, cout):
    return tpk.bf16_ring_bytes(cout) if name == "packed_conv" else tpk.bf16_upconv_ring_bytes(cout)


def _blocks_visit_each_tile_once(n_tiles, per_sm):
    for sms in (1, 7, H100_SMS):
        blocks = tpk.persistent_blocks(n_tiles, sms, per_sm)
        assert blocks == min(n_tiles, per_sm * sms)
        visits = np.zeros(n_tiles, np.int64)
        for k in range(blocks):
            visits[k::blocks] += 1
        assert (visits == 1).all()


def _conv_seen(bsz, cout, h, wd):
    o_slab, rows = tpk.conv_tiling(cout)
    assert rows == (8 if o_slab == 64 else 16)  # BfTile<slab>::TH
    n = tpk.conv_tile_count(bsz, cout, h, wd)
    seen = np.zeros((bsz, cout, h, wd), np.int32)
    for t in range(n):
        b, y0, x0, o0 = tpk.conv_tile_origin(t, cout, h, wd)
        seen[b, o0:o0 + o_slab, y0:y0 + rows, x0:x0 + 32] += 1
    return n, seen


def _upconv_seen(bsz, cout, h, wd):
    rows, cols = tpk.upconv_tiling(cout)
    assert (rows, cols) == (8 if cout == 64 else 16, 16)  # BfTile<Cout>::TH x 16
    n = tpk.upconv_tile_count(bsz, cout, h, wd)
    seen = np.zeros((bsz, 2 * h, 2 * wd), np.int32)
    for t in range(n):
        b, i0, j0, py = tpk.upconv_tile_origin(t, cout, h, wd)
        seen[b, 2 * i0 + py:2 * (i0 + rows) + py:2, 2 * j0:2 * (j0 + cols)] += 1
    return n, seen


@pytest.mark.parametrize("kind,bsz,cout,h,wd", [
    ("conv", 1, 96, 48, 64), ("conv", 3, 24, 32, 96), ("conv", 2, 128, 24, 32),
    ("conv", 1, 8, 16, 32), ("upconv", 3, 64, 24, 48), ("upconv", 1, 16, 48, 16),
    ("upconv", 2, 8, 32, 64)])
def test_walk_covers_every_output_once_ragged(kind, bsz, cout, h, wd):
    """Small shapes, Cout 96 and 24 in slabs of 32 and 8, tile counts no
    block count divides: every output once, every tile once in the
    persistent blocks' walk (one block an SM, the bf16 rings' count)."""
    n, seen = (_conv_seen if kind == "conv" else _upconv_seen)(bsz, cout, h, wd)
    assert (seen == 1).all()
    name = f"packed_{kind}"
    _blocks_visit_each_tile_once(n, tpk.ring_blocks_per_sm(_ring_bytes(name, cout)))


@pytest.mark.parametrize("kind,shape", [("conv", s) for s in CONV_SHAPES]
                         + [("upconv", s) for s in UPCONV_SHAPES])
def test_walk_covers_the_paths_shapes(kind, shape):
    """At the paths' shapes: distinct tiles on the tile grid, inside the
    output, as many as the grid has, so they cover each output once; and the
    blocks' walk covers each tile once."""
    bsz, _, cout, h = shape
    if kind == "conv":
        o_slab, rows = tpk.conv_tiling(cout)
        n = tpk.conv_tile_count(bsz, cout, h, h)
        origins = [tpk.conv_tile_origin(t, cout, h, h) for t in range(n)]
        assert n == bsz * (h // rows) * (h // 32) * (cout // o_slab)
        for b, y0, x0, o0 in origins:
            assert 0 <= b < bsz and y0 % rows == 0 and x0 % 32 == 0 and o0 % o_slab == 0
            assert y0 + rows <= h and x0 + 32 <= h and o0 + o_slab <= cout
    else:
        rows, cols = tpk.upconv_tiling(cout)
        n = tpk.upconv_tile_count(bsz, cout, h, h)
        origins = [tpk.upconv_tile_origin(t, cout, h, h) for t in range(n)]
        assert n == 2 * bsz * (h // rows) * (h // cols)
        for b, i0, j0, py in origins:
            assert 0 <= b < bsz and py in (0, 1) and i0 % rows == 0 and j0 % cols == 0
            assert i0 + rows <= h and j0 + cols <= h
    assert len(set(origins)) == n
    _blocks_visit_each_tile_once(n, tpk.ring_blocks_per_sm(_ring_bytes(f"packed_{kind}", cout)))


def _ring_schedule(n_tiles, n_chunks, blocks, stages):
    """bf16_ring_walk for every block, step by step: the stage each step's
    copies fill, and for each step, when its products run, the step that the
    stage holds then (none overwritten early) and the stages in flight."""
    done = []
    for block in range(blocks):
        my_tiles = (n_tiles - block + blocks - 1) // blocks if block < n_tiles else 0
        n_steps = my_tiles * n_chunks
        holds = {}
        nxt = [block, 0]

        def issue(stage):
            holds[stage] = tuple(nxt)
            nxt[1] += 1
            if nxt[1] == n_chunks:
                nxt[:] = [nxt[0] + blocks, 0]
        for s in range(stages - 1):
            if s < n_steps:
                issue(s)
        tile, chunk = block, 0
        for it in range(n_steps):
            if it + stages - 1 < n_steps:
                issue((it + stages - 1) % stages)
            assert holds[it % stages] == (tile, chunk)
            done.append((tile, chunk))
            chunk += 1
            if chunk == n_chunks:
                tile, chunk = tile + blocks, 0
    return done


@pytest.mark.parametrize("name", ["packed_conv", "packed_upconv"])
@pytest.mark.parametrize("n_tiles,n_chunks,blocks", [(7, 2, 3), (16, 1, 5), (5, 4, 8),
                                                     (264, 3, 132)])
def test_ring_schedule_runs_each_step_once_from_its_own_stage(name, n_tiles, n_chunks, blocks):
    """At the ring's stage count: each (tile, chunk) step runs its products
    once, from the stage its copies filled, after the copies of the next
    kStages - 1 steps have been issued into the other stages only."""
    stages = tpk.BF16_RING_STAGES[name]
    src = (CSRC / "bf16_ring.cuh").read_text()
    assert f"static constexpr int kStages = {stages};" in src
    done = _ring_schedule(n_tiles, n_chunks, blocks, stages)
    assert sorted(done) == [(t, c) for t in range(n_tiles) for c in range(n_chunks)]


@pytest.mark.parametrize("name,cout", sorted(RING_BYTES))
def test_ring_fits_one_block_an_sm(name, cout):
    """The bytes the wrappers pass (and the kernels check): the same at both
    term counts, under a block's 232,448, one block an SM and not two; the
    source note names the same figure."""
    want = RING_BYTES[(name, cout)]
    assert _ring_bytes(name, cout) == want
    rows = 8 if cout == 64 else 16
    if name == "packed_conv":
        assert want == 4 * 2 * (32 * ((rows + 2) * 40 + 4) + 9 * cout * 20)
    else:
        assert want == 4 * 3 * (32 * ((rows + 1) * 24 + 4) + 8 * cout * 20)
    assert want <= tpk.SMEM_PER_BLOCK
    assert tpk.ring_blocks_per_sm(want) == 1
    assert 2 * (want + tpk.SMEM_RESERVED) > tpk.SMEM_PER_SM
    assert f"{want:,}" in (CSRC / "bf16_ring.cuh").read_text()
    if name == "packed_conv":  # a slab's bytes, whatever Cout it tiles
        assert tpk.bf16_ring_bytes(2 * cout if cout == 64 else 3 * cout) == want


def test_channel_stride_spreads_a_fragment_load_over_the_banks():
    """A fragment register's two loads: lanes (g, t) read channel 2t (+1) of
    pixel g, CS words a channel: the 32 lanes' words fall on 32 banks."""
    for rows, xw in ((10, 40), (18, 40), (9, 24), (17, 24)):
        cs = rows * xw + 4
        banks = {(2 * t * cs + g) % 32 for g in range(8) for t in range(4)}
        assert len(banks) == 32 and cs % 4 == 0


def test_c_entries_take_blocks_and_smem():
    """The two C entries end in (..., epilogue, blocks, smem, stream), as the
    ctypes lists say; the geometry entries take (width, terms, out); neither
    kernel file calls the synchronous loop any more."""
    for name in ("packed_conv_bf16", "packed_upconv_bf16"):
        src = (CSRC / f"{name}.cu").read_text()
        args = re.search(rf'extern "C" int probgan_{name}\(([^)]*)\)', src).group(1).split(",")
        assert [a.split()[-1] for a in args[-4:]] == ["epilogue", "blocks", "smem", "stream"]
        assert len(args) == len(tpk._ARGTYPES[name])
        assert tpk._ARGTYPES[name][-3:-1] == [tpk._I, tpk._I]
        geo = re.search(rf'extern "C" int probgan_{name}_geometry\(([^)]*)\)', src).group(1)
        assert len(geo.split(",")) == 3
        assert "conv_bf16_tile" not in src and "stage_chunk" not in src
        assert '#include "bf16_ring.cuh"' in src


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


def _meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.mark.parametrize("mode,terms", [("default", 1), ("mid", 2)])
def test_wrappers_pass_blocks_and_ring_bytes(recorded, mode, terms):
    """generate's B2 (64 -> 64 at 512², batch 8: 4,096 tiles) and B1 with
    toRGB (64 -> 32 from 512²), a 2-tile B2: blocks min(tiles, 132), the
    ring's bytes, the weights' bf16 layout."""
    with torch.no_grad():
        tpk.packed_conv(_meta(8, 64, 512, 512), _meta(64, 64, 3, 3), _meta(64), mode=mode)
        tpk.packed_upconv(_meta(8, 64, 512, 512), _meta(32, 64, 3, 3), _meta(32),
                          rgb_w=_meta(3, 64), rgb_b=_meta(3), mode=mode)
        tpk.packed_conv(_meta(1, 16, 16, 64), _meta(8, 16, 3, 3), _meta(8), "none", mode=mode)
    (n1, conv), (n2, up), (n3, small) = recorded
    assert (n1, n2, n3) == ("packed_conv_bf16", "packed_upconv_bf16", "packed_conv_bf16")
    assert conv[4:] == (8, 64, 512, 512, 64, terms, 0, 132, 195_584)
    assert tuple(conv[1].shape) == (1, 2, 9, 64, tpk.BF16_ROW)
    assert up[7:] == (8, 64, 512, 512, 32, terms, 0, 132, 219_648)
    assert tuple(up[1].shape) == (2, 2, 2, 4, 32, tpk.BF16_ROW)
    assert small[4:] == (1, 16, 16, 64, 8, terms, 2, 2, 196_864)


def test_ablation_edits_find_their_anchors():
    """utils/bf16_ring_ablation.py switches parts of the loop off by text
    edits of bf16_ring.cuh: each anchor is in the source once, so every
    variant builds what its name says."""
    from probgan_tpu_torch.utils import bf16_ring_ablation as abl

    src = (CSRC / "bf16_ring.cuh").read_text()
    assert set(abl.VARIANTS) == {"all", *abl._EDITS}
    for variant, edits in abl._EDITS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (variant, old)
