"""The schedule and shared memory of the stage-fused kernels B10
``packed_upconv_conv`` and B11 ``packed_upconv_conv_rgb`` on the card
(csrc/fused_ring.cuh): persistent blocks walking runs of conv2 tiles down a
32-column strip, carrying conv1's two halo rows from tile to tile.

The kernels run only on the card; what their wrappers hand them is plain
Python (ops/packed.py): the split of the tiles into the blocks' ranges
(``fused_split``, which the C entries check) and the shared-memory bytes
(checked against the kernel's own constant at launch). Here the wrappers
must pass those; the walk must visit every conv2 tile of every image
exactly once, ragged counts included; no run may cross an image or a strip;
the bytes must fit the blocks an SM that the split assumes (one at 32 and 64
channels, two at 16, three at 8) as the source note states; and the conv1
pixels computed per conv2 output must stay near the 34/32 of the halo
columns. chip_smoke.py holds the kernels' outputs to the pair's, bit for
bit, and utils/conv_clock_split.py the walk the card takes to
``fused_tile_origin``'s.
"""

from pathlib import Path

import pytest
import torch

from probgan_tpu_torch.ops import packed as tpk

CSRC = Path(tpk.__file__).resolve().parent.parent / "csrc"
H100_SMS = 132

# (batch, C, Cout, input H = W): the stage-fused launches at 1024²: B10 at
# stage 7 and B11 at stage 8 (and at stage 7 when it is the last stage), at
# generate's batch and the kernels' test batch; then the narrow generator N's
# (fmap_base 2048): B10 32 -> 16 at stage 7 (B11 there in latent_walk) and
# B11 16 -> 8 at stage 8
PATH_SHAPES = [(2, 128, 64, 256), (8, 128, 64, 256), (2, 64, 32, 512), (8, 64, 32, 512),
               (2, 32, 16, 256), (8, 32, 16, 256), (2, 16, 8, 512), (8, 16, 8, 512)]


def _walk(bsz, cout, h, wd, sms):
    """{block: [(image, row, column, first), ...]} in the order the block
    walks its tiles (t = block + k * blocks, as ring_walk does)."""
    n = tpk.fused_tile_count(bsz, cout, h, wd)
    split = tpk.fused_split(bsz, cout, h, wd, sms)
    assert split[0] * split[1] + split[2] == n and 0 <= split[2] < split[0]
    walk = {}
    for blk in range(split[0]):
        walk[blk] = [tpk.fused_tile_origin(t, split, cout, h, wd)
                     for t in range(blk, n, split[0])]
    return n, walk


@pytest.mark.parametrize("bsz,cout,h,wd,sms", [
    (1, 64, 4, 16, 1), (3, 64, 12, 48, 5), (2, 32, 24, 32, 7), (3, 32, 8, 16, 2),
    (1, 64, 100, 128, H100_SMS), (3, 64, 256, 256, H100_SMS), (2, 32, 40, 80, 11),
    (2, 16, 24, 32, 7), (3, 8, 8, 16, 2), (3, 16, 200, 256, H100_SMS),
    (1, 8, 40, 80, 11)])
def test_fused_walk_covers_every_tile_once(bsz, cout, h, wd, sms):
    """Small shapes with tile counts that no block count divides, and the
    ragged stage-7 cases of chip_smoke.py (batch 3; 200 x 256 below): every
    (image, tile row, strip) once, inside the output."""
    rows, cols = tpk.fused_tiling(cout)
    n, walk = _walk(bsz, cout, h, wd, sms)
    blocks = len(walk)
    seen = [o[:3] for tiles in walk.values() for o in tiles]
    assert len(seen) == n == len(set(seen))
    for b, y0, x0 in seen:
        assert 0 <= b < bsz and 0 <= y0 < 2 * h and 0 <= x0 < 2 * wd
        assert y0 % rows == 0 and x0 % cols == 0
    # ring_walk's share of a block: (n - block + blocks - 1) // blocks tiles
    assert [len(walk[k]) for k in range(blocks)] == [
        (n - k + blocks - 1) // blocks for k in range(blocks)]


@pytest.mark.parametrize("bsz,cout,h,wd", [(3, 64, 200, 256), (2, 32, 40, 80), (3, 8, 200, 256),
                                            *[(b, cout, h, h) for b, _, cout, h in PATH_SHAPES]])
def test_fused_runs_stay_in_one_strip(bsz, cout, h, wd):
    """A tile that carries rows from the one before it in its block's walk
    lies right below it, in the same strip of the same image; a block's first
    tile and each tile at the top of a strip start a run; fused_runs gives
    the same runs."""
    rows, _ = tpk.fused_tiling(cout)
    _, walk = _walk(bsz, cout, h, wd, H100_SMS)
    runs = tpk.fused_runs(bsz, cout, h, wd, H100_SMS)
    for blk, tiles in walk.items():
        assert tiles[0][3]
        got = []
        for prev, cur in zip([None] + tiles[:-1], tiles):
            if cur[3]:
                got.append([])
                assert prev is None or cur[1] == 0
            else:
                assert (cur[0], cur[2]) == (prev[0], prev[2]) and cur[1] == prev[1] + rows
            got[-1].append(cur[:3])
        assert got == runs[blk]


@pytest.mark.parametrize("cout,rgb,want,per_sm", [
    (64, False, 206_592, 1), (64, True, 207_360, 1), (32, False, 184_320, 1),
    (32, True, 185_856, 1), (16, False, 110_080, 2), (16, True, 111_616, 2),
    (8, False, 72_960, 3), (8, True, 74_496, 3)])
def test_fused_ring_fits_one_block_an_sm(cout, rgb, want, per_sm):
    """The bytes the wrappers pass (and the kernels check against
    FusedRing::kBytes): under a block's 232,448, and the blocks an SM that
    fused_split assumes fit (one at 64 and 32 channels, two at 16, three at
    8) and one more would not; the source note's arithmetic names the same
    figure."""
    got = tpk.fused_ring_bytes(cout, rgb)
    assert got == want
    per_block = got + tpk.SMEM_RESERVED
    assert tpk.fused_blocks_per_sm(cout) == per_sm
    assert got <= tpk.SMEM_PER_BLOCK and per_sm * per_block <= tpk.SMEM_PER_SM
    assert (per_sm + 1) * per_block > tpk.SMEM_PER_SM
    src = (CSRC / "fused_ring.cuh").read_text()
    assert f"{want:,}" in src
    below = tpk.FUSED_STAGES[32 if cout == 64 else cout]  # the stages of every Cout below 64
    assert f"kStages = COUT == 64 ? {tpk.FUSED_STAGES[64]} : {below};" in src
    assert f"kC1 = {tpk.FUSED_C1};" in src
    assert f"kC2 = COUT < {tpk.FUSED_C2} ? COUT : {tpk.FUSED_C2};" in src
    assert tpk.fused_c2(cout) == min(tpk.FUSED_C2, cout)


@pytest.mark.parametrize("bsz,c,cout,h", PATH_SHAPES)
def test_fused_conv1_overhead_on_the_paths_shapes(bsz, c, cout, h):
    """conv1 pixels computed per conv2 output on the path's shapes at 132
    blocks: at most 1.10 (the kernel this replaced: 1.33 at 64 channels,
    1.20 at 32), and no less than the halo columns' 34/32."""
    ratio = tpk.fused_conv1_per_output(bsz, cout, h, h, H100_SMS)
    assert 34 / 32 < ratio <= 1.10
    # without the carry every tile would compute its whole halo
    rows, _ = tpk.fused_tiling(cout)
    assert ratio < 34 / 32 * (rows + 2) / rows


@pytest.mark.parametrize("rgb", [False, True])
@pytest.mark.parametrize("bsz,c,cout,h,wd", [(3, 128, 64, 200, 256), *[
    (b, c, cout, h, h) for b, c, cout, h in PATH_SHAPES]])
def test_fused_wrappers_pass_the_split_and_bytes(bsz, c, cout, h, wd, rgb, monkeypatch):
    """What a wrapper hands its C entry (on meta tensors, the device check
    and the launch replaced by a recorder): the blocks, per_block and extra
    of fused_split for the card's SMs, then fused_ring_bytes, in the places
    of the entry's argument list; the launch is counted by its width (its
    ``slab``, kept in narrow_launches below 32 channels)."""
    launched = []
    monkeypatch.setattr(tpk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tpk, "_sms", lambda device: H100_SMS)
    monkeypatch.setattr(tpk, "_launch",
                        lambda name, x, *args, **kw: launched.append((name, args, kw)))

    def meta(*shape):
        return torch.empty(shape, device="meta")

    w1, w2, b = meta(cout, c, 3, 3), meta(cout, cout, 3, 3), meta(cout)
    x = meta(bsz, c, h, wd)
    with torch.no_grad():
        if rgb:
            out = tpk.packed_upconv_conv_rgb(x, w1, b, w2, b, meta(3, cout), meta(3), meta(3, c),
                                             meta(3), 0.5, emit_uint8=True)
        else:
            out = tpk.packed_upconv_conv(x, w1, b, w2, b)
    name = "packed_upconv_conv_rgb" if rgb else "packed_upconv_conv"
    assert out.shape == ((bsz, 2 * h, 2 * wd, 3) if rgb else (bsz, cout, 2 * h, 2 * wd))
    assert [n for n, _, _ in launched] == [name]
    args = launched[0][1]
    assert launched[0][2] == {"slab": cout}
    assert len(args) + 1 == len(tpk._ARGTYPES[name])  # the stream follows
    assert args[-9:] == (bsz, c, h, wd, cout, *tpk.fused_split(bsz, cout, h, wd, H100_SMS),
                         tpk.fused_ring_bytes(cout, rgb))
