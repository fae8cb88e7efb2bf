"""B3 packed_conv_rgb at kernel modes "default" and "mid" on the pipelined
bf16 ring (csrc/bf16_ring.cuh ConvRgbBf16Ring: B2 "lrelu_norm"'s ring at one
slab of all Cout, with the toRGB tail as its epilogue).

The kernel runs only on the card; what its wrapper hands it is plain Python:
packed_conv's tiling and tile walk at one slab, the persistent blocks and
the ring's bytes (checked against the kernel's own constant at launch). Here
the walk must cover every output pixel once, the wrapper must launch the
blocks and bytes the source states, the source must run the ring and no
synchronous loop, and the plain twin at a ragged C (a partial chunk of 8
input channels) must match the JAX kernel at both bf16 modes.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.ops import packed as tpk
from tests.test_torch_bf16_ring import (  # noqa: F401 (recorded: the wrappers on meta tensors)
    CSRC,
    H100_SMS,
    _blocks_visit_each_tile_once,
    _meta,
    recorded,
)
from tests.test_torch_packed import _assert_uint8_close, _nchw, _oihw, _phase_blocked, _rand

# (batch, C, Cout, H): generate's B3 at batch 8: stage 8 (32 -> 32 at 1024²),
# stage 7 (64 -> 64 at 512²), the narrow generator N's 16 -> 16 at 512² and
# 8 -> 8 at 1024²
PATH_SHAPES = [(8, 32, 32, 1024), (8, 64, 64, 512), (8, 16, 16, 512), (8, 8, 8, 1024)]
REL = 2e-5  # "mid": twin vs the JAX kernel, of the largest entry (tests/test_torch_mid.py)


def _rgb_seen(bsz, cout, h, wd):
    """The tiles of B3's walk laid on its NHWC output: each pixel's count."""
    o_slab, rows = tpk.conv_tiling(cout)
    assert o_slab == cout and rows == (8 if cout == 64 else 16)  # one slab, BfTile::TH
    n = tpk.conv_tile_count(bsz, cout, h, wd)
    assert n == bsz * (h // rows) * (wd // 32)
    seen = np.zeros((bsz, h, wd), np.int32)
    for t in range(n):
        b, y0, x0, o0 = tpk.conv_tile_origin(t, cout, h, wd)
        assert o0 == 0
        seen[b, y0:y0 + rows, x0:x0 + 32] += 1
    return n, seen


@pytest.mark.parametrize("bsz,cout,h,wd", [(1, 64, 40, 96), (3, 32, 48, 64), (2, 16, 16, 160),
                                           (1, 8, 32, 32)]
                         + [(b, co, h, h) for b, _, co, h in PATH_SHAPES])
def test_walk_covers_every_pixel_once(bsz, cout, h, wd):
    """Small shapes whose tile counts no block count divides, and the paths'
    shapes: every output pixel once, and the persistent blocks (one an SM,
    the bf16 ring's count) take every tile once."""
    n, seen = _rgb_seen(bsz, cout, h, wd)
    assert (seen == 1).all()
    assert tpk.ring_blocks_per_sm(tpk.bf16_ring_bytes(cout)) == 1
    _blocks_visit_each_tile_once(n, 1)


@pytest.mark.parametrize("mode,terms", [("default", 1), ("mid", 2)])
@pytest.mark.parametrize("bsz,c,cout,h", PATH_SHAPES)
def test_wrapper_passes_blocks_and_ring_bytes(recorded, mode, terms, bsz, c, cout, h):
    """uint8 (alpha 1) and fp32 (alpha 0.3) at each bf16 mode: the launch
    ends in (..., emit_uint8, B, C, H, W, Cout, terms, blocks, smem) with
    blocks min(tiles, 132) and B2's ring bytes at a slab of Cout, the weights
    in B2's bf16 layout at one slab, toRGB's weights rounded; counted under
    the mode's counter. The fp32 mode's launch is unchanged."""
    args = (_meta(bsz, c, h, h), _meta(cout, c, 3, 3), _meta(cout), _meta(3, cout), _meta(3),
            _meta(bsz, 3, h // 2, h // 2))
    with torch.no_grad():
        for u8 in (True, False):
            tpk.packed_conv_rgb(*args, 1.0 if u8 else 0.3, emit_uint8=u8, mode=mode)
        tpk.packed_conv_rgb(*args, 1.0, emit_uint8=True, mode="high")
    (n1, a1), (n2, a2), (n3, a3) = recorded
    assert (n1, n2, n3) == ("packed_conv_rgb_bf16", "packed_conv_rgb_bf16", "packed_conv_rgb")
    n_tiles = tpk.conv_tile_count(bsz, cout, h, h)
    assert n_tiles >= H100_SMS
    smem = tpk.bf16_ring_bytes(cout)
    assert a1[8:] == (1, bsz, c, h, h, cout, terms, H100_SMS, smem)
    assert a2[8:] == (0, bsz, c, h, h, cout, terms, H100_SMS, smem)
    assert (a1[6], a2[6]) == (1.0, 0.3)
    assert len(a1) == len(tpk._ARGTYPES["packed_conv_rgb_bf16"]) - 1  # the stream comes last
    assert tuple(a1[1].shape) == (tpk.bf16_chunks(c), 9, cout, tpk.BF16_ROW)
    assert a1[1].dtype == torch.bfloat16 and tuple(a1[3].shape) == (3, cout)
    fp32_smem = tpk.conv_ring_bytes(cout)  # the fp32 ring: two blocks an SM below 32
    assert a3[-3:] == (cout, tpk.persistent_blocks(n_tiles, H100_SMS,
                                                   tpk.ring_blocks_per_sm(fp32_smem)), fp32_smem)
    assert len(a3) == len(tpk._ARGTYPES["packed_conv_rgb"]) - 1
    counter = "packed_conv_rgb_bf16" if terms == 1 else "packed_conv_rgb_mid"
    assert tpk.launches[counter] == 2 and tpk.launches["packed_conv_rgb"] == 1


def test_small_launch_takes_one_block_a_tile(recorded):
    """Fewer tiles than SMs: one block a tile (a ragged C of 40 at 32 -> 64²)."""
    with torch.no_grad():
        tpk.packed_conv_rgb(_meta(1, 40, 64, 64), _meta(32, 40, 3, 3), _meta(32),
                            _meta(3, 32), _meta(3), _meta(1, 3, 32, 32), 1.0, emit_uint8=True,
                            mode="default")
    (_, args), = recorded
    assert args[-2:] == (4 * 2, tpk.bf16_ring_bytes(32))
    assert tuple(args[1].shape) == (2, 9, 32, tpk.BF16_ROW)


def test_source_runs_the_ring():
    """packed_conv_rgb_bf16.cu launches ConvRgbBf16Ring through
    bf16_ring_walk, one block an SM; its C entry ends in (..., blocks, smem,
    stream), as many arguments as the ctypes list; the geometry entry takes
    (cout, terms, out). ConvRgbBf16Ring inherits B2 "lrelu_norm"'s ring and
    has only its own epilogue."""
    src = (CSRC / "packed_conv_rgb_bf16.cu").read_text()
    assert "ConvRgbBf16Ring<COUT, NTERM, U8> cv" in src and "bf16_ring_walk(cv" in src
    assert "__launch_bounds__(kThreads, 1)" in src and '#include "bf16_ring.cuh"' in src
    assert "conv_bf16_tile" not in src and "stage_chunk" not in src
    name = "packed_conv_rgb_bf16"
    args = re.search(rf'extern "C" int probgan_{name}\(([^)]*)\)', src).group(1).split(",")
    assert [a.split()[-1] for a in args[-4:]] == ["terms", "blocks", "smem", "stream"]
    assert len(args) == len(tpk._ARGTYPES[name])
    assert tpk._ARGTYPES[name][-3:-1] == [tpk._I, tpk._I]
    geo = re.search(rf'extern "C" int probgan_{name}_geometry\(([^)]*)\)', src).group(1)
    assert [a.split()[-1] for a in geo.split(",")] == ["cout", "terms", "out"]
    ring = (CSRC / "bf16_ring.cuh").read_text()
    body = ring[ring.index("struct ConvRgbBf16Ring"):]
    body = body[:body.index("\n};\n")]
    assert body.startswith("struct ConvRgbBf16Ring : ConvBf16Ring<COUT, NTERM, kLreluNorm> {")
    assert "void finish(" in body and "void compute(" not in body and "void issue(" not in body
    assert tpk.BF16_RING_STAGES["packed_conv_rgb"] == tpk.BF16_RING_STAGES["packed_conv"] == 2


def test_ring_note_states_the_bytes():
    """The bytes B3 launches are B2's ring at a slab of Cout: 2 stages of the
    fp32 patch (tile rows + 2 rows of 40 floats, 4 more a channel) and 9 x
    Cout x 40 bf16 weights, under a block's 232,448, one block an SM; the
    ring's note names B3 beside the figures."""
    note = (CSRC / "bf16_ring.cuh").read_text().split("#pragma once")[0]
    stated = note[note.index("B2, B5 and B3"):]
    for cout in (64, 32, 16, 8):
        rows = 8 if cout == 64 else 16
        want = 4 * 2 * (32 * ((rows + 2) * 40 + 4) + 9 * cout * 20)
        assert tpk.bf16_ring_bytes(cout) == want <= tpk.SMEM_PER_BLOCK
        assert tpk.ring_blocks_per_sm(want) == 1
        assert f"{want:,}" in stated


@pytest.mark.parametrize("mode,emit_uint8", [("default", False), ("default", True),
                                             ("mid", False), ("mid", True)])
def test_ragged_twin_matches_pallas(mode, emit_uint8):
    """The twin at C = 40 (a chunk of 32 and a partial one of 8) against the
    JAX kernel ("default" against its "emulate_bf16": JAX's own "default" is
    exact fp32 on the CPU), with tests/test_torch_grades.py's and
    tests/test_torch_mid.py's tolerances: "default" fp32 RGB 2e-5 on all but
    2% of values and 2e-2 on the rest (a feature on a bf16 boundary), "mid"
    2e-5 of the largest entry; uint8 +-1 on 0.5% of bytes."""
    b, c, cout, h, w, p = 1, 40, 8, 16, 32, 2
    x, wgt, bias = _rand((b, h, w, c), 80), _rand((3, 3, c, cout), 81, 0.1), _rand((cout,), 82)
    rgb_w, rgb_b = _rand((cout, 3), 83, 0.3), _rand((3,), 84)
    prev = _rand((b, h // 2, w // 2, 3), 85)
    prev8 = np.pad(prev, ((0, 0), (0, 0), (0, 0), (0, 5)))
    alpha = 1.0 if emit_uint8 else 0.3
    want = pk.packed_conv_rgb(
        _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias), jnp.asarray(rgb_w),
        jnp.asarray(rgb_b), _phase_blocked(prev8, p // 2), jnp.float32(alpha), p,
        mode={"default": "emulate_bf16", "mid": "mid"}[mode], interpret=True,
        emit_uint8=emit_uint8)
    want = np.asarray(pk.packed_u32_to_nhwc_uint8(want, p) if emit_uint8
                      else pk.packed_rgb_to_nhwc(want, p))
    got = tpk.packed_conv_rgb(
        _nchw(x), _oihw(wgt), torch.from_numpy(bias), torch.from_numpy(rgb_w.T.copy()),
        torch.from_numpy(rgb_b), _nchw(prev), alpha, emit_uint8=emit_uint8, mode=mode).numpy()
    assert got.shape == want.shape == (b, h, w, 3)
    if emit_uint8:
        _assert_uint8_close(got, want, 5e-3)
    elif mode == "mid":
        assert np.abs(got - want).max() <= REL * np.abs(want).max()
    else:
        d = np.abs(got - want)
        assert np.mean(d > 2e-5) <= 0.02 and d.max() <= 2e-2, (np.mean(d > 2e-5), d.max())
    fp32 = tpk.packed_conv_rgb(
        _nchw(x), _oihw(wgt), torch.from_numpy(bias), torch.from_numpy(rgb_w.T.copy()),
        torch.from_numpy(rgb_b), _nchw(prev), alpha, emit_uint8=emit_uint8).numpy()
    assert not np.array_equal(got, fp32)  # not the fp32 grade
