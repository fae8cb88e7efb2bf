"""The fused rank kernels: Python side.

The counterpart of ``probgan_tpu/ops/pallas_rank.py``. Three kernels written
by hand in CUDA C++ for Hopper (``csrc/rank_topk.cu`` and
``csrc/rank_scores.cu`` over one main loop, ``csrc/rank_ring.cuh``, and
``csrc/rank_topk_bf16.cu``) keep the JAX names of the functions that reach
the Pallas kernels they replace:

- ``rank_topk_fused(pred, table_norm, k, num_entities)``: L2-normalize the
  raw predictions, score them against the pre-normalized entity table at
  the fp32 grade (3xTF32 on the tensor cores: three TF32 products of the
  operands' high and low parts, within 2e-6 of the plain twin) and return
  each query's top-k ``(values, ids)``. The [B, N] score matrix never
  reaches device memory: the kernel writes k candidates per query and block
  of table rows, and the merge over ``[B, n_blocks * k]`` is a stable sort
  here. Its scores are ``rank_scores_fused``'s bit for bit, so its result
  is ``top_k_lowest_index(rank_scores_fused(pred, table_norm)[:, :n], k)``.
  With ``table_bf16`` (a bf16
  copy of the table) one call launches two kernels instead: the stream,
  which reads that copy, half the bytes, multiplies in bf16 on the tensor
  cores and keeps an approximate pool of ``k + 16`` rows per query and block,
  and the merge, which picks each query's best ``k + 16`` and rescores them
  exactly against the fp32 table, so ids and values are those of the fp32
  path;
- ``rank_topk_local(pred_norm, table_norm_shard, k, nvalid)``: the same for
  queries that are already normalized, with local row ids (the per-shard
  form of a row-sharded table, ``parallel/sharded_rank.py``). It takes any
  ``nvalid`` from 0 to the shard's rows: where fewer than k rows are valid,
  the places past ``nvalid`` hold -inf with id 0, as the JAX kernel gives;
- ``rank_scores_fused(pred, table_norm)``: normalize + all cosine scores
  [B, N], the path for k > 16, with the same 3xTF32 products;
- ``rank_topk(pred, table_norm, k, nvalid)``: the route over the three, for
  the engine's whole table and for a shard of it.

Results are what ``lax.top_k(where(iota < nvalid, scores, -inf), k)``
returns: descending values and, among equal values, ascending ids. The
kernel sums the D terms of a dot in another order than ``torch.matmul``, so
values differ from the plain twins by about 1 ulp (compare at atol 2e-6) and
two distinct rows within that of each other may swap; bit-equal scores
(duplicate rows) always come in ascending id.

Each wrapper checks dtype, shape, contiguity and alignment and raises
``ValueError`` on what the kernels do not take (any B >= 1, any number of
rows below 2**31 - 128, D a multiple of 4 up to ``MAX_D``, k in 1..16; the
bf16 stream needs D a multiple of 16). It takes its plain
twin (``*_plain``) only for CPU tensors; for a CUDA tensor it launches the
kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from probgan_tpu_torch.ops import _build
from probgan_tpu_torch.ops.rank import (
    cosine_scores,
    l2_normalize,
    top_k_lowest_index,
)

# Launches of each kernel since the last reset_launches(); a wrapper adds one
# where it launches its kernel and nowhere else.
launches = {"rank_topk": 0, "rank_scores": 0, "rank_topk_bf16": 0}

MAX_K = 16          # csrc/rank_topk.cu kMaxK: a query's top-k lives in one warp
MAX_D = 256         # a 64-query chunk + the ring's stages fit 227 KB of shared memory
TILE_ROWS = 128     # the largest table tile of the kernels (csrc/rank_tile.cuh kTileRows)
BF16_BLOCKS_PER_SM = 1  # the bf16 stream's ring of table tiles fills an SM's shared memory
_MAX_ROWS = 2**31 - TILE_ROWS  # row ids and tile starts are int32 in the kernel
# The bf16 stream: rows kept beyond k for the exact rescore, and the table
# size from which an engine streams bf16 at all (below it the table read is
# cheap and the approximate pool has less room for near-ties).
BF16_RESCORE_POOL = 16
BF16_MIN_N = 200_000

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "rank_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rank_scores": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "rank_topk_bf16": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P],
}
# The parts of a rank_topk_bf16 launch: the stream, the merge and rescore.
_STREAM, _MERGE = 1, 2


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def supports(pred_shape: tuple[int, int], n: int) -> bool:
    """Shapes the kernels take: any batch, any table below 2**31 - 128 rows,
    a feature dim that is a multiple of 4 (16-byte loads) up to ``MAX_D``."""
    b, d = pred_shape
    return b >= 1 and 1 <= n < _MAX_ROWS and d % 4 == 0 and 4 <= d <= MAX_D


def supports_topk(pred_shape: tuple[int, int], n: int, k: int) -> bool:
    """``supports`` plus the fused top-k's bound on k."""
    return supports(pred_shape, n) and 1 <= k <= MAX_K


def supports_topk_bf16(pred_shape: tuple[int, int], n: int, k: int) -> bool:
    """``supports_topk`` plus the bf16 stream's feature dim: whole k16 steps
    of the tensor-core product."""
    return supports_topk(pred_shape, n, k) and pred_shape[1] % 16 == 0


def _check(name: str, pred: torch.Tensor, table: torch.Tensor) -> None:
    for label, t in (("pred", pred), ("table", table)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{name}: {label} must be a contiguous 2-d float32 tensor, got "
                f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
            )
        if t.is_cuda and t.data_ptr() % 16:  # the kernels load 16 bytes at a time
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    if pred.device != table.device:
        raise ValueError(f"{name}: pred on {pred.device}, table on {table.device}")
    if pred.shape[1] != table.shape[1]:
        raise ValueError(
            f"{name}: feature dims differ: pred {tuple(pred.shape)}, table "
            f"{tuple(table.shape)}"
        )
    if not supports(tuple(pred.shape), table.shape[0]):
        raise ValueError(
            f"{name}: pred {tuple(pred.shape)} x table {tuple(table.shape)} "
            f"needs B >= 1, 1 <= N < 2**31 - {TILE_ROWS}, D % 4 == 0 and "
            f"D <= {MAX_D}"
        )
    if pred.device.type not in ("cpu", "cuda"):
        raise RuntimeError(
            f"{name}: tensors on {pred.device.type!r} are not supported; the "
            "kernel runs on CUDA and its plain twin on the CPU"
        )


def _check_k(name: str, k: int, nvalid: int, n_rows: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} must be in 1..{MAX_K}")
    if not k <= nvalid <= n_rows:
        raise ValueError(
            f"{name}: need k <= nvalid <= table rows, got k={k}, "
            f"nvalid={nvalid}, rows={n_rows}"
        )


def _check_local_k(name: str, k: int, nvalid: int, n_rows: int) -> None:
    """A shard's bounds: k up to its rows, any nvalid from 0 to its rows."""
    if not 1 <= k <= min(MAX_K, n_rows):
        raise ValueError(f"{name}: k={k} must be in 1..min({MAX_K}, rows={n_rows})")
    if not 0 <= nvalid <= n_rows:
        raise ValueError(f"{name}: need 0 <= nvalid <= table rows, got nvalid={nvalid}, "
                         f"rows={n_rows}")


def tile_runs(n_rows: int, tile_rows: int, max_blocks: int) -> tuple[int, int]:
    """(tiles per block, blocks) that cover ``n_rows`` in contiguous runs of
    ``tile_rows``-row tiles, at most ``max_blocks`` blocks and none empty."""
    if n_rows < 1:
        raise ValueError(f"tile_runs: no rows to cover (n_rows={n_rows})")
    n_tiles = -(-n_rows // tile_rows)
    tiles_per_block = -(-n_tiles // min(n_tiles, max_blocks))
    return tiles_per_block, -(-n_tiles // tiles_per_block)


def _geometry(n_rows: int, device: torch.device, blocks_per_sm: int,
              tile_rows: int = TILE_ROWS) -> tuple[int, int]:
    """``tile_runs`` with about ``blocks_per_sm`` blocks per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return tile_runs(n_rows, tile_rows, blocks_per_sm * sms)


def scores_k(d: int) -> int:
    """rank_scores' K: the feature dim padded with zeros to whole k8 steps of
    the tensor-core product."""
    return -(-d // 8) * 8


def scores_tiling(b: int, d: int) -> tuple[int, int]:
    """(table rows per tile, blocks per SM) of csrc/rank_scores.cu and
    csrc/rank_topk.cu, which launch the tiling they are given on one walk
    (csrc/rank_ring.cuh; the tiling changes the launch, never a score's
    bits): 128-row tiles in a ring of 3, one block an SM, for more than 32
    queries with a padded D up to 128; else 64-row tiles in a ring of 2, two
    blocks an SM while D allows (one block's product overlaps the other's
    loads), one above."""
    if scores_k(d) > 128:
        return 64, 1
    return (128, 1) if b > 32 else (64, 2)


def _launch(name: str, x: torch.Tensor, *args) -> None:
    _build.launch(name, _ARGTYPES[name], x.device, *args)
    launches[name] += 1


def topk_candidates(pred: torch.Tensor, table: torch.Tensor, k: int, nvalid: int,
                    normalize: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the rank_topk kernel: (values fp32, ids int32), each
    [B, n_blocks * k]. A query's candidates come block by block in ascending
    row ranges, each block's in descending value / ascending id, padded with
    (-inf, INT32_MAX) where a block has fewer than k valid rows."""
    b, d = pred.shape
    tile_rows, blocks_per_sm = scores_tiling(b, d)
    tiles_per_block, n_blocks = _geometry(nvalid, pred.device, blocks_per_sm, tile_rows)
    cand_v = torch.empty((b, n_blocks * k), device=pred.device, dtype=torch.float32)
    cand_i = torch.empty((b, n_blocks * k), device=pred.device, dtype=torch.int32)
    _launch("rank_topk", pred, pred.data_ptr(), table.data_ptr(), cand_v.data_ptr(),
            cand_i.data_ptr(), b, d, nvalid, k, int(normalize), tile_rows,
            tiles_per_block, n_blocks)
    return cand_v, cand_i


def _check_bf16(name: str, pred: torch.Tensor, table_norm: torch.Tensor,
                table_bf16: torch.Tensor, k: int) -> None:
    if table_bf16.dtype != torch.bfloat16 or not table_bf16.is_contiguous():
        raise ValueError(
            f"{name}: table_bf16 must be a contiguous bfloat16 tensor, got "
            f"{table_bf16.dtype} contiguous={table_bf16.is_contiguous()}"
        )
    if table_bf16.shape != table_norm.shape or table_bf16.device != table_norm.device:
        raise ValueError(
            f"{name}: table_bf16 {tuple(table_bf16.shape)} on {table_bf16.device} "
            f"must mirror table_norm {tuple(table_norm.shape)} on {table_norm.device}"
        )
    if table_bf16.is_cuda and table_bf16.data_ptr() % 16:
        raise ValueError(f"{name}: table_bf16 must be 16-byte aligned")
    if not supports_topk_bf16(tuple(pred.shape), table_norm.shape[0], k):
        raise ValueError(
            f"{name}: the bf16 stream needs D % 16 == 0, got D={pred.shape[1]}"
        )


def _launch_bf16(pred, table_bf16, table_norm, cand_v, cand_i, out_v, out_i, k, m,
                 nvalid, normalize, n_blocks, tiles_per_block, parts):
    _launch("rank_topk_bf16", pred, pred.data_ptr(), table_bf16.data_ptr(),
            table_norm.data_ptr(), cand_v.data_ptr(), cand_i.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), pred.shape[0], pred.shape[1], nvalid, m, k, int(normalize),
            tiles_per_block, n_blocks, parts)


def _bf16_buffers(b, k, m, n_blocks, device):
    return (torch.empty((b, n_blocks * m), device=device, dtype=torch.float32),
            torch.empty((b, n_blocks * m), device=device, dtype=torch.int32),
            torch.empty((b, k), device=device, dtype=torch.float32),
            torch.empty((b, k), device=device, dtype=torch.int64))


def pool_candidates_bf16(pred: torch.Tensor, table_bf16: torch.Tensor, m: int,
                         nvalid: int, normalize: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the rank_topk_bf16 stream alone: (approximate scores fp32, ids
    int32), each [B, n_blocks * m], laid out as ``topk_candidates``' result
    (one block per SM)."""
    tiles_per_block, n_blocks = _geometry(nvalid, pred.device, BF16_BLOCKS_PER_SM)
    cand_v, cand_i, out_v, out_i = _bf16_buffers(pred.shape[0], 1, m, n_blocks, pred.device)
    _launch_bf16(pred, table_bf16, pred, cand_v, cand_i, out_v, out_i, 1, m, nvalid,
                 normalize, n_blocks, tiles_per_block, _STREAM)
    return cand_v, cand_i


def rescore_pool(pred_norm: torch.Tensor, table_norm: torch.Tensor,
                 pool_v: torch.Tensor, pool_ids: torch.Tensor,
                 k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact half of the bf16 path: score each query's pool of row ids
    [B, m] against the fp32 table and return the top-k by (-score, id), so
    exact duplicates resolve to the lowest id. A slot whose approximate score
    ``pool_v`` is -inf (a masked filler) stays at -inf."""
    valid = pool_v > float("-inf")
    ids = torch.where(valid, pool_ids.to(torch.int64), 0)
    rows = table_norm[ids]  # [B, m, D]: m rows per query, not the N-row stream
    exact = (rows * pred_norm[:, None, :]).sum(dim=-1)
    exact = torch.where(valid, exact, float("-inf"))
    ids, by_id = torch.sort(ids, dim=1, stable=True)
    values, pos = top_k_lowest_index(torch.gather(exact, 1, by_id), k)
    return values, torch.gather(ids, 1, pos)


def merge_rescore_bf16_plain(cand_v, cand_i, pred, table_norm, k, m):
    """Plain twin of the merge kernel: the best ``m`` of each query's
    candidates [B, n_blocks * m] by (approximate score descending, position
    ascending), rescored exactly against ``table_norm`` with the raw ``pred``
    normalized in fp32 -> (values [B, k] fp32, ids [B, k] int64)."""
    pool_v, pos = top_k_lowest_index(cand_v, m)
    return rescore_pool(l2_normalize(pred), table_norm, pool_v,
                        torch.gather(cand_i, 1, pos), k)


def merge_rescore_bf16(cand_v: torch.Tensor, cand_i: torch.Tensor, pred: torch.Tensor,
                       table_norm: torch.Tensor, k: int, m: int,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the rank_topk_bf16 merge and rescore alone on candidates laid
    out as ``pool_candidates_bf16``' result; its plain twin on the CPU."""
    if pred.device.type == "cpu":
        return merge_rescore_bf16_plain(cand_v, cand_i, pred, table_norm, k, m)
    _check("merge_rescore_bf16", pred, table_norm)
    b = pred.shape[0]
    n_blocks = cand_v.shape[1] // m
    if (cand_v.shape != (b, n_blocks * m) or cand_i.shape != cand_v.shape
            or cand_v.dtype != torch.float32 or cand_i.dtype != torch.int32
            or not (cand_v.is_contiguous() and cand_i.is_contiguous()) or not 1 <= k <= m):
        raise ValueError(f"merge_rescore_bf16: candidates {tuple(cand_v.shape)} / "
                         f"{tuple(cand_i.shape)} must be contiguous float32 / int32 "
                         f"[B, n_blocks * m] with 1 <= k <= m")
    out_v = torch.empty((b, k), device=pred.device, dtype=torch.float32)
    out_i = torch.empty((b, k), device=pred.device, dtype=torch.int64)
    _launch_bf16(pred, pred, table_norm, cand_v, cand_i, out_v, out_i, k, m,
                 table_norm.shape[0], True, n_blocks, 1, _MERGE)
    return out_v, out_i


def _topk_bf16_cuda(pred, table_norm, table_bf16, k, nvalid):
    """The stream and the merge in one call to the C entry (one launch
    counted): the pools go from one kernel to the next on the card."""
    m = min(k + BF16_RESCORE_POOL, nvalid)
    tiles_per_block, n_blocks = _geometry(nvalid, pred.device, BF16_BLOCKS_PER_SM)
    cand_v, cand_i, out_v, out_i = _bf16_buffers(pred.shape[0], k, m, n_blocks, pred.device)
    _launch_bf16(pred, table_bf16, table_norm, cand_v, cand_i, out_v, out_i, k, m, nvalid,
                 True, n_blocks, tiles_per_block, _STREAM | _MERGE)
    return out_v, out_i


def merge_candidates(cand_v: torch.Tensor, cand_i: torch.Tensor,
                     k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top k of ``topk_candidates``' result: (values [B, k], ids [B, k]
    int64). Equal values keep their position order under the stable sort,
    and position order is id order: the lowest id wins, as in the kernel."""
    values, pos = top_k_lowest_index(cand_v, k)
    return values, torch.gather(cand_i, 1, pos).to(torch.int64)


def _topk_cuda(pred, table, k, nvalid, normalize):
    return merge_candidates(*topk_candidates(pred, table, k, nvalid, normalize), k)


# ---------------------------------------------------------------------------
# rank_topk
# ---------------------------------------------------------------------------

def rank_topk_fused_plain(pred, table_norm, k, num_entities, *, table_bf16=None):
    """Plain twin of ``rank_topk_fused``: normalize, product, slice, top-k.
    With ``table_bf16``: fp32 normalize, queries rounded to bf16, the
    bf16 x bf16 products summed in fp32 (a product of two bf16 values is
    exact in fp32), the top k + 16 by that approximate score, then the
    exact rescore of ``merge_rescore_bf16_plain``."""
    pred_norm = l2_normalize(pred)
    if table_bf16 is None:
        return top_k_lowest_index(cosine_scores(pred_norm, table_norm)[:, :num_entities], k)
    approx = cosine_scores(pred_norm.to(torch.bfloat16).float(),
                           table_bf16[:num_entities].float())
    pool_v, pool_ids = top_k_lowest_index(approx, min(k + BF16_RESCORE_POOL, num_entities))
    return rescore_pool(pred_norm, table_norm, pool_v, pool_ids, k)


def rank_topk_fused(pred: torch.Tensor, table_norm: torch.Tensor, k: int,
                    num_entities: int, *,
                    table_bf16: torch.Tensor | None = None,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, D] raw predictions x [N_rows, D] pre-normalized table -> (top-k
    values [B, k] fp32, top-k entity ids [B, k] int64) over rows below
    ``num_entities`` (rows at or past it, such as zero padding, never win).

    ``table_bf16``: a cached bfloat16 copy of ``table_norm``. When given, the
    bf16 kernel streams it (half the bytes, one tensor-core product) and
    keeps each query's best ``k + 16`` rows by approximate score; that pool
    is rescored exactly against ``table_norm``, so the result matches the
    fp32 path's. A true top-k row is lost only if more than 16 rows outside
    the top k beat it in bf16 (each within ~2**-7 of it in exact score). Two
    distinct rows within 1 ulp of each other may come in either order; exact
    duplicates come in ascending id."""
    name = "rank_topk_fused"
    num_entities = int(num_entities)
    _check(name, pred, table_norm)
    _check_k(name, k, num_entities, table_norm.shape[0])
    if table_bf16 is not None:
        _check_bf16(name, pred, table_norm, table_bf16, k)
    if pred.device.type == "cpu":
        return rank_topk_fused_plain(pred, table_norm, k, num_entities,
                                     table_bf16=table_bf16)
    if table_bf16 is not None:
        return _topk_bf16_cuda(pred, table_norm, table_bf16, k, num_entities)
    return _topk_cuda(pred, table_norm, k, num_entities, normalize=True)


def _filler_ids(ids: torch.Tensor, nvalid: int) -> torch.Tensor:
    """Set the ids of the places past ``nvalid`` (the -inf fillers) to 0, as
    the JAX kernel leaves them."""
    if nvalid < ids.shape[1]:
        ids[:, nvalid:] = 0
    return ids


def rank_topk_local_plain(pred_norm, table_norm_shard, k, nvalid, *, normalize=False):
    """Plain twin of ``rank_topk_local``: rows at or past ``nvalid`` masked to
    -inf, the stable top k, the fillers' ids set to 0."""
    query = l2_normalize(pred_norm) if normalize else pred_norm
    scores = cosine_scores(query, table_norm_shard)
    rows = torch.arange(scores.shape[1], device=scores.device)
    values, ids = top_k_lowest_index(torch.where(rows < nvalid, scores, float("-inf")), k)
    return values, _filler_ids(ids, nvalid)


def rank_topk_local(pred_norm: torch.Tensor, table_norm_shard: torch.Tensor, k: int,
                    nvalid: int, *, normalize: bool = False,
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard fused rank + top-k: queries arrive already normalized (every
    shard must consume identical query bits) and are not normalized again;
    ``nvalid`` is the shard's count of real rows, any from 0 to its rows
    (the last shard of an uneven table holds fewer than k, a shard of
    padding none). Returns (values [B, k], local row ids [B, k] int64): the
    first min(k, nvalid) places are those of the masked scores; the rest
    are -inf with id 0, as the JAX kernel gives. At ``nvalid`` 0 there is
    nothing to rank: the fillers come back with no launch.

    ``normalize=True`` takes raw queries and normalizes them as
    ``rank_topk_fused`` does (in the kernel on the card), so a shard's
    scores are the one-card engine's bit for bit."""
    name = "rank_topk_local"
    nvalid = int(nvalid)
    _check(name, pred_norm, table_norm_shard)
    _check_local_k(name, k, nvalid, table_norm_shard.shape[0])
    if pred_norm.device.type == "cpu":
        return rank_topk_local_plain(pred_norm, table_norm_shard, k, nvalid,
                                     normalize=normalize)
    if nvalid == 0:
        b = pred_norm.shape[0]
        return (torch.full((b, k), float("-inf"), device=pred_norm.device),
                torch.zeros((b, k), dtype=torch.int64, device=pred_norm.device))
    values, ids = _topk_cuda(pred_norm, table_norm_shard, k, nvalid, normalize=normalize)
    return values, _filler_ids(ids, nvalid)


def rank_topk(pred: torch.Tensor, table_norm: torch.Tensor, k: int, nvalid: int, *,
              table_bf16: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, D] raw predictions x pre-normalized table -> the top k (values,
    ids) over rows below ``nvalid``: the route of the whole table on one
    device and of a shard of it alike. Within B4's bound on k
    (``supports_topk``) one fused rank + top-k: ``rank_topk_local``
    normalizing the queries in the kernel, or the bf16 stream with
    ``table_bf16``; above it B7's scores masked to -inf and the stable top k.
    The plain twins on the CPU. Where ``nvalid`` < k the places past it hold
    -inf."""
    if supports_topk(tuple(pred.shape), table_norm.shape[0], k):
        if table_bf16 is not None:
            return rank_topk_fused(pred, table_norm, k, nvalid, table_bf16=table_bf16)
        return rank_topk_local(pred, table_norm, k, nvalid, normalize=True)
    scores = rank_scores_fused(pred, table_norm)
    if nvalid < scores.shape[1]:
        rows = torch.arange(scores.shape[1], device=scores.device)
        scores = torch.where(rows < nvalid, scores, float("-inf"))
    return top_k_lowest_index(scores, k)


# ---------------------------------------------------------------------------
# rank_scores
# ---------------------------------------------------------------------------

def rank_scores_fused_plain(pred, table_norm):
    """Plain twin of ``rank_scores_fused``."""
    return cosine_scores(l2_normalize(pred), table_norm)


def rank_scores_fused(pred: torch.Tensor, table_norm: torch.Tensor) -> torch.Tensor:
    """[B, D] raw predictions x [N, D] pre-normalized table -> [B, N] cosine
    scores, fp32 (a zero prediction row gives zeros, not NaN). On the card
    the products are 3xTF32, summed in one fixed order: bit-equal table rows
    get bit-equal scores."""
    name = "rank_scores_fused"
    _check(name, pred, table_norm)
    if pred.device.type == "cpu":
        return rank_scores_fused_plain(pred, table_norm)
    out = torch.empty((pred.shape[0], table_norm.shape[0]), device=pred.device,
                      dtype=torch.float32)
    launch_rank_scores(pred, table_norm, out)
    return out


def launch_rank_scores(pred: torch.Tensor, table_norm: torch.Tensor, out: torch.Tensor, *,
                       normalize: bool = True) -> None:
    """Launch the rank_scores kernel into ``out`` [B, N] fp32 (contiguous, on
    the card): ``rank_scores_fused`` without its allocation. With
    ``normalize=False`` the queries are taken as they are (already
    normalized, as ``rank_topk_local`` takes them)."""
    _check("rank_scores", pred, table_norm)
    if pred.device.type != "cuda":
        raise RuntimeError("rank_scores: the kernel runs on CUDA tensors only")
    b, d = pred.shape
    n = table_norm.shape[0]
    if (out.shape != (b, n) or out.dtype != torch.float32 or not out.is_contiguous()
            or out.device != pred.device):
        raise ValueError(f"rank_scores: out must be a contiguous float32 {(b, n)} tensor "
                         f"on {pred.device}")
    tile_rows, blocks_per_sm = scores_tiling(b, d)
    tiles_per_block, n_blocks = _geometry(n, pred.device, blocks_per_sm, tile_rows)
    _launch("rank_scores", pred, pred.data_ptr(), table_norm.data_ptr(), out.data_ptr(),
            b, d, n, int(normalize), tile_rows, tiles_per_block, n_blocks)
