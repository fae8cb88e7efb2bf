// rank_topk: L2-normalize the queries, score them against a pre-normalized
// entity table in full fp32, and keep each query's top-k per block of table
// rows. The [B, N] score matrix never reaches device memory.
//
// Replaces probgan_tpu/ops/pallas_rank.py:261 `_rank_topk_pallas` (kernel
// `_rank_topk_kernel`), reached through `rank_topk_fused` and
// `rank_topk_local`. The contract is kept: rows at or past `nvalid` never
// win, values come in descending order and equal values in ascending id
// (what lax.top_k returns), 1 <= k <= 16. The TPU kernel's 2048-row tiles,
// 128-lane candidate padding and shape gates are not: any B >= 1, any
// number of rows and any D % 4 == 0 that fits shared memory are taken.
//
// Bound on the H100 at N = 1M, D = 128: 2*B*N*D FLOP at 67 TFLOP/s (fp32
// CUDA cores, no tensor cores at this grade) against the table's 512 MB
// read once at 3.35 TB/s = 0.153 ms. They cross near B = 40: B = 64 is bound
// by operations (0.245 ms), B = 8 by bytes.
//
// Design. Blocks run in no order, so nothing carries between them: each
// block owns a contiguous run of 128-row tiles (about two blocks per SM in
// one wave), streams them through shared memory and writes its own k
// candidates per query; the merge over [B, n_blocks * k] is a second pass
// outside the kernel. The query chunk (up to 64 x D) stays in shared memory
// for the whole run, so the table is read from device memory once per chunk
// of 64 queries. Within a block each query belongs to one warp, which keeps
// its running top-k sorted across lanes 0..k-1 in registers: a score enters
// only if it beats the current k-th value, which after the first tiles is
// rare (about k * ln(rows / k) insertions per query and block), so the
// steady state costs one compare and one ballot per 32 scores. Rows are
// visited in ascending id, so a later equal score never displaces an
// earlier one: that is the lowest-index tie-break.
#include "rank_tile.cuh"

namespace probgan {

constexpr int kMaxK = 16;

template <int QT>
__global__ void __launch_bounds__(kRankThreads, 2)
    rank_topk_kernel(const float* __restrict__ pred, const float* __restrict__ table,
                     float* __restrict__ cand_v, int* __restrict__ cand_i, int B, int D,
                     int nvalid, int k, int normalize, int tiles_per_block, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ts = smem + kRankWarps * QT * (D + kRowPad);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * (kRankWarps * QT);
  load_queries<QT>(pred, B, D, q0, normalize, qs);

  // Query i's running top-k: lane l < k holds entry l (descending value,
  // ascending id); thr[i] is entry k-1's value, the same in every lane.
  float ev[QT], thr[QT];
  int ei[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    ev[i] = -CUDART_INF_F;
    ei[i] = 0x7fffffff;
    thr[i] = -CUDART_INF_F;
  }
  const unsigned kmask = (k >= 32) ? kFullMask : ((1u << k) - 1u);

  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, n_tiles);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int row0 = tile * kTileRows;
    __syncthreads();  // the previous tile has been read (first pass: qs is written)
    load_table_tile(table, nvalid, D, row0, ts);
    __syncthreads();
    float acc[QT][kRowsPerLane];
    score_tile<QT>(qs, ts, D, acc);

#pragma unroll
    for (int i = 0; i < QT; ++i) {
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int row = row0 + j * 32 + lane;
        const float s = row < nvalid ? acc[i][j] : -CUDART_INF_F;
        unsigned m = __ballot_sync(kFullMask, s > thr[i]);
        while (m) {  // warp-uniform: candidates in ascending id
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const float v = __shfl_sync(kFullMask, s, src);
          if (!(v > thr[i])) continue;  // the threshold rose since the ballot
          const int id = row0 + j * 32 + src;
          const bool before = ev[i] > v || (ev[i] == v && ei[i] < id);
          const int pos = __popc(__ballot_sync(kFullMask, before) & kmask);
          const float up_v = __shfl_up_sync(kFullMask, ev[i], 1);
          const int up_i = __shfl_up_sync(kFullMask, ei[i], 1);
          if (lane > pos) {
            ev[i] = up_v;
            ei[i] = up_i;
          } else if (lane == pos) {
            ev[i] = v;
            ei[i] = id;
          }
          thr[i] = __shfl_sync(kFullMask, ev[i], k - 1);
        }
      }
    }
  }

  // cand [B][gridDim.x][k]: a query's candidates lie in ascending block
  // order, so position order is id order among equal values.
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const int q = q0 + warp * QT + i;
    if (q < B && lane < k) {
      const size_t o = (static_cast<size_t>(q) * gridDim.x + blockIdx.x) * k + lane;
      cand_v[o] = ev[i];
      cand_i[o] = ei[i];
    }
  }
}

template <int QT>
int launch(const float* pred, const float* table, float* cand_v, int* cand_i, int B, int D,
           int nvalid, int k, int normalize, int tiles_per_block, int n_blocks,
           cudaStream_t stream) {
  const size_t smem = rank_smem_bytes(QT, D);
  cudaError_t err = cudaFuncSetAttribute(rank_topk_kernel<QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (nvalid + kTileRows - 1) / kTileRows;
  const int chunk = kRankWarps * QT;
  const dim3 grid(n_blocks, (B + chunk - 1) / chunk);
  rank_topk_kernel<QT><<<grid, kRankThreads, smem, stream>>>(
      pred, table, cand_v, cand_i, B, D, nvalid, k, normalize, tiles_per_block, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// pred [B][D] fp32 (raw, or already normalized with normalize = 0),
// table [>= nvalid][D] fp32 with normalized rows
// -> cand_v, cand_i [B][n_blocks][k]: block b's top-k over table rows
// [b * tiles_per_block * 128, (b + 1) * tiles_per_block * 128) below nvalid,
// descending value / ascending id, padded with (-inf, INT_MAX). The caller
// gives n_blocks * tiles_per_block * 128 >= nvalid > (n_blocks - 1) *
// tiles_per_block * 128. Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_rank_topk(const float* pred, const float* table, float* cand_v,
                                 int* cand_i, int B, int D, int nvalid, int k, int normalize,
                                 int tiles_per_block, int n_blocks, void* stream) {
  using namespace probgan;
  if (B < 1 || D < 4 || D % 4 || nvalid < 1 || k < 1 || k > kMaxK || tiles_per_block < 1 ||
      n_blocks < 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rank_qt(B)) {
    case 8:
      return launch<8>(pred, table, cand_v, cand_i, B, D, nvalid, k, normalize, tiles_per_block,
                       n_blocks, s);
    case 4:
      return launch<4>(pred, table, cand_v, cand_i, B, D, nvalid, k, normalize, tiles_per_block,
                       n_blocks, s);
    case 2:
      return launch<2>(pred, table, cand_v, cand_i, B, D, nvalid, k, normalize, tiles_per_block,
                       n_blocks, s);
    default:
      return launch<1>(pred, table, cand_v, cand_i, B, D, nvalid, k, normalize, tiles_per_block,
                       n_blocks, s);
  }
}
