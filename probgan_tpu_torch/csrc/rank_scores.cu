// rank_scores: L2-normalize the queries and write their cosine scores
// against a pre-normalized entity table, [B, N] fp32, in full fp32.
//
// Replaces probgan_tpu/ops/pallas_rank.py:52 `_rank_scores_pallas` (kernel
// `_rank_kernel`), reached through `rank_scores_fused`: the path of
// predict_tails and find_similar_entities for top_k > 16, where the fused
// top-k kernel does not apply. Any B >= 1, any N and any D % 4 == 0 that
// fits shared memory are taken; the TPU kernel's tiling gates are not kept.
//
// Bound on the H100 at B = 64, N = 1M, D = 128: 16.4 GFLOP at 67 TFLOP/s =
// 0.245 ms (fp32 CUDA cores) against 512 MB read + 256 MB written at
// 3.35 TB/s = 0.229 ms: operations, narrowly. Below B = 64 it is bytes.
//
// Design: the same block shape as rank_topk (rank_tile.cuh). A block owns a
// contiguous run of 128-row tiles and keeps its normalized query chunk in
// shared memory for the whole run, so the queries are normalized once per
// block and the table is read once per chunk of 64 queries. Lanes own
// consecutive rows, so each (query, 32 rows) group is one coalesced 128-byte
// store.
#include "rank_tile.cuh"

namespace probgan {

template <int QT>
__global__ void __launch_bounds__(kRankThreads, 2)
    rank_scores_kernel(const float* __restrict__ pred, const float* __restrict__ table,
                       float* __restrict__ out, int B, int D, int n_rows, int tiles_per_block,
                       int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ts = smem + kRankWarps * QT * (D + kRowPad);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * (kRankWarps * QT);
  load_queries<QT>(pred, B, D, q0, 1, qs);

  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, n_tiles);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int row0 = tile * kTileRows;
    __syncthreads();  // the previous tile has been read (first pass: qs is written)
    load_table_tile(table, n_rows, D, row0, ts);
    __syncthreads();
    float acc[QT][kRowsPerLane];
    score_tile<QT>(qs, ts, D, acc);
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const int q = q0 + warp * QT + i;
      if (q >= B) continue;
      float* dst = out + static_cast<size_t>(q) * n_rows;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int row = row0 + j * 32 + lane;
        if (row < n_rows) dst[row] = acc[i][j];
      }
    }
  }
}

template <int QT>
int launch(const float* pred, const float* table, float* out, int B, int D, int n_rows,
           int tiles_per_block, int n_blocks, cudaStream_t stream) {
  const size_t smem = rank_smem_bytes(QT, D);
  cudaError_t err = cudaFuncSetAttribute(rank_scores_kernel<QT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  const int chunk = kRankWarps * QT;
  const dim3 grid(n_blocks, (B + chunk - 1) / chunk);
  rank_scores_kernel<QT><<<grid, kRankThreads, smem, stream>>>(pred, table, out, B, D, n_rows,
                                                              tiles_per_block, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// pred [B][D] fp32 raw, table [n_rows][D] fp32 with normalized rows
// -> out [B][n_rows] fp32 = normalize(pred) . table^T. The caller gives
// n_blocks * tiles_per_block * 128 >= n_rows. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int probgan_rank_scores(const float* pred, const float* table, float* out, int B,
                                   int D, int n_rows, int tiles_per_block, int n_blocks,
                                   void* stream) {
  using namespace probgan;
  if (B < 1 || D < 4 || D % 4 || n_rows < 1 || tiles_per_block < 1 || n_blocks < 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rank_qt(B)) {
    case 8:
      return launch<8>(pred, table, out, B, D, n_rows, tiles_per_block, n_blocks, s);
    case 4:
      return launch<4>(pred, table, out, B, D, n_rows, tiles_per_block, n_blocks, s);
    case 2:
      return launch<2>(pred, table, out, B, D, n_rows, tiles_per_block, n_blocks, s);
    default:
      return launch<1>(pred, table, out, B, D, n_rows, tiles_per_block, n_blocks, s);
  }
}
