// rank_scores: L2-normalize the queries and write their cosine scores
// against a pre-normalized entity table, [B, N] fp32, fp32 by accuracy.
//
// Replaces probgan_tpu/ops/pallas_rank.py:52 `_rank_scores_pallas` (kernel
// `_rank_kernel`), reached through `rank_scores_fused`: the path of
// predict_tails and find_similar_entities for top_k > 16, where the fused
// top-k kernel does not apply. Any B >= 1, any N below 2^31 - 128 and any
// D % 4 == 0 up to 256 are taken; the TPU kernel's tiling gates are not kept.
//
// Grade: 3xTF32 on the tensor cores (rank_ring.cuh, tf32x3.cuh), within
// 2e-6 of the fp32 scores; every score is summed in one fixed order, the
// order of rank_topk.cu (B4), whose top k are this kernel's top k bit for bit.
//
// Bound on the H100 at B = 64, N = 1M, D = 128: 512 MB read + 256 MB written
// at 3.35 TB/s = 0.229 ms, bytes; the operations, 3 x 16.4 GFLOP of TF32 at
// 495 TFLOP/s, take 0.099 ms (as fp32 FMAs on the CUDA cores they took 0.245
// ms: the fp32 kernel this one replaces was bound by operations). At B = 8:
// (512 + 32) MB / 3.35 TB/s = 0.162 ms.
//
// Design against that bound: rank_ring.cuh's walk (a chunk of up to 64
// queries staged once, a contiguous run of table tiles streamed by bulk
// copies through a ring of stages, the 3xTF32 product, the tile's scores
// staged in the stage the tile came in, tiling from
// ops/rank_fused.py:scores_tiling: TR = 128 with S = 3, one block an SM, for
// B > 32 and D <= 128, where the product's share is largest; TR = 64 with
// S = 2 otherwise, which ran faster at B = 8 and slower at B = 64 on an
// H100). Its sink stores the staged scores: warp w takes queries w, w + 8,
// ..., each as coalesced 128-byte stores of 32 consecutive rows.
#include "rank_ring.cuh"

namespace probgan {

// Stores a tile's staged scores to out [B][n_rows].
template <int TR>
struct StoreScores {
  float* out;
  int n_rows, q0, nq, tile0;

  __device__ __forceinline__ void take(const float* stage, int it) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row0 = (tile0 + it) * TR;
    for (int ql = warp; ql < nq; ql += kScThreads / 32) {
      float* dst = out + static_cast<size_t>(q0 + ql) * n_rows + row0;
#pragma unroll
      for (int j = 0; j < TR / 32; ++j) {
        const int r = j * 32 + lane;
        if (row0 + r < n_rows) dst[r] = staged_score<TR>(stage, ql, r);
      }
    }
  }
};

template <int TR, int S>
__global__ void __launch_bounds__(kScThreads, TR == 64 ? 2 : 1)
    rank_scores_kernel(const float* __restrict__ pred, const float* __restrict__ table,
                       float* __restrict__ out, int B, int D, int n_rows, int normalize,
                       int tiles_per_block, int n_tiles) {
  extern __shared__ __align__(16) float sc_smem[];
  const int q0 = blockIdx.y * kScQ;
  const int tile0 = blockIdx.x * tiles_per_block;
  StoreScores<TR> sink{out, n_rows, q0, min(kScQ, B - q0), tile0};
  rank_ring_walk<TR, S>(sc_smem, pred, table, B, D, n_rows, normalize, q0, sink.nq, tile0,
                        min(tiles_per_block, n_tiles - tile0), sink);
}

template <int TR, int S>
int launch(const float* pred, const float* table, float* out, int B, int D, int n_rows,
           int normalize, int tiles_per_block, int n_blocks, cudaStream_t stream) {
  const size_t smem = scores_smem_bytes(D, TR, S);
  cudaError_t err = cudaFuncSetAttribute(rank_scores_kernel<TR, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (n_rows + TR - 1) / TR;
  const dim3 grid(n_blocks, (B + kScQ - 1) / kScQ);
  rank_scores_kernel<TR, S><<<grid, kScThreads, smem, stream>>>(
      pred, table, out, B, D, n_rows, normalize, tiles_per_block, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// pred [B][D] fp32 (raw with normalize = 1, else taken as it is), table
// [n_rows][D] fp32 with normalized rows, both 16-byte aligned -> out
// [B][n_rows] fp32 = normalize(pred) . table^T. D % 4 == 0 and D <= 256.
// The caller gives tiles of `tile_rows` rows (128, for D <= 128 only, or 64:
// ops/rank_fused.py:scores_tiling) with n_blocks * tiles_per_block *
// tile_rows >= n_rows and no block empty. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int probgan_rank_scores(const float* pred, const float* table, float* out, int B,
                                   int D, int n_rows, int normalize, int tile_rows,
                                   int tiles_per_block, int n_blocks, void* stream) {
  using namespace probgan;
  if (B < 1 || D < 4 || D % 4 || D > 256 || n_rows < 1 || tiles_per_block < 1 ||
      n_blocks < 1 || !ring_tiling_ok(tile_rows, D) ||
      static_cast<long long>(n_blocks - 1) * tiles_per_block * tile_rows >= n_rows ||
      static_cast<long long>(n_blocks) * tiles_per_block * tile_rows < n_rows ||
      B > 65535LL * kScQ)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile_rows == 128)
    return launch<128, 3>(pred, table, out, B, D, n_rows, normalize, tiles_per_block, n_blocks,
                          s);
  return launch<64, 2>(pred, table, out, B, D, n_rows, normalize, tiles_per_block, n_blocks, s);
}
