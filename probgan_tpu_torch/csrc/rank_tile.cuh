// Constants shared by the rank kernels (rank_topk_bf16.cu, and through
// rank_ring.cuh rank_scores.cu and rank_topk.cu): the bf16 stream's block
// shape (8 warps, 128-row table tiles, its query chunk per batch size) and
// the query normalization's clamp.
//
// Every kernel normalizes in IEEE fp32 (sqrt and divide, no
// --use_fast_math): the -inf mask and the tie-break need IEEE compares.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace probgan {

constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kTileRows = 128;             // table rows per tile of the bf16 stream
constexpr float kNormEps = 1e-12f;         // F.normalize's denominator clamp
constexpr unsigned kFullMask = 0xffffffffu;

// Queries per warp for a batch of B: the smallest QT whose chunk of 8*QT
// holds the batch, at most 8 (larger batches walk in chunks of 64).
inline int rank_qt(int B) { return B > 32 ? 8 : B > 16 ? 4 : B > 8 ? 2 : 1; }

}  // namespace probgan

extern "C" const char* probgan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
