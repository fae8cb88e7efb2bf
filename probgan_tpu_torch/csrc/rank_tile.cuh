// Shared pieces of the fused rank kernels (rank_topk.cu; rank_scores.cu and
// rank_topk_bf16.cu take its constants): a block's query chunk and one tile
// of table rows in shared memory, and the fp32 product of the two on the
// CUDA cores.
//
// A block has 8 warps. Warp w owns QT queries of the block's chunk of 8*QT
// (QT in 1, 2, 4, 8, chosen from the batch size); lane l owns rows l, l+32,
// l+64, l+96 of the 128-row table tile. A thread therefore keeps QT x 4
// scores in registers, and each 16-byte step along D does QT + 4 shared
// loads (the query loads are warp-wide broadcasts) for 16*QT FMAs. Rows in
// shared memory are padded by 4 floats, so the 8 lanes that one 128-bit
// shared load serves together hit 32 distinct banks (for D % 8 == 0).
//
// The dot is full fp32: sequential FMAs over d = 0..D-1, no TF32, no tensor
// cores, no --use_fast_math (the -inf mask and the tie-break need IEEE
// compares; the normalization needs IEEE sqrt and divide).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace probgan {

constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kTileRows = 128;             // table rows per shared-memory tile
constexpr int kRowsPerLane = kTileRows / 32;
constexpr int kRowPad = 4;                 // floats of padding per shared row
constexpr float kNormEps = 1e-12f;         // F.normalize's denominator clamp
constexpr unsigned kFullMask = 0xffffffffu;

inline size_t rank_smem_bytes(int qt, int D) {
  return static_cast<size_t>(kRankWarps * qt + kTileRows) * (D + kRowPad) * sizeof(float);
}

// Queries per block chunk for a batch of B: the smallest QT whose chunk of
// 8*QT holds the batch, at most 8 (larger batches walk in chunks of 64).
inline int rank_qt(int B) { return B > 32 ? 8 : B > 16 ? 4 : B > 8 ? 2 : 1; }

// Stage queries q0 .. q0 + 8*QT - 1 of pred [B][D] into qs [8*QT][D + pad],
// L2-normalized as x / max(||x||, 1e-12) when `normalize` is set (a zero row
// stays zero). Rows past B are zero-filled.
template <int QT>
__device__ __forceinline__ void load_queries(const float* __restrict__ pred, int B, int D,
                                             int q0, int normalize, float* qs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = D + kRowPad;
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const int ql = warp * QT + i;
    const int q = q0 + ql;
    float* dst = qs + ql * ld;
    if (q >= B) {  // warp-uniform
      for (int c = lane * 4; c < D; c += 128)
        *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float* src = pred + static_cast<size_t>(q) * D;
    float denom = 1.f;
    if (normalize) {
      float ss = 0.f;
      for (int c = lane * 4; c < D; c += 128) {
        const float4 v = *reinterpret_cast<const float4*>(src + c);
        ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFullMask, ss, off);
      denom = fmaxf(sqrtf(ss), kNormEps);
    }
    for (int c = lane * 4; c < D; c += 128) {
      float4 v = *reinterpret_cast<const float4*>(src + c);
      if (normalize) {
        v.x /= denom;
        v.y /= denom;
        v.z /= denom;
        v.w /= denom;
      }
      *reinterpret_cast<float4*>(dst + c) = v;
    }
  }
}

// Stage table rows row0 .. row0 + 127 of table [n_rows][D] into
// ts [128][D + pad]; rows at or past n_rows are zero-filled.
__device__ __forceinline__ void load_table_tile(const float* __restrict__ table, int n_rows,
                                                int D, int row0, float* ts) {
  const int ld = D + kRowPad;
  const int d4 = D >> 2;
  for (int idx = threadIdx.x; idx < kTileRows * d4; idx += kRankThreads) {
    const int r = idx / d4;
    const int c = (idx - r * d4) << 2;
    const int row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows)
      v = __ldg(reinterpret_cast<const float4*>(table + static_cast<size_t>(row) * D + c));
    *reinterpret_cast<float4*>(ts + r * ld + c) = v;
  }
}

// acc[i][j] = <query warp*QT + i, tile row lane + 32*j>.
template <int QT>
__device__ __forceinline__ void score_tile(const float* qs, const float* ts, int D,
                                           float (&acc)[QT][kRowsPerLane]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = D + kRowPad;
  const float* qb = qs + warp * QT * ld;
  const float* tb = ts + lane * ld;
#pragma unroll
  for (int i = 0; i < QT; ++i)
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) acc[i][j] = 0.f;
#pragma unroll 1  // measured: unrolling this loop further is no faster
  for (int c = 0; c < D; c += 4) {
    float4 t[kRowsPerLane];
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j)
      t[j] = *reinterpret_cast<const float4*>(tb + j * 32 * ld + c);
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const float4 q = *reinterpret_cast<const float4*>(qb + i * ld + c);
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        float a = acc[i][j];
        a = fmaf(q.x, t[j].x, a);
        a = fmaf(q.y, t[j].y, a);
        a = fmaf(q.z, t[j].z, a);
        a = fmaf(q.w, t[j].w, a);
        acc[i][j] = a;
      }
    }
  }
}

}  // namespace probgan

extern "C" const char* probgan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
