// The main loop of the fp32-grade rank kernels, rank_scores.cu (B7) and
// rank_topk.cu (B4): a block stages a chunk of up to 64 queries once and
// streams a contiguous run of table tiles through a ring of shared-memory
// stages filled by the Tensor Memory Accelerator's bulk copies, takes each
// tile's 3xTF32 product on the tensor cores and stages the tile's scores
// [64][TR + 20] in the stage the tile came in. What happens to the staged
// scores is the kernel's own (a Sink): B7 stores them, B4 selects its
// queries' top k from them. Then the stage takes the tile S places on.
//
// Grade: 3xTF32 (tf32x3.cuh). The products of a query and a table row are
// lo*hi + hi*lo + hi*hi of their TF32 parts, within ~2^-21 of each product;
// parts of two k8 steps (six mma) are added into the fp32 sums with a rounded
// add, and since the parts' magnitudes sum to at most 1 for unit vectors
// (Cauchy-Schwarz over the dimensions), the tensor cores' truncation adds up
// to well under 1e-6 of a score. Every score is summed in one fixed order
// whatever the tile, the tiling or the kernel: bit-equal table rows get
// bit-equal scores wherever they lie, and B4's scores are B7's, bit for bit.
//
// Two tilings, as the caller picks them (ops/rank_fused.py scores_tiling): TR = 128 rows a tile with S = 3 stages, one block an SM, for
// D <= 128; TR = 64 with S = 2 otherwise, two blocks an SM where D <= 128
// (one block's product overlaps the other's loads) and one above.
//  * The copies are bulk copies issued by one warp: a tile is 8 copies of
//    TR/8 consecutive rows, their bytes counted on one mbarrier a stage. So
//    the other warps never wait to issue loads: with cp.async (16 bytes a
//    thread) the same ring ran the product and the loads one after the
//    other, and one bulk copy a row (128 copies of 512 bytes a tile) was
//    slower still. A third stage keeps two tiles in flight beside a tile's
//    product and its scores' sink. Rows at or past the block's `n_rows` are
//    never read: the last tile of a ragged table is a short copy.
//  * Copy j lands at j * (TR/8 * D + 4) floats, unpadded inside: the mma's
//    A row g (and g + 8) is a row of copy g, so the 8 rows of a fragment
//    load lie 4 words apart in the banks and the loads are conflict-free.
//    m16 tile i takes rows 2i and 2i + 1 of each copy: A row m is tile row
//    TR/8 * (m % 8) + 2i + m / 8.
//  * 8 warps: warp (wq, wr) owns queries 32*wq .. +32 (four n8 tiles, skipped
//    past the batch) and m16 tiles wr*TR/64 .. (two or one); the table rows
//    are the mma's A operand, the queries its B, each split into hi and lo
//    as its fragment is loaded, and the three passes run over all the warp's
//    tiles in turn so that no mma waits on the one before it. K is the
//    feature dim padded with zeros to a multiple of 8 (for D % 8 == 4 the
//    last step's upper half is zeroed in registers).
//  * The tile's scores are staged [64][TR + 20] in the stage the tile came
//    in (row r at r + r / (TR/8): conflict-free writes from the fragments),
//    so a warp reads one query's 32 consecutive rows at a time.
//
// Shared memory: 64 x (Dp + 4) query floats + S stages of max(TR x D + 32,
// 64 x (TR + 20)) floats, Dp = D rounded up to 8: at D = 128 230,784 bytes
// (TR = 128) or 99,584 (TR = 64); 197,888 at D = 256.
#pragma once

#include "async_copy.cuh"
#include "rank_tile.cuh"
#include "tf32x3.cuh"

namespace probgan {

constexpr int kScQ = 64;  // queries per block chunk
constexpr int kScThreads = 256;

inline int scores_k(int D) { return (D + 7) & ~7; }

// A stage: the tile's 8 copies, or the tile's staged scores, whichever is
// larger (floats, a multiple of 4).
__host__ __device__ inline int scores_stage_floats(int D, int TR) {
  return TR * D + 32 > kScQ * (TR + 20) ? TR * D + 32 : kScQ * (TR + 20);
}

inline size_t scores_smem_bytes(int D, int TR, int S) {
  return static_cast<size_t>(kScQ * (scores_k(D) + 4) + S * scores_stage_floats(D, TR)) *
         sizeof(float);
}

// The tile rows the kernels are built for: 128 (3 stages) up to a padded D
// of 128, 64 (2 stages) at any D.
inline bool ring_tiling_ok(int tile_rows, int D) {
  return tile_rows == 64 || (tile_rows == 128 && scores_k(D) <= 128);
}

// Stage queries q0 .. q0 + 63 of pred [B][D] into qs [64][Dp + 4], with
// `normalize` L2-normalized as x / max(||x||, 1e-12) with IEEE sqrt and
// divide (a zero row stays zero), else as they are; rows past B and the
// columns D .. Dp - 1 are zero.
__device__ __forceinline__ void stage_queries(const float* __restrict__ pred, int B, int D,
                                              int Dp, int q0, int normalize, float* qs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = Dp + 4;
#pragma unroll
  for (int i = 0; i < kScQ / 8; ++i) {
    const int ql = warp * (kScQ / 8) + i;
    const int q = q0 + ql;
    float* dst = qs + ql * ld;
    if (q >= B) {  // warp-uniform
      for (int c = lane * 4; c < Dp; c += 128)
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
    for (int c = D + lane * 4; c < Dp; c += 128)
      *reinterpret_cast<float4*>(dst + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Start the copies of table rows row0 .. row0 + TR - 1 (those below n_rows)
// into stage ts: copy j, rows row0 + j*TR/8 .. +TR/8, at j * (TR/8 * D + 4)
// floats; their bytes are counted on `bar`. Called by one warp. Rows past
// n_rows keep what the stage held: their scores are never used.
template <int TR>
__device__ __forceinline__ void issue_table_tile(const float* __restrict__ table, int n_rows,
                                                 int D, int row0, float* ts,
                                                 unsigned long long* bar) {
  constexpr int kRpc = TR / 8;
  const int lane = threadIdx.x & 31;
  const unsigned row_bytes = static_cast<unsigned>(D) * sizeof(float);
  if (lane == 0) mbar_arrive_expect_tx(bar, min(TR, n_rows - row0) * row_bytes);
  __syncwarp();
  const int rows = min(kRpc, n_rows - (row0 + lane * kRpc));
  if (lane < 8 && rows > 0)
    bulk_copy_g2s(ts + lane * (kRpc * D + 4), table + static_cast<size_t>(row0 + lane * kRpc) * D,
                  rows * row_bytes, bar);
}

// One k8 step of a warp's [16*MT rows x 32 queries] tile into `part`: the
// fragments of table rows (A) and queries (B) split into hi and lo as they
// are loaded, then the three terms, small first, each over all the warp's
// tiles in turn so that no mma waits on the one before it. `zero_upper`: the
// step's columns 4..7 lie past D (D % 8 == 4), the next row's or beyond.
template <int MT>
__device__ __forceinline__ void score_step(const float* ta, const float* pb, int ld, int D,
                                           int k, int n_nt, bool zero_upper,
                                           float (&part)[MT][4][4]) {
  unsigned ah[MT][4], al[MT][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float* p = ta + 2 * mt * D + k;
    split_tf32(p[0], ah[mt][0], al[mt][0]);
    split_tf32(p[D], ah[mt][1], al[mt][1]);
    split_tf32(p[4], ah[mt][2], al[mt][2]);
    split_tf32(p[D + 4], ah[mt][3], al[mt][3]);
    if (zero_upper) ah[mt][2] = al[mt][2] = ah[mt][3] = al[mt][3] = 0u;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float* q = pb + nt * 8 * ld + k;
    split_tf32(q[0], bh[nt][0], bl[nt][0]);
    split_tf32(q[4], bh[nt][1], bl[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (nt < n_nt) mma_tf32(part[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (nt < n_nt) mma_tf32(part[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      if (nt < n_nt) mma_tf32(part[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
}

// Tile row r's score for chunk query ql in a stage of staged scores.
template <int TR>
__device__ __forceinline__ float staged_score(const float* stage, int ql, int r) {
  return stage[ql * (TR + 20) + r + r / (TR / 8)];
}

// The walk of one block over the chunk of queries q0 .. q0 + 63 (the first
// nq of them real) and the tiles tile0 .. tile0 + n_mine - 1 of the table's
// first n_rows rows. After each tile's scores are staged, every thread calls
// sink.take(stage, it) (tile tile0 + it; read them with staged_score);
// the stage is refilled only after every thread has returned.
template <int TR, int S, class Sink>
__device__ __forceinline__ void rank_ring_walk(float* smem, const float* __restrict__ pred,
                                               const float* __restrict__ table, int B, int D,
                                               int n_rows, int normalize, int q0, int nq,
                                               int tile0, int n_mine, Sink& sink) {
  constexpr int MT = TR / 64;   // m16 tiles per warp
  constexpr int kRpc = TR / 8;  // rows per copy
  constexpr int kSl = TR + 20;  // staged score row stride: 2*kSl is 8 mod 32
  __shared__ unsigned long long full[S];  // one phase per tile a stage receives
  const int Dp = (D + 7) & ~7;
  const int ld = Dp + 4;  // query rows, 4 mod 8: conflict-free fragment loads
  const int cps = kRpc * D + 4;  // copy stride
  const int stage_floats = scores_stage_floats(D, TR);
  float* qs = smem;
  float* ring = qs + kScQ * ld;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wq = warp & 1, wr = warp >> 1;
  const int n_nt = max(0, min(4, (nq - 32 * wq + 7) / 8));  // the warp's n8 tiles in the batch
  const int nk = Dp >> 3;
  const bool k_tail = (D & 7) != 0;  // the last k8 step's columns 4..7 lie past D

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    for (int s = 0; s < S && s < n_mine; ++s)
      issue_table_tile<TR>(table, n_rows, D, (tile0 + s) * TR, ring + s * stage_floats,
                           &full[s]);
  }
  stage_queries(pred, B, D, Dp, q0, normalize, qs);
  __syncthreads();

  // A: copy g, row 2i (+1 for the fragment's rows g + 8), k tig; B: query g, k tig
  const float* pa = ring + g * cps + 2 * (wr * MT) * D + tig;
  const float* pb = qs + (wq * 32 + g) * ld + tig;
  for (int it = 0; it < n_mine; ++it) {
    float* stage = ring + (it % S) * stage_floats;
    mbar_wait(&full[it % S], (it / S) & 1);  // tile `it` has landed
    float acc[MT][4][4], part[MT][4][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = part[mt][nt][e] = 0.f;
    const float* ta = pa + (it % S) * stage_floats;
    // a part is two k8 steps, added into acc after each pair
#pragma unroll 1
    for (int ks = 0; ks < nk && n_nt > 0; ks += 2) {
      score_step<MT>(ta, pb, ld, D, ks * 8, n_nt, k_tail && ks + 1 == nk, part);
      if (ks + 1 < nk)
        score_step<MT>(ta, pb, ld, D, ks * 8 + 8, n_nt, k_tail && ks + 2 == nk, part);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mt][nt][e] += part[mt][nt][e];
            part[mt][nt][e] = 0.f;
          }
    }
    __syncthreads();  // every warp has read the stage: it takes the scores
    // staged[query][r + r / kRpc] for tile row r: d[0] (A row g, query 2t),
    // d[1] (g, 2t + 1), d[2] (g + 8, 2t), d[3] (g + 8, 2t + 1); A row m of
    // m16 tile i is tile row kRpc * (m % 8) + 2i + m / 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int slot = (kRpc + 1) * g + 2 * (wr * MT + mt);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < n_nt) {
          float* s = stage + (wq * 32 + nt * 8 + 2 * tig) * kSl + slot;
          s[0] = acc[mt][nt][0];
          s[kSl] = acc[mt][nt][1];
          s[1] = acc[mt][nt][2];
          s[kSl + 1] = acc[mt][nt][3];
        }
      }
    }
    __syncthreads();  // the scores are staged
    sink.take(stage, it);
    fence_proxy_async_shared();
    __syncthreads();  // the sink has read the stage: it takes tile it + S
    if (warp == 0 && it + S < n_mine)
      issue_table_tile<TR>(table, n_rows, D, (tile0 + it + S) * TR, stage, &full[it % S]);
  }
}

}  // namespace probgan
