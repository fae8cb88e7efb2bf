// rank_topk_bf16: L2-normalize the queries in fp32, round them to bf16, score
// them against a bf16 copy of the pre-normalized entity table with one
// bf16 x bf16 product accumulated in fp32 on the tensor cores, and keep each
// query's best m rows by that approximate score per block of table rows. The
// caller merges the blocks' pools and rescores the m survivors exactly against
// the fp32 table (ops/rank_fused.py), so the approximate score only decides
// who is in the pool. The [B, N] scores never reach device memory.
//
// Replaces probgan_tpu/ops/pallas_rank.py:211 `_rank_topk_bf16_pallas` (kernel
// `_rank_topk_bf16_kernel`), reached through `rank_topk_fused(table_bf16=...)`.
// Kept of its contract: queries normalized in fp32 (eps 1e-12; off for
// pre-normalized queries) then cast to bf16, one low-precision product with
// fp32 accumulation, rows at or past `nvalid` never enter, an approximate
// pool that the fp32 rescore corrects. Not kept: the TPU's pool (the top 2 of
// each of 128 lane-stride classes per 2048-row tile, as sortable ints with
// the lane id in the low bits). Here a block's pool is the exact top-m by
// approximate score (m = k + 16 <= 32), which always contains what that pool
// would have to contain and has no per-class cap to lose a row to.
//
// Bound on the H100 at N = 1M, D = 128: bytes. The bf16 table is 256 MB, read
// once at 3.35 TB/s = 0.076 ms, against 2*B*N*D = 16.4 GFLOP at B = 64 over
// the tensor cores' 989 TFLOP/s = 0.017 ms. With fp32 FMAs on the CUDA cores
// the product alone would take 0.245 ms, so it runs as
// mma.sync.m16n8k16 (bf16 in, fp32 out) fed from shared memory.
//
// Design. As in rank_topk.cu each block owns a contiguous run of 128-row
// tiles and writes its own pool per query. Per tile: the 256 threads stage
// 128 rows x D bf16 (16-byte loads; rows padded by 16 bytes so the 32-bit
// fragment loads of a warp hit 32 distinct banks); warp w multiplies table
// rows 16w..16w+15 (the m16 side) by all of the chunk's queries (8 per n8
// tile, NT tiles), reading both fragments as 32-bit words of two consecutive
// bf16; the warp writes its 16 x 8*NT scores to a [query][row] fp32 array in
// shared memory; after a barrier warp w owns queries w*NT.. and walks their
// 128 scores 32 at a time, inserting into a sorted list held one entry per
// lane, exactly as rank_topk.cu does for k entries: a score enters only if
// it beats the m-th value, rows come in ascending id, so equal approximate
// scores keep the lowest ids. The round trip of the scores through shared
// memory (32 KB per tile at 64 queries) decouples the tensor cores' fragment
// layout from the selection's one-row-per-lane layout; it is the price of
// the simple version.
#include <cuda_bf16.h>

#include "rank_tile.cuh"

namespace probgan {

constexpr int kMaxPool = 32;   // one pool entry per lane
constexpr int kBf16Pad = 8;    // bf16 of padding per shared row: 16 bytes
constexpr int kScorePad = 4;   // floats of padding per row of the score array

inline size_t rank_bf16_smem_bytes(int nt, int D) {
  return static_cast<size_t>(kRankWarps * nt + kTileRows) * (D + kBf16Pad) * sizeof(__nv_bfloat16) +
         static_cast<size_t>(kRankWarps * nt) * (kTileRows + kScorePad) * sizeof(float);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo: the lower address
  return *reinterpret_cast<const unsigned*>(&p);
}

// Stage queries q0 .. q0 + 8*NT - 1 of pred [B][D] into qs [8*NT][D + pad]
// as bf16(x / max(||x||, 1e-12)) (the division only with `normalize`); rows
// past B are zero.
template <int NT>
__device__ __forceinline__ void load_queries_bf16(const float* __restrict__ pred, int B, int D,
                                                  int q0, int normalize, __nv_bfloat16* qs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = D + kBf16Pad;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int ql = warp * NT + i;
    const int q = q0 + ql;
    __nv_bfloat16* dst = qs + ql * ld;
    if (q >= B) {  // warp-uniform
      for (int c = lane * 4; c < D; c += 128) *reinterpret_cast<uint2*>(dst + c) = make_uint2(0u, 0u);
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
      *reinterpret_cast<uint2*>(dst + c) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  }
}

// Stage table rows row0 .. row0 + 127 of table [n_rows][D] (bf16) into
// ts [128][D + pad]; rows at or past n_rows are zero.
__device__ __forceinline__ void load_table_tile_bf16(const __nv_bfloat16* __restrict__ table,
                                                     int n_rows, int D, int row0,
                                                     __nv_bfloat16* ts) {
  const int ld = D + kBf16Pad;
  const int d8 = D >> 3;
  for (int idx = threadIdx.x; idx < kTileRows * d8; idx += kRankThreads) {
    const int r = idx / d8;
    const int c = (idx - r * d8) << 3;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows)
      v = __ldg(reinterpret_cast<const uint4*>(table + static_cast<size_t>(row) * D + c));
    *reinterpret_cast<uint4*>(ts + r * ld + c) = v;
  }
}

// D (16x8, fp32) += A (16x16, bf16, row-major) * B (16x8, bf16, k contiguous per column).
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(kRankThreads, 2)
    rank_topk_bf16_kernel(const float* __restrict__ pred, const __nv_bfloat16* __restrict__ table,
                          float* __restrict__ cand_v, int* __restrict__ cand_i, int B, int D,
                          int nvalid, int m, int normalize, int tiles_per_block, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NQ = kRankWarps * NT;  // queries of the block's chunk
  const int ld = D + kBf16Pad;
  constexpr int lds = kTileRows + kScorePad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ts = qs + NQ * ld;
  float* ss = reinterpret_cast<float*>(ts + kTileRows * ld);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the mma fragments' row group and thread in group
  const int q0 = blockIdx.y * NQ;
  load_queries_bf16<NT>(pred, B, D, q0, normalize, qs);

  // Query i's running pool: lane l < m holds entry l (descending approximate
  // score, ascending id); thr[i] is entry m-1's score, the same in every lane.
  float ev[NT], thr[NT];
  int ei[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    ev[i] = -CUDART_INF_F;
    ei[i] = 0x7fffffff;
    thr[i] = -CUDART_INF_F;
  }
  const unsigned mmask = (m >= 32) ? kFullMask : ((1u << m) - 1u);

  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, n_tiles);
  for (int tile = tile0; tile < tile1; ++tile) {
    const int row0 = tile * kTileRows;
    __syncthreads();  // the previous tile's rows and scores have been read (first pass: qs is written)
    load_table_tile_bf16(table, nvalid, D, row0, ts);
    __syncthreads();

    // acc[nt]: rows 16*warp + g (+8), queries 8*nt + 2*tig (+1)
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    const __nv_bfloat16* ta = ts + (16 * warp + g) * ld + 2 * tig;
    const __nv_bfloat16* qb = qs + g * ld + 2 * tig;
    for (int kk = 0; kk < D; kk += 16) {
      unsigned a[4];
      a[0] = *reinterpret_cast<const unsigned*>(ta + kk);
      a[1] = *reinterpret_cast<const unsigned*>(ta + 8 * ld + kk);
      a[2] = *reinterpret_cast<const unsigned*>(ta + kk + 8);
      a[3] = *reinterpret_cast<const unsigned*>(ta + 8 * ld + kk + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* qp = qb + nt * 8 * ld + kk;
        mma_bf16_16816(acc[nt], a, *reinterpret_cast<const unsigned*>(qp),
                       *reinterpret_cast<const unsigned*>(qp + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* sp = ss + (8 * nt + 2 * tig) * lds + 16 * warp + g;
      sp[0] = acc[nt][0];
      sp[lds] = acc[nt][1];
      sp[8] = acc[nt][2];
      sp[lds + 8] = acc[nt][3];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float* srow = ss + (warp * NT + i) * lds;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int row = row0 + j * 32 + lane;
        const float s = row < nvalid ? srow[j * 32 + lane] : -CUDART_INF_F;
        unsigned bal = __ballot_sync(kFullMask, s > thr[i]);
        while (bal) {  // warp-uniform: candidates in ascending id
          const int src = __ffs(bal) - 1;
          bal &= bal - 1;
          const float v = __shfl_sync(kFullMask, s, src);
          if (!(v > thr[i])) continue;  // the threshold rose since the ballot
          const int id = row0 + j * 32 + src;
          const bool before = ev[i] > v || (ev[i] == v && ei[i] < id);
          const int pos = __popc(__ballot_sync(kFullMask, before) & mmask);
          const float up_v = __shfl_up_sync(kFullMask, ev[i], 1);
          const int up_i = __shfl_up_sync(kFullMask, ei[i], 1);
          if (lane > pos) {
            ev[i] = up_v;
            ei[i] = up_i;
          } else if (lane == pos) {
            ev[i] = v;
            ei[i] = id;
          }
          thr[i] = __shfl_sync(kFullMask, ev[i], m - 1);
        }
      }
    }
  }

  // cand [B][gridDim.x][m]: a query's pools lie in ascending block order.
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int q = q0 + warp * NT + i;
    if (q < B && lane < m) {
      const size_t o = (static_cast<size_t>(q) * gridDim.x + blockIdx.x) * m + lane;
      cand_v[o] = ev[i];
      cand_i[o] = ei[i];
    }
  }
}

template <int NT>
int launch(const float* pred, const __nv_bfloat16* table, float* cand_v, int* cand_i, int B, int D,
           int nvalid, int m, int normalize, int tiles_per_block, int n_blocks,
           cudaStream_t stream) {
  const size_t smem = rank_bf16_smem_bytes(NT, D);
  cudaError_t err = cudaFuncSetAttribute(rank_topk_bf16_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (nvalid + kTileRows - 1) / kTileRows;
  const int chunk = kRankWarps * NT;
  const dim3 grid(n_blocks, (B + chunk - 1) / chunk);
  rank_topk_bf16_kernel<NT><<<grid, kRankThreads, smem, stream>>>(
      pred, table, cand_v, cand_i, B, D, nvalid, m, normalize, tiles_per_block, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// pred [B][D] fp32 (raw, or already normalized with normalize = 0),
// table [>= nvalid][D] bf16 with normalized rows
// -> cand_v, cand_i [B][n_blocks][m]: block b's best m rows by approximate
// score over table rows [b * tiles_per_block * 128, (b + 1) * tiles_per_block
// * 128) below nvalid, descending score / ascending id, padded with
// (-inf, INT_MAX). D % 16 == 0, 1 <= m <= 32. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int probgan_rank_topk_bf16(const float* pred, const void* table, float* cand_v,
                                      int* cand_i, int B, int D, int nvalid, int m, int normalize,
                                      int tiles_per_block, int n_blocks, void* stream) {
  using namespace probgan;
  if (B < 1 || D < 16 || D % 16 || nvalid < 1 || m < 1 || m > kMaxPool || tiles_per_block < 1 ||
      n_blocks < 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const __nv_bfloat16*>(table);
  switch (rank_qt(B)) {
    case 8:
      return launch<8>(pred, t, cand_v, cand_i, B, D, nvalid, m, normalize, tiles_per_block,
                       n_blocks, s);
    case 4:
      return launch<4>(pred, t, cand_v, cand_i, B, D, nvalid, m, normalize, tiles_per_block,
                       n_blocks, s);
    case 2:
      return launch<2>(pred, t, cand_v, cand_i, B, D, nvalid, m, normalize, tiles_per_block,
                       n_blocks, s);
    default:
      return launch<1>(pred, t, cand_v, cand_i, B, D, nvalid, m, normalize, tiles_per_block,
                       n_blocks, s);
  }
}
