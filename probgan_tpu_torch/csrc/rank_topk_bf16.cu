// rank_topk_bf16: the bf16 stream of the fused rank + top-k, in two kernels
// launched by one C entry.
//
//  1. The stream kernel L2-normalizes the queries in fp32, rounds them to
//     bf16, scores them against a bf16 copy of the pre-normalized entity
//     table with one bf16 x bf16 product accumulated in fp32 on the tensor
//     cores, and keeps each query's best m rows by that approximate score per
//     block of table rows. The [B, N] scores never reach device memory.
//  2. The merge kernel, one block per query, picks the best m of the query's
//     n_blocks * m candidates by (approximate score descending, position
//     ascending), normalizes the query in fp32, rescores the m rows exactly
//     against the fp32 table (dot products in a fixed order) and writes the
//     top k by (exact score descending, id ascending): k values (fp32) and k
//     ids (int64). The approximate score only decides who is in the pool.
//
// Replaces probgan_tpu/ops/pallas_rank.py:211 `_rank_topk_bf16_pallas` (kernel
// `_rank_topk_bf16_kernel`) and the merge and rescore that
// `rank_topk_fused(table_bf16=...)` runs after it (pallas_rank.py:357-382).
// Kept of its contract: queries normalized in fp32 (eps 1e-12) then cast to
// bf16, one low-precision product with fp32 accumulation, rows at or past
// `nvalid` never enter, a pool of m = k + 16 rows rescored exactly, ties by
// ascending id (`jnp.lexsort((ids, -exact))`), slots of a -inf filler stay
// -inf. Not kept: the TPU's pool (the top 2 of each of 128 lane-stride
// classes per 2048-row tile, as sortable ints with the lane id in the low
// bits). Here a block's pool is the exact top-m by approximate score, which
// always contains what that pool would have to contain.
//
// Bound on the H100 at N = 1M, D = 128: bytes. The bf16 table is 256 MB, read
// once at 3.35 TB/s = 0.076 ms, against 2*B*N*D = 16.4 GFLOP at B = 64 over
// the tensor cores' 989 TFLOP/s = 0.017 ms. So the stream runs
// mma.sync.m16n8k16 (bf16 in, fp32 out) and its design is about keeping the
// table stream busy:
//  * one block per SM walks a contiguous run of 128-row tiles through a ring
//    of up to 4 shared-memory stages filled with cp.async (16 bytes,
//    .cg, zero-filled past nvalid): tiles t+1 .. t+3 are in flight while
//    tile t is multiplied and selected;
//  * warp w multiplies table rows 16w..16w+15 (the m16 side) by all of the
//    chunk's queries (8 per n8 tile); each score is held against its query's
//    running pool threshold in registers, and only the survivors go through
//    shared memory, flagged in a 16-bit mask per (query, warp) built from
//    ballots (no atomics);
//  * the survivors are then inserted, in ascending id, into sorted pools.
//    With a full chunk of 64 queries (B > 32) thread q holds query q's pool
//    in its registers and inserts with 32 independent compares and selects,
//    no shuffles or votes; with fewer queries warp w holds its queries' pools
//    one entry per lane and inserts with a ballot and two shuffles, its
//    queries' insertions interleaved. With 64 queries the warp pools keep
//    the SM's shuffle and vote units busy for most of a tile, which the
//    thread pools do not use; with 8 queries the thread pools are 8 lanes of
//    one warp, serial, and the 8 warp pools run in parallel instead. After
//    the first tiles a threshold is the m-th best of thousands of rows and
//    few rows survive.
// The merge kernel reads n_blocks * m candidates and m fp32 rows per query
// (at B = 64 about 1.8 MB and 0.8 MB): its time is latency, so it copies a
// query's candidates into shared memory in one pass and works from there.
#include <cuda_bf16.h>

#include "async_copy.cuh"
#include "rank_tile.cuh"

namespace probgan {

constexpr int kMaxPool = 32;        // the largest pool, m = k + 16 for k <= 16
constexpr int kBf16Pad = 8;         // bf16 of padding per shared row: 16 bytes
constexpr int kScorePad = 4;        // floats of padding per row of the score array
constexpr int kMaxStages = 4;       // shared-memory stages of the table ring
constexpr int kGroups = kTileRows / 32;  // 32-row groups of a tile: one survivor mask each
constexpr int kMaxRankD = 256;
constexpr size_t kSmemPerBlock = 232448;  // what one block may use on an H100

inline size_t rank_bf16_smem_bytes(int nt, int D, int stages) {
  const size_t nq = static_cast<size_t>(kRankWarps) * nt;
  return (nq + static_cast<size_t>(stages) * kTileRows) * (D + kBf16Pad) * sizeof(__nv_bfloat16) +
         nq * (kTileRows + kScorePad) * sizeof(float) + nq * kRankWarps * sizeof(unsigned short) +
         nq * sizeof(float);
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

// Start the copy of table rows row0 .. row0 + 127 of table [>= nvalid][D]
// (bf16) into ts [128][D + pad]; rows at or past nvalid are zero-filled.
__device__ __forceinline__ void issue_tile_bf16(const __nv_bfloat16* __restrict__ table,
                                                int nvalid, int D, int row0,
                                                __nv_bfloat16* ts) {
  const int ld = D + kBf16Pad;
  const int d8 = D >> 3;
  for (int idx = threadIdx.x; idx < kTileRows * d8; idx += kRankThreads) {
    const int r = idx / d8;
    const int c = (idx - r * d8) << 3;
    const int row = row0 + r;
    const bool valid = row < nvalid;
    cp_async16(ts + r * ld + c, valid ? table + static_cast<size_t>(row) * D + c : table, valid);
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

// Does (av, ap) come before (bv, bp) in (value descending, key ascending)?
__device__ __forceinline__ bool ahead(float av, int ap, float bv, int bp) {
  return av > bv || (av == bv && ap < bp);
}

// Insert (v, id) into a thread's list of kMaxPool entries sorted by (value
// descending, id ascending). in[s]: does it go ahead of entry s (false up to
// its place, true from there on). Entry s then takes entry s - 1 where both
// are true and (v, id) where only in[s] is: independent compares, then
// independent selects, every index static, so the list stays in registers
// and the dependency chain is short. An entry behind all of them falls off.
__device__ __forceinline__ void list_insert(float (&lv)[kMaxPool], int (&li)[kMaxPool], float v,
                                            int id) {
  bool in[kMaxPool];
#pragma unroll
  for (int s = 0; s < kMaxPool; ++s) in[s] = ahead(v, id, lv[s], li[s]);
#pragma unroll
  for (int s = kMaxPool - 1; s > 0; --s) {
    lv[s] = in[s] ? (in[s - 1] ? lv[s - 1] : v) : lv[s];
    li[s] = in[s] ? (in[s - 1] ? li[s - 1] : id) : li[s];
  }
  lv[0] = in[0] ? v : lv[0];
  li[0] = in[0] ? id : li[0];
}

// Bits tig, tig + 4, ..., tig + 28 of a ballot, packed into bits 0 .. 7.
__device__ __forceinline__ unsigned lane_bits(unsigned bal, int tig) {
  unsigned x = (bal >> tig) & 0x11111111u;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000F000Fu;
  return (x | (x >> 12)) & 0xFFu;
}

template <int NT>
__global__ void __launch_bounds__(kRankThreads, 1)
    rank_topk_bf16_kernel(const float* __restrict__ pred, const __nv_bfloat16* __restrict__ table,
                          float* __restrict__ cand_v, int* __restrict__ cand_i, int B, int D,
                          int nvalid, int m, int normalize, int tiles_per_block, int n_tiles,
                          int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NQ = kRankWarps * NT;  // queries of the block's chunk
  const int ld = D + kBf16Pad;
  constexpr int lds = kTileRows + kScorePad;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ring = qs + NQ * ld;
  float* ss = reinterpret_cast<float*>(ring + stages * kTileRows * ld);
  // flags[q][w]: which of rows 16w .. 16w + 15 of the tile survived for
  // query q, written by warp w each tile (no atomics, nothing to clear)
  unsigned short* flags = reinterpret_cast<unsigned short*>(ss + NQ * lds);
  float* thr_s = reinterpret_cast<float*>(flags + NQ * kRankWarps);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the mma fragments' row group and thread in group
  const int q0 = blockIdx.y * NQ;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int n_mine = max(0, min(tile0 + tiles_per_block, n_tiles) - tile0);

  // The first stages - 1 tiles are in flight while the queries are staged.
  for (int s = 0; s < stages - 1; ++s) {
    if (s < n_mine) issue_tile_bf16(table, nvalid, D, (tile0 + s) * kTileRows, ring + s * kTileRows * ld);
    cp_async_commit();
  }
  load_queries_bf16<NT>(pred, B, D, q0, normalize, qs);
  for (int i = threadIdx.x; i < NQ; i += kRankThreads) thr_s[i] = -CUDART_INF_F;

  // The running pools. With a full chunk of 64 queries (kThreadPools), query
  // ql's pool lives in thread ql, in registers, in the last m of kMaxPool
  // sorted slots: the first kMaxPool - m hold (+inf, -1), which nothing
  // passes, so the m-th entry, the threshold, is always slot kMaxPool - 1 (a
  // static index keeps the list out of local memory). With fewer queries a
  // warp holds each of its NT queries' pools, lane l entry l (ev, ei), and
  // thr is entry m - 1 in every lane.
  constexpr bool kThreadPools = NT == 8;
  float lv[kThreadPools ? kMaxPool : 1];
  int li[kThreadPools ? kMaxPool : 1];
  float ev[NT], thr[NT];
  int ei[NT];
  if constexpr (kThreadPools) {
#pragma unroll
    for (int s = 0; s < kMaxPool; ++s) {
      const bool pad = s < kMaxPool - m;
      lv[s] = pad ? CUDART_INF_F : -CUDART_INF_F;
      li[s] = pad ? -1 : 0x7fffffff;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      ev[i] = -CUDART_INF_F;
      ei[i] = 0x7fffffff;
      thr[i] = -CUDART_INF_F;
    }
  }
  const unsigned mmask = (m >= 32) ? kFullMask : ((1u << m) - 1u);

  for (int it = 0; it < n_mine; ++it) {
    const int row0 = (tile0 + it) * kTileRows;
    cp_async_wait(stages - 2);
    // Tile `it` has landed for every thread, the previous selection is done
    // (thresholds and masks written), and stage (it - 1) % stages is free.
    __syncthreads();
    {
      const int nx = it + stages - 1;
      if (nx < n_mine)
        issue_tile_bf16(table, nvalid, D, (tile0 + nx) * kTileRows,
                        ring + (nx % stages) * kTileRows * ld);
      cp_async_commit();
    }
    const __nv_bfloat16* ts = ring + (it % stages) * kTileRows * ld;

    // acc[nt]: rows 16*warp + g (+8), queries 8*nt + 2*tig (+1)
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    const __nv_bfloat16* ta = ts + (16 * warp + g) * ld + 2 * tig;
    const __nv_bfloat16* qb = qs + g * ld + 2 * tig;
    // this thread's queries' thresholds, as the last selection left them
    float tq[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      tq[nt][0] = thr_s[8 * nt + 2 * tig];
      tq[nt][1] = thr_s[8 * nt + 2 * tig + 1];
    }
#pragma unroll 2
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
    // Only scores above their query's threshold go through shared memory.
    // Rows arrive in ascending id, so a score equal to the threshold never
    // enters a pool that already holds m rows. The survivors' masks come
    // from ballots: bit 4g + tig of the ballot of acc[nt][e] is row
    // 16*warp + g (+8 for e >= 2) of query 8*nt + 2*tig + (e & 1).
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      unsigned bal[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * warp + g + ((e & 2) ? 8 : 0);
        const int ql = 8 * nt + 2 * tig + (e & 1);
        const bool survives = row0 + r < nvalid && q0 + ql < B && acc[nt][e] > tq[nt][e & 1];
        if (survives) ss[ql * lds + r] = acc[nt][e];
        bal[e] = __ballot_sync(kFullMask, survives);
      }
      if (lane < 4) {  // lane = tig of row group g = 0
#pragma unroll
        for (int b = 0; b < 2; ++b)
          flags[(8 * nt + 2 * lane + b) * kRankWarps + warp] = static_cast<unsigned short>(
              lane_bits(bal[b], lane) | (lane_bits(bal[b + 2], lane) << 8));
      }
    }
    __syncthreads();

    // The survivors of rows 32j .. 32j + 31 of query ql are flagged in warps
    // 2j and 2j + 1's halves; they are inserted in ascending id.
    if constexpr (kThreadPools) {
      // Thread ql inserts query ql's: no shuffles or votes, ALU work only.
      if (threadIdx.x < NQ && q0 + static_cast<int>(threadIdx.x) < B) {
        const int ql = threadIdx.x;
#pragma unroll 1
        for (int j = 0; j < kGroups; ++j) {
          unsigned mask = flags[ql * kRankWarps + 2 * j] |
                          (static_cast<unsigned>(flags[ql * kRankWarps + 2 * j + 1]) << 16);
          while (mask) {
            const int src = __ffs(mask) - 1;
            mask &= mask - 1u;
            list_insert(lv, li, ss[ql * lds + j * 32 + src], row0 + j * 32 + src);
          }
        }
        thr_s[ql] = lv[kMaxPool - 1];
      }
    } else {
      // Warp w inserts its NT queries' survivors, the queries' insertions
      // interleaved and predicated so that their chains overlap.
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        unsigned mask[NT];
        float sv[NT];  // this lane's row of the group (read only where flagged)
        unsigned any = 0u;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const int ql = warp * NT + i;
          mask[i] = flags[ql * kRankWarps + 2 * j] |
                    (static_cast<unsigned>(flags[ql * kRankWarps + 2 * j + 1]) << 16);
          sv[i] = ss[ql * lds + j * 32 + lane];
          any |= mask[i];
        }
        while (any) {
          any = 0u;
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            const bool has = mask[i] != 0u;
            const int src = has ? __ffs(mask[i]) - 1 : 0;
            mask[i] &= mask[i] - 1u;
            any |= mask[i];
            const float v = __shfl_sync(kFullMask, sv[i], src);
            const int id = row0 + j * 32 + src;
            const bool enter = has && v > thr[i];  // the threshold may have risen in this tile
            const bool before = ev[i] > v || (ev[i] == v && ei[i] < id);
            const int pos = __popc(__ballot_sync(kFullMask, before) & mmask);
            const float up_v = __shfl_up_sync(kFullMask, ev[i], 1);
            const int up_i = __shfl_up_sync(kFullMask, ei[i], 1);
            const bool shift = enter && lane > pos;
            const bool put = enter && lane == pos;
            ev[i] = shift ? up_v : put ? v : ev[i];
            ei[i] = shift ? up_i : put ? id : ei[i];
            thr[i] = __shfl_sync(kFullMask, ev[i], m - 1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NT; ++i)
        if (lane == i) thr_s[warp * NT + i] = thr[i];
    }
  }
  cp_async_wait(0);

  // cand [B][gridDim.x][m]: a query's pools lie in ascending block order.
  if constexpr (kThreadPools) {
    const int q = q0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < NQ && q < B) {
      const size_t o = (static_cast<size_t>(q) * gridDim.x + blockIdx.x) * m;
      const int first = kMaxPool - m;
#pragma unroll
      for (int s = 0; s < kMaxPool; ++s) {
        if (s >= first) {
          cand_v[o + s - first] = lv[s];
          cand_i[o + s - first] = li[s];
        }
      }
    }
  } else {
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
}

// Insert candidate (v, p) into the warp's sorted list of m entries (lane l <
// m holds entry l; (tv, tp) is entry m - 1 in every lane) if it comes before
// entry m - 1. Warp-uniform arguments.
__device__ __forceinline__ void pool_insert(float v, int p, float& ev, int& ep, float& tv, int& tp,
                                            int m, unsigned mmask) {
  if (!ahead(v, p, tv, tp)) return;
  const int lane = threadIdx.x & 31;
  const int slot = __popc(__ballot_sync(kFullMask, ahead(ev, ep, v, p)) & mmask);
  const float up_v = __shfl_up_sync(kFullMask, ev, 1);
  const int up_p = __shfl_up_sync(kFullMask, ep, 1);
  if (lane > slot) {
    ev = up_v;
    ep = up_p;
  } else if (lane == slot) {
    ev = v;
    ep = p;
  }
  tv = __shfl_sync(kFullMask, ev, m - 1);
  tp = __shfl_sync(kFullMask, ep, m - 1);
}

// One block per query: merge its n_pools pools of m candidates, rescore the
// best m exactly against table_norm and write the top k. The candidates are
// first copied into shared memory in one pass ([n_pools * m] values, then
// ids), so no step below waits on device memory more than once.
__global__ void __launch_bounds__(kRankThreads)
    rank_merge_rescore_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_i,
                              int n_pools, int m, const float* __restrict__ pred,
                              const float* __restrict__ table, int D, int k,
                              float* __restrict__ out_v, long long* __restrict__ out_i) {
  extern __shared__ __align__(16) float merge_smem[];
  __shared__ float list_v[kRankWarps][kMaxPool];
  __shared__ int list_p[kRankWarps][kMaxPool];
  __shared__ int pool_id[kMaxPool];
  __shared__ int pool_ok[kMaxPool];
  __shared__ float exact[kMaxPool];
  __shared__ __align__(16) float qn[kMaxRankD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = blockIdx.x;
  const int n_cand = n_pools * m;
  float* cv = merge_smem;
  int* ci = reinterpret_cast<int*>(merge_smem + n_cand);
  {
    const float* gv = cand_v + static_cast<size_t>(q) * n_cand;
    const int* gi = cand_i + static_cast<size_t>(q) * n_cand;
    for (int i = threadIdx.x; i < n_cand; i += kRankThreads) {
      cv[i] = gv[i];
      ci[i] = gi[i];
    }
  }
  if (warp == 1) {
    // The query, normalized in fp32: x / max(||x||, 1e-12).
    const float* src = pred + static_cast<size_t>(q) * D;
    float ss = 0.f;
    for (int c = lane * 4; c < D; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(src + c);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(kFullMask, ss, off);
    const float denom = fmaxf(sqrtf(ss), kNormEps);
    for (int c = lane * 4; c < D; c += 128) {
      float4 v = *reinterpret_cast<const float4*>(src + c);
      v.x /= denom;
      v.y /= denom;
      v.z /= denom;
      v.w /= denom;
      *reinterpret_cast<float4*>(qn + c) = v;
    }
  }
  __syncthreads();
  const unsigned mmask = (m >= 32) ? kFullMask : ((1u << m) - 1u);

  // 1. Warp w keeps the best m of pools w, w + 8, ... by (value descending,
  //    position ascending); lanes >= m hold sentinels that never move up.
  float ev = -CUDART_INF_F, tv = -CUDART_INF_F;
  int ep = 0x7fffffff, tp = 0x7fffffff;
  for (int pool = warp; pool < n_pools; pool += kRankWarps) {
    const int p = pool * m + lane;
    const float v = lane < m ? cv[p] : -CUDART_INF_F;
    unsigned bal = __ballot_sync(kFullMask, lane < m && ahead(v, p, tv, tp));
    while (bal) {  // positions ascending
      const int src = __ffs(bal) - 1;
      bal &= bal - 1;
      pool_insert(__shfl_sync(kFullMask, v, src), __shfl_sync(kFullMask, p, src), ev, ep, tv, tp,
                  m, mmask);
    }
  }
  list_v[warp][lane] = ev;
  list_p[warp][lane] = ep;
  __syncthreads();

  if (warp == 0) {
    // 2. The eight lists into one; its m entries are the pool.
    for (int w = 1; w < kRankWarps; ++w) {
      const float v = list_v[w][lane];
      const int p = list_p[w][lane];
      unsigned bal = __ballot_sync(kFullMask, lane < m && ahead(v, p, tv, tp));
      while (bal) {
        const int src = __ffs(bal) - 1;
        bal &= bal - 1;
        pool_insert(__shfl_sync(kFullMask, v, src), __shfl_sync(kFullMask, p, src), ev, ep, tv, tp,
                    m, mmask);
      }
    }
    if (lane < m) {
      const bool ok = ev > -CUDART_INF_F;  // a -inf filler stays -inf with id 0
      pool_ok[lane] = ok;
      pool_id[lane] = ok ? ci[ep] : 0;
    }
  }
  __syncthreads();

  // 3. Exact scores: warp w takes slots w, w + 8, ...; each lane sums its
  //    float4 columns in order, then a fixed butterfly over the lanes, so
  //    bit-equal rows get bit-equal scores. The rows are loaded first.
  constexpr int kSlots = kMaxPool / kRankWarps;
  float4 rows[kSlots][kMaxRankD / 128];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = warp + j * kRankWarps;
    const float* row = table + static_cast<size_t>(s < m ? pool_id[s] : 0) * D;
#pragma unroll
    for (int u = 0; u < kMaxRankD / 128; ++u) {
      const int c = lane * 4 + u * 128;
      rows[j][u] = s < m && c < D ? *reinterpret_cast<const float4*>(row + c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int s = warp + j * kRankWarps;
    if (s >= m) break;  // warp-uniform
    float dot = 0.f;
#pragma unroll
    for (int u = 0; u < kMaxRankD / 128; ++u) {
      const int c = lane * 4 + u * 128;
      if (c < D) {
        const float4 x = *reinterpret_cast<const float4*>(qn + c);
        dot = fmaf(x.x, rows[j][u].x, dot);
        dot = fmaf(x.y, rows[j][u].y, dot);
        dot = fmaf(x.z, rows[j][u].z, dot);
        dot = fmaf(x.w, rows[j][u].w, dot);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(kFullMask, dot, off);
    if (lane == 0) exact[s] = pool_ok[s] ? dot : -CUDART_INF_F;
  }
  __syncthreads();

  // 4. Rank the m slots by (exact descending, id ascending, slot ascending)
  //    and write the first k.
  if (warp == 0) {
    const float e = lane < m ? exact[lane] : -CUDART_INF_F;
    const int id = lane < m ? pool_id[lane] : 0;
    int rank = 0;
    for (int t = 0; t < m; ++t) {
      const float et = __shfl_sync(kFullMask, e, t);
      const int it = __shfl_sync(kFullMask, id, t);
      rank += et > e || (et == e && (it < id || (it == id && t < lane)));
    }
    if (lane < m && rank < k) {
      out_v[static_cast<size_t>(q) * k + rank] = e;
      out_i[static_cast<size_t>(q) * k + rank] = id;
    }
  }
}

template <int NT>
int launch_stream(const float* pred, const __nv_bfloat16* table, float* cand_v, int* cand_i,
                  int B, int D, int nvalid, int m, int normalize, int tiles_per_block,
                  int n_blocks, cudaStream_t stream) {
  int stages = kMaxStages;
  while (stages > 2 && rank_bf16_smem_bytes(NT, D, stages) > kSmemPerBlock) --stages;
  const size_t smem = rank_bf16_smem_bytes(NT, D, stages);
  cudaError_t err = cudaFuncSetAttribute(rank_topk_bf16_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (nvalid + kTileRows - 1) / kTileRows;
  const int chunk = kRankWarps * NT;
  const dim3 grid(n_blocks, (B + chunk - 1) / chunk);
  rank_topk_bf16_kernel<NT><<<grid, kRankThreads, smem, stream>>>(
      pred, table, cand_v, cand_i, B, D, nvalid, m, normalize, tiles_per_block, n_tiles, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// pred [B][D] fp32 (raw; with parts & 1 and normalize = 0, already
// normalized), table_bf16 [>= nvalid][D] bf16 and table_norm [>= nvalid][D]
// fp32 with normalized rows.
// parts & 1, the stream: -> cand_v, cand_i [B][n_blocks][m], block b's best
// m rows by approximate score over table rows [b * tiles_per_block * 128,
// (b + 1) * tiles_per_block * 128) below nvalid, descending score /
// ascending id, padded with (-inf, INT_MAX).
// parts & 2, the merge and rescore of cand_v, cand_i (pred raw) -> out_v
// [B][k] fp32, out_i [B][k] int64.
// D % 16 == 0, D <= 256, 1 <= k <= m <= 32. Returns the cudaError_t of the
// first launch that failed (0 = all launched).
extern "C" int probgan_rank_topk_bf16(const float* pred, const void* table_bf16,
                                      const float* table_norm, float* cand_v, int* cand_i,
                                      float* out_v, long long* out_i, int B, int D, int nvalid,
                                      int m, int k, int normalize, int tiles_per_block,
                                      int n_blocks, int parts, void* stream) {
  using namespace probgan;
  if (B < 1 || D < 16 || D % 16 || D > kMaxRankD || nvalid < 1 || m < 1 || m > kMaxPool ||
      k < 1 || k > m || tiles_per_block < 1 || n_blocks < 1 || parts < 1 || parts > 3)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (parts & 1) {
    const auto* t = static_cast<const __nv_bfloat16*>(table_bf16);
    int err;
    switch (rank_qt(B)) {
      case 8:
        err = launch_stream<8>(pred, t, cand_v, cand_i, B, D, nvalid, m, normalize,
                               tiles_per_block, n_blocks, s);
        break;
      case 4:
        err = launch_stream<4>(pred, t, cand_v, cand_i, B, D, nvalid, m, normalize,
                               tiles_per_block, n_blocks, s);
        break;
      case 2:
        err = launch_stream<2>(pred, t, cand_v, cand_i, B, D, nvalid, m, normalize,
                               tiles_per_block, n_blocks, s);
        break;
      default:
        err = launch_stream<1>(pred, t, cand_v, cand_i, B, D, nvalid, m, normalize,
                               tiles_per_block, n_blocks, s);
        break;
    }
    if (err != 0) return err;
  }
  if (parts & 2) {
    const size_t smem = static_cast<size_t>(n_blocks) * m * (sizeof(float) + sizeof(int));
    const cudaError_t err = cudaFuncSetAttribute(
        rank_merge_rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    rank_merge_rescore_kernel<<<B, kRankThreads, smem, s>>>(cand_v, cand_i, n_blocks, m, pred,
                                                            table_norm, D, k, out_v, out_i);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}
