// rank_topk: L2-normalize the queries, score them against a pre-normalized
// entity table at the fp32 grade, and keep each query's top-k per block of
// table rows. The [B, N] score matrix never reaches device memory.
//
// Replaces probgan_tpu/ops/pallas_rank.py:261 `_rank_topk_pallas` (kernel
// `_rank_topk_kernel`), reached through `rank_topk_fused` and
// `rank_topk_local`. The contract is kept: rows at or past `nvalid` never
// win, values come in descending order and equal values in ascending id
// (what lax.top_k returns), 1 <= k <= 16. The TPU kernel's 2048-row tiles,
// 128-lane candidate padding and shape gates are not: any B >= 1, any
// number of rows and any D % 4 == 0 up to 256 are taken.
//
// Grade and product: rank_scores.cu's (B7), through the same walk
// (rank_ring.cuh): 3xTF32 on the tensor cores, every score summed in one
// fixed order, so each score is B7's bit for bit and this kernel's top k
// equal B7's scores followed by a stable top-k.
//
// Bound on the H100 at N = 1M, D = 128: the table's 512 MB read once at
// 3.35 TB/s = 0.153 ms, bytes, at B = 64 and B = 8 alike. The operations,
// 3 x 2*B*N*D TF32 FLOP at 495 TFLOP/s, take 0.099 ms at B = 64 (as fp32
// FMAs on the CUDA cores, the grade of the kernel this one replaces, 0.245
// ms: that kernel was bound by operations).
//
// Design. Blocks run in no order, so nothing carries between them: each
// block owns a chunk of up to 64 queries and a contiguous run of table tiles
// (ops/rank_fused.py:scores_tiling and tile_runs), streams them through
// rank_ring.cuh's ring of bulk copies and 3xTF32 products, and writes its
// own k candidates per query; the merge over [B, n_blocks * k] is a stable
// sort outside the kernel. Where B7 stores a tile's staged scores, this
// kernel's sink selects from them before the stage is refilled: warp w
// owns queries w, w + 8, ... of the chunk and keeps each one's running top-k
// sorted across lanes 0..k-1 in registers. A score enters only if it beats
// the current k-th value (about k * ln(rows / k) insertions per query and
// block). A tile first costs each lane TR/32 shared loads and a max per
// query and one OR over the warp; only a query whose tile holds a candidate
// is read again, 32 rows at a time in ascending row order (-inf at or past
// nvalid) with one ballot each, its candidates inserted by a ballot and
// shuffles. Each insertion is a chain of warp-wide steps between the
// barriers that frame the sink, with the tensor cores idle: at B = 64 on an
// H100 the selection adds 0.05-0.21 ms (k = 1-16) to the ~0.40 ms of the
// walk alone (utils/rank_ablation.py). Forms measured and not kept: four
// lanes a query (the warp's 8 queries side by side) and one list a thread
// were slower; a bitonic merge of a 32-row group's candidates gained
// nothing. What would hide it is a selection that runs beside the next
// tile's product (PERF.md, open questions).
// Rows are visited in ascending id, so a later equal score never displaces
// an earlier one: that is the lowest-index tie-break.
#include "rank_ring.cuh"

namespace probgan {

constexpr int kMaxK = 16;
constexpr int kSelQ = kScQ / 8;  // a warp's queries of the chunk: w, w + 8, ...

// The sink: the running top-k of a warp's queries over the tiles it has
// taken; lane l < k holds entry l of query w + 8i in ev[i], ei[i]
// (descending value, ascending id), and thr[i] is entry k-1's value, the same
// in every lane.
template <int TR>
struct SelectTopk {
  int nvalid, k, nq, tile0;
  unsigned kmask;
  float ev[kSelQ], thr[kSelQ];
  int ei[kSelQ];

  __device__ __forceinline__ SelectTopk(int nvalid_, int k_, int nq_, int tile0_)
      : nvalid(nvalid_), k(k_), nq(nq_), tile0(tile0_), kmask((1u << k_) - 1u) {
#pragma unroll
    for (int i = 0; i < kSelQ; ++i) {
      ev[i] = -CUDART_INF_F;
      ei[i] = 0x7fffffff;
      thr[i] = -CUDART_INF_F;
    }
  }

  __device__ __forceinline__ void take(const float* stage, int it) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row0 = (tile0 + it) * TR;
    // Which queries have a score above their k-th value in this tile: a
    // lane's largest of its TR/32 scores against the threshold, one bit a
    // query, OR-ed over the warp. The others take no further step; the test
    // is exact, since a threshold only rises while a tile is taken.
    unsigned hits = 0;
#pragma unroll
    for (int i = 0; i < kSelQ; ++i) {
      const int ql = warp + 8 * i;
      if (ql < nq) {  // warp-uniform
        float best = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < TR / 32; ++j) {
          const int r = j * 32 + lane;
          if (row0 + r < nvalid) best = fmaxf(best, staged_score<TR>(stage, ql, r));
        }
        if (best > thr[i]) hits |= 1u << i;
      }
    }
    hits = __reduce_or_sync(kFullMask, hits);
#pragma unroll
    for (int i = 0; i < kSelQ; ++i) {
      if (!(hits >> i & 1u)) continue;  // warp-uniform
      const int ql = warp + 8 * i;
#pragma unroll
      for (int j = 0; j < TR / 32; ++j) {
        const int r = j * 32 + lane;
        const float s = row0 + r < nvalid ? staged_score<TR>(stage, ql, r) : -CUDART_INF_F;
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
  __device__ __forceinline__ void write(float* __restrict__ cand_v, int* __restrict__ cand_i,
                                        int q0) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kSelQ; ++i) {
      const int ql = warp + 8 * i;
      if (ql < nq && lane < k) {
        const size_t o = (static_cast<size_t>(q0 + ql) * gridDim.x + blockIdx.x) * k + lane;
        cand_v[o] = ev[i];
        cand_i[o] = ei[i];
      }
    }
  }
};

template <int TR, int S>
__global__ void __launch_bounds__(kScThreads, TR == 64 ? 2 : 1)
    rank_topk_kernel(const float* __restrict__ pred, const float* __restrict__ table,
                     float* __restrict__ cand_v, int* __restrict__ cand_i, int B, int D,
                     int nvalid, int k, int normalize, int tiles_per_block, int n_tiles) {
  extern __shared__ __align__(16) float tk_smem[];
  const int q0 = blockIdx.y * kScQ;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int nq = min(kScQ, B - q0);
  SelectTopk<TR> sel(nvalid, k, nq, tile0);
  rank_ring_walk<TR, S>(tk_smem, pred, table, B, D, nvalid, normalize, q0, nq, tile0,
                        min(tiles_per_block, n_tiles - tile0), sel);
  sel.write(cand_v, cand_i, q0);
}

template <int TR, int S>
int launch(const float* pred, const float* table, float* cand_v, int* cand_i, int B, int D,
           int nvalid, int k, int normalize, int tiles_per_block, int n_blocks,
           cudaStream_t stream) {
  const size_t smem = scores_smem_bytes(D, TR, S);
  cudaError_t err = cudaFuncSetAttribute(rank_topk_kernel<TR, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (nvalid + TR - 1) / TR;
  const dim3 grid(n_blocks, (B + kScQ - 1) / kScQ);
  rank_topk_kernel<TR, S><<<grid, kScThreads, smem, stream>>>(
      pred, table, cand_v, cand_i, B, D, nvalid, k, normalize, tiles_per_block, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// pred [B][D] fp32 (raw, or already normalized with normalize = 0),
// table [>= nvalid][D] fp32 with normalized rows, both 16-byte aligned
// -> cand_v, cand_i [B][n_blocks][k]: block b's top-k over table rows
// [b * tiles_per_block * tile_rows, (b + 1) * tiles_per_block * tile_rows)
// below nvalid, descending value / ascending id, padded with (-inf, INT_MAX).
// D % 4 == 0 and D <= 256; tile_rows 128 (D <= 128 only) or 64
// (ops/rank_fused.py:scores_tiling) with n_blocks * tiles_per_block *
// tile_rows >= nvalid > (n_blocks - 1) * tiles_per_block * tile_rows.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_rank_topk(const float* pred, const float* table, float* cand_v,
                                 int* cand_i, int B, int D, int nvalid, int k, int normalize,
                                 int tile_rows, int tiles_per_block, int n_blocks,
                                 void* stream) {
  using namespace probgan;
  if (B < 1 || D < 4 || D % 4 || D > 256 || nvalid < 1 || k < 1 || k > kMaxK ||
      tiles_per_block < 1 || n_blocks < 1 || !ring_tiling_ok(tile_rows, D) ||
      static_cast<long long>(n_blocks - 1) * tiles_per_block * tile_rows >= nvalid ||
      static_cast<long long>(n_blocks) * tiles_per_block * tile_rows < nvalid ||
      B > 65535LL * kScQ)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (tile_rows == 128)
    return launch<128, 3>(pred, table, cand_v, cand_i, B, D, nvalid, k, normalize,
                          tiles_per_block, n_blocks, s);
  return launch<64, 2>(pred, table, cand_v, cand_i, B, D, nvalid, k, normalize,
                       tiles_per_block, n_blocks, s);
}
