// The bf16 grades of the late-stage conv kernels: kernel modes "default"
// (one bf16 pass) and "mid" (the 2-term split) of packed_upconv (B1),
// packed_conv (B2), packed_conv_rgb (B3) and packed_convpool (B5), the Pallas
// kernels' `_dot` (probgan_tpu/ops/pallas_packed.py:85-170). "default"
// rounds both operands of every dot to bf16 (to nearest even); "mid" rounds
// the weights alone and splits the activations in two bf16 terms,
// x_hi = bf16(x), x_lo = bf16(x - x_hi), so that w_hi * x_hi + w_hi * x_lo
// is w_hi * x to ~2^-16. Products are summed in fp32; bias, LeakyReLU(0.2),
// PixelNorm, the pool, the blend and tanh -> uint8 stay fp32.
//
// The tile, fragments, rounding and epilogues of every bf16 kernel, and the
// bf16 staging of the stage-fused pair (fused_bf16.cuh: stage_chunk's
// rounded, or split, patch in shared memory, read by mma_row);
// packed_conv_bf16.cu, packed_conv_rgb_bf16.cu, packed_convpool_bf16.cu and
// packed_upconv_bf16.cu run the pipelined ring of bf16_ring.cuh over these
// tiles, in the order of sums that header fixes. An implicit GEMM on
// mma.sync.m16n8k16 with bf16 operands and fp32 accumulators. M = output
// pixels, N = a slab of Cout (32 or 64: all Cout where PixelNorm needs it,
// slabs of 64 for Cout 128), K = taps x input channels x terms.
//  * A block of 8 warps owns a tile of TH rows x 32 output columns (B1: TH
//    input rows x 16 input columns of one output row parity, both column
//    parities), TH = 8 at a slab of 64 and 16 at 32, and one slab. A warp
//    owns MT = TH/4 m16 tiles x all slab/8 n8 tiles: 64 fp32 sums a thread.
//    An m16 tile is one row of 16 columns (kRow16: B2, B3; B1: 16 input
//    columns of one parity) or, for B5's pool (bf16_ring.cuh
//    ConvPoolBf16Ring), two rows of 8 columns (kPool2x8), so that the lane
//    holding pixel g also holds pixel g + 8 below it: a 2x2 window's
//    vertical pair is d[0] + d[2] in one thread, its horizontal pair one xor
//    shuffle of 4 lanes.
//  * Input channels go through shared memory kCK = 32 at a time. The rings
//    stage the fp32 patch and round as the fragments load (bf16_ring.cuh);
//    the stage-fused pair's block (stage_x) stages its halo patch, rounding
//    (at "mid": splitting) each fp32 value as it goes, into
//    [row][column][channel] order (channels innermost, 40 bf16 a pixel: 80
//    bytes, 20 words), so that an A fragment register (two channels of one
//    pixel) is one 32-bit load. At "mid" the patch is staged
//    twice, the x_hi plane and the x_lo plane: the split happens once a value
//    and the main loop reads two planes of one layout. The weights come
//    pre-rounded from the wrapper in the same [tap][slab][40] order for each
//    chunk of 32 channels, and are copied as they are with cp.async. Rows of
//    20 words put the 8 pixels (or output channels) x 4 channel pairs of a
//    fragment load on 32 distinct banks; the staging stores use the same map.
//  * Per chunk, tap and half of the chunk's channels, a warp loads the slab/8
//    B fragments (w_hi) once and runs them against each of its m16 tiles,
//    the x_hi then the x_lo A fragments: 1 or 2 mma a fragment.
//  * Shared memory a block: bf16_ring.cuh states the rings' (B1, B2, B3,
//    B5), fused_bf16.cuh the stage-fused pair's.
//  * Narrow slabs: at 16 and 8 channels (fmap_base 2048 at 1024²: 16 and 8
//    channels at 512² and 1024²) the tile keeps the 32-channel geometry
//    (16 rows, MT = 4 m16 tiles a warp) with NT = 2 or 1 n8 tiles: 32 or 16
//    sums a thread. Input C is any multiple of 8: the last chunk of C % 32
//    channels is staged with zeros past C (its weights are zero there too,
//    from the wrapper) and at 16 or fewer runs one k16 half, so C = 16 is one
//    k16 step and C = 8 one step half zeros. Zero products change no fp32
//    sum, and a chunk of 32 channels is staged and summed as before.
//  * Any width up to 64 (B1 "lrelu_norm", B2 "lrelu_norm", B3): a Cout
//    between the tiles runs on the one above it (1-8 on 8, ... 33-64 on
//    64) with the wrapper's zero-padded weights and bias, and C is any
//    count >= 1 (the zero-fill above); PixelNorm divides by the true Cout
//    (bias_lrelu_norm_frag's inv_n) and the rings store only its channels.
//  * Every output is summed in one order (chunks ascending, taps, channel
//    halves, terms), with no split over K and no atomics: a run gives the
//    bits of the run before it, and B5 "mid" sums each pixel as B2 "mid"
//    does (the m16 layout moves no sum). bf16 x bf16 products are exact in
//    fp32, so the sums differ from a plain fp32 conv of the rounded (split)
//    operands only by their order (and the tensor cores' own rounding of
//    each mma's sum).
#pragma once

#include <cuda_bf16.h>

#include "async_copy.cuh"
#include "conv_tile.cuh"

namespace probgan {

constexpr int kCK = 32;              // input channels a shared-memory chunk
constexpr int kPadK = kCK + 8;       // bf16 a staged pixel or weight row
constexpr int kRowWords = kPadK / 2;  // 20 words

// The epilogues, by their codes in ops/packed.py CONV_EPILOGUES.
enum BfEpilogue { kLreluNorm = 0, kLrelu = 1, kNone = 2 };
// Where an m16 tile's 16 pixels lie in the output tile: one row of 16
// columns (pixel p at column p), or two rows of 8 (p at row p / 8, column
// p % 8), B5's.
enum MLayout { kRow16 = 0, kPool2x8 = 1 };

// D (16x8, fp32) += A (16x16, bf16, row-major) * B (16x8, bf16, column-major).
// Fragments (g = lane / 4, t = lane % 4), two bf16 a register, the lower
// index in the low half: a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// v as kernel mode "mid" sees it: bf16(v) + bf16(v - bf16(v)), the sum exact
// in fp32.
__device__ __forceinline__ float split2(float v) {
  const float hi = round_bf16(v);
  return hi + round_bf16(v - hi);
}

// COUT: the output channels of a block (a slab of Cout).
template <int COUT>
struct BfTile {
  static_assert(COUT == 8 || COUT == 16 || COUT == 32 || COUT == 64,
                "the bf16 kernels are built for 8, 16, 32 or 64 channels");
  static constexpr int TH = COUT == 64 ? 8 : 16;  // rows a tile (B1: input rows)
  static constexpr int RW = TH / 8;               // rows a warp
  static constexpr int MT = 2 * RW;               // m16 tiles a warp
  static constexpr int NT = COUT / 8;             // n8 tiles
};

// Stage channels c0 .. c0 + kCK - 1 of image plane `xb` [C][H][W] for the
// patch rows row0 .. row0 + SR - 1 and columns col0 .. col0 + 8 * NG - 1 into
// `xs` [NTERM][SR][8 * NG][kPadK] bf16, zero outside the image: the values
// rounded (NTERM 1) or their two terms, x_hi then x_lo a plane (NTERM 2).
// Work item = (patch row, group of 8 columns, group of 8 channels); in a warp
// lane l takes column l % 8 and channels 2 * (l / 8), + 1 of its group, two
// coalesced loads and one 32-bit store a plane, on 32 distinct banks. The
// last chunk of a C that is no multiple of 32 has c_left < kCK channels: its
// groups past them are staged as zeros, and only the NQ groups of the k16
// halves that the mma reads (the first half alone at c_left <= 16).
template <int SR, int NG, int NTERM, int NQ = kCK / 8>
__device__ __forceinline__ void stage_x(unsigned* __restrict__ xs, const float* __restrict__ xb,
                                        int c0, int H, int W, int row0, int col0,
                                        int c_left = kCK) {
  static_assert(NTERM == 1 || NTERM == 2, "one bf16 pass or the 2-term split");
  static_assert(NQ == 2 || NQ == 4, "one or both k16 halves of a chunk");
  constexpr int kPlane = SR * 8 * NG * kRowWords;
  constexpr int kItems = SR * NG * NQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pix = lane & 7, cp = lane >> 3;
  const size_t plane = static_cast<size_t>(H) * W;
  for (int it = warp; it < kItems; it += kThreads / 32) {
    const int q = it % NQ;
    const int rj = it / NQ;
    const int j = rj % NG;
    const int r = rj / NG;
    const int gy = row0 + r, gx = col0 + 8 * j + pix;
    const int c = c0 + 8 * q + 2 * cp;
    float v0 = 0.f, v1 = 0.f;
    if (8 * q < c_left && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* p = xb + c * plane + static_cast<size_t>(gy) * W + gx;
      v0 = __ldg(p);
      v1 = __ldg(p + plane);
    }
    const int o = (r * 8 * NG + 8 * j + pix) * kRowWords + 4 * q + cp;
    if constexpr (NTERM == 1) {
      xs[o] = pack_bf16(v0, v1);
    } else {  // v - bf16(v) is exact in fp32
      const float h0 = round_bf16(v0), h1 = round_bf16(v1);
      xs[o] = pack_bf16(h0, h1);
      xs[o + kPlane] = pack_bf16(v0 - h0, v1 - h1);
    }
  }
}

// `n_words` 32-bit words of pre-rounded weights, contiguous in global and in
// shared memory, by 16-byte cp.async copies (n_words % 4 == 0).
__device__ __forceinline__ void stage_w(unsigned* ws, const unsigned* __restrict__ src,
                                        int n_words) {
  for (int e = 4 * threadIdx.x; e < n_words; e += 4 * kThreads) cp_async16(ws + e, src + e, true);
}

// The products of one chunk for one m16 tile against all NT n8 tiles, term
// by term: `pa` is the tile's pixel 0's word in the x_hi plane of the staged
// patch, `half` the words from pixel g to pixel g + 8 (8 pixels along a row,
// or one patch row down), `plane` the words from the x_hi plane to the x_lo
// plane; `b` the tap's w_hi B fragments.
template <int NT, int NTERM>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4], const unsigned* pa, int half,
                                        int plane, const unsigned (&b)[NT][2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int term = 0; term < NTERM; ++term) {
    const unsigned* p = pa + term * plane + g * kRowWords + t;
    const unsigned a[4] = {p[0], p[half], p[4], p[half + 4]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, b[nt][0], b[nt][1]);
  }
}

template <int NT>
__device__ __forceinline__ void load_b(unsigned (&b)[NT][2], const unsigned* pb) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    b[nt][0] = pb[(8 * nt + g) * kRowWords + t];
    b[nt][1] = pb[(8 * nt + g) * kRowWords + t + 4];
  }
}

// bias -> lrelu(0.2) -> x * 1/sqrt(mean_c(x^2) + 1e-8) on one m16 tile's
// sums, in place (conv_tile.cuh bias_lrelu_norm's arithmetic): pixel g holds
// e = 0, 1 of every n8 tile, pixel g + 8 e = 2, 3, channel 8 * nt + 2t + e % 2;
// the 4 lanes of a quad hold all COUT channels of its two pixels, the mean
// the sum times inv_n, 1 / the true channel count (zeros past it).
template <int NT>
__device__ __forceinline__ void bias_lrelu_norm_frag(float (&acc)[NT][4],
                                                     const float* __restrict__ bias,
                                                     float inv_n = 1.0f / (8 * NT)) {
  const int t = threadIdx.x & 3;
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = acc[nt][e] + __ldg(bias + 8 * nt + 2 * t + (e & 1));
      v = v >= 0.f ? v : kSlope * v;
      acc[nt][e] = v;
      ss[e >> 1] += v * v;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // every lane adds the same two operands at each level: one result
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 1);
    ss[h] += __shfl_xor_sync(0xffffffffu, ss[h], 2);
    ss[h] = 1.0f / sqrtf(ss[h] * inv_n + kEps);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= ss[e >> 1];
}

// bias -> LeakyReLU(0.2) (kLrelu) or bias alone (kNone) on one m16 tile's
// sums, in place; `bias` is the slab's.
template <int NT, int EPI>
__device__ __forceinline__ void bias_act_frag(float (&acc)[NT][4], const float* __restrict__ bias) {
  static_assert(EPI == kLrelu || EPI == kNone, "PixelNorm is bias_lrelu_norm_frag");
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = acc[nt][e] + __ldg(bias + 8 * nt + 2 * t + (e & 1));
      acc[nt][e] = EPI == kLrelu && v < 0.f ? kSlope * v : v;
    }
}

// The output pixel of m16 tile q = warp * MT + mt of a tile, lane row g:
// kRow16, row q / 2 and columns 16 * (q % 2) + g (pixel g + 8: 8 columns on);
// kPool2x8, rows 2 * (q / 4) (+ 1 for pixel g + 8) and column 8 * (q % 4) + g.
template <int LAYOUT>
__device__ __forceinline__ int mtile_row(int q) {
  return LAYOUT == kRow16 ? q / 2 : 2 * (q / 4);
}
template <int LAYOUT>
__device__ __forceinline__ int mtile_col(int q) {
  return LAYOUT == kRow16 ? 16 * (q % 2) : 8 * (q % 4);
}

// The chunks of C input channels: C / kCK, and one more, partial, where C %
// kCK != 0 (the weights' [chunk] dimension, ops/packed.py conv_bf16_weights).
__device__ __forceinline__ int bf16_chunks(int C) { return (C + kCK - 1) / kCK; }

// stage_x for the chunk at c0 of C channels: the whole chunk, or the groups
// of the last, partial one.
template <int SR, int NG, int NTERM>
__device__ __forceinline__ void stage_chunk(unsigned* __restrict__ xs,
                                            const float* __restrict__ xb, int c0, int C, int H,
                                            int W, int row0, int col0) {
  const int c_left = C - c0;
  if (c_left >= kCK)
    stage_x<SR, NG, NTERM>(xs, xb, c0, H, W, row0, col0);
  else if (c_left > kCK / 2)
    stage_x<SR, NG, NTERM, 4>(xs, xb, c0, H, W, row0, col0, c_left);
  else
    stage_x<SR, NG, NTERM, 2>(xs, xb, c0, H, W, row0, col0, c_left);
}

}  // namespace probgan
