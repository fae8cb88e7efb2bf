// The bf16 grade of the late-stage generator kernels: kernel mode "default"
// of packed_upconv (B1), packed_conv "lrelu_norm" (B2) and packed_conv_rgb
// (B3), the Pallas kernels' one bf16 pass (probgan_tpu/ops/pallas_packed.py
// `_dot` with mode "default"): both operands of every dot rounded to bf16 (to
// nearest even), the products summed in fp32; bias, LeakyReLU(0.2),
// PixelNorm, the blend and tanh -> uint8 stay fp32.
//
// Shared by packed_conv_bf16.cu, packed_conv_rgb_bf16.cu and
// packed_upconv_bf16.cu: an implicit GEMM on mma.sync.m16n8k16 with bf16
// operands and fp32 accumulators. M = output pixels, N = all Cout (32 or 64,
// so that PixelNorm stays inside the block), K = taps x input channels.
//  * A block of 8 warps owns a tile of TH rows x 32 output columns (B1: TH
//    input rows x 16 input columns of one output row parity, both column
//    parities), TH = 8 at Cout 64 and 16 at Cout 32. A warp owns TH/8 rows;
//    each of its rows is two m16 tiles (B2/B3: columns 0-15 and 16-31; B1:
//    column parity 0 and 1 of 16 input columns) x all Cout/8 n8 tiles: 64
//    fp32 sums a thread either way.
//  * Input channels go through shared memory kCK = 32 at a time. The block
//    stages its halo patch, rounding each fp32 value to bf16 as it goes,
//    into [row][column][channel] order (channels innermost, 40 bf16 a pixel:
//    80 bytes, 20 words), so that an A fragment register (two channels of one
//    pixel) is one 32-bit load. The weights come pre-rounded from the wrapper
//    in the same [tap][Cout][40] order for each chunk of 32 channels, and are
//    copied as they are with cp.async. Rows of 20 words put the 8 pixels (or
//    output channels) x 4 channel pairs of a fragment load on 32 distinct
//    banks; the staging stores use the same map.
//  * Per chunk, tap and half of the chunk's channels, a warp loads the Cout/8
//    B fragments once and runs them against each of its m16 tiles.
//  * Two blocks an SM (78-81 KB of shared memory each, at most 128 registers
//    a thread): one block's staging overlaps the other's products.
//  * Every output is summed in one order (chunks ascending, taps, channel
//    halves), with no split over K and no atomics: a run gives the bits of
//    the run before it. bf16 x bf16 products are exact in fp32, so the sums
//    differ from a plain fp32 conv of the rounded operands only by their
//    order (and the tensor cores' own rounding of each mma's sum).
#pragma once

#include <cuda_bf16.h>

#include "async_copy.cuh"
#include "conv_tile.cuh"

namespace probgan {

constexpr int kCK = 32;              // input channels a shared-memory chunk
constexpr int kPadK = kCK + 8;       // bf16 a staged pixel or weight row
constexpr int kRowWords = kPadK / 2;  // 20 words

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

template <int COUT>
struct BfTile {
  static_assert(COUT == 32 || COUT == 64, "the bf16 kernels are built for 32 or 64 channels");
  static constexpr int TH = COUT == 64 ? 8 : 16;  // rows a tile (B1: input rows)
  static constexpr int RW = TH / 8;               // rows a warp
  static constexpr int MT = 2 * RW;               // m16 tiles a warp
  static constexpr int NT = COUT / 8;             // n8 tiles
};

// Stage channels c0 .. c0 + kCK - 1 of image plane `xb` [C][H][W] for the
// patch rows row0 .. row0 + SR - 1 and columns col0 .. col0 + 8 * NG - 1 into
// `xs` [SR][8 * NG][kPadK] bf16, zero outside the image. Work item = (patch
// row, group of 8 columns, group of 8 channels); in a warp lane l takes
// column l % 8 and channels 2 * (l / 8), + 1 of its group, two coalesced
// loads and one 32-bit store, on 32 distinct banks.
template <int SR, int NG>
__device__ __forceinline__ void stage_x(unsigned* __restrict__ xs, const float* __restrict__ xb,
                                        int c0, int H, int W, int row0, int col0) {
  constexpr int kItems = SR * NG * (kCK / 8);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pix = lane & 7, cp = lane >> 3;
  const size_t plane = static_cast<size_t>(H) * W;
  for (int it = warp; it < kItems; it += kThreads / 32) {
    const int q = it % (kCK / 8);
    const int rj = it / (kCK / 8);
    const int j = rj % NG;
    const int r = rj / NG;
    const int gy = row0 + r, gx = col0 + 8 * j + pix;
    const int c = c0 + 8 * q + 2 * cp;
    float v0 = 0.f, v1 = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float* p = xb + c * plane + static_cast<size_t>(gy) * W + gx;
      v0 = __ldg(p);
      v1 = __ldg(p + plane);
    }
    xs[(r * 8 * NG + 8 * j + pix) * kRowWords + 4 * q + cp] = pack_bf16(v0, v1);
  }
}

// `n_words` 32-bit words of pre-rounded weights, contiguous in global and in
// shared memory, by 16-byte cp.async copies (n_words % 4 == 0).
__device__ __forceinline__ void stage_w(unsigned* ws, const unsigned* __restrict__ src,
                                        int n_words) {
  for (int e = 4 * threadIdx.x; e < n_words; e += 4 * kThreads) cp_async16(ws + e, src + e, true);
}

// The products of one chunk for one m16 tile against all NT n8 tiles: `pa`
// is the tile's first pixel's word in the staged patch (row g = pixel g),
// `pb` the tap's weights [COUT][kRowWords] in shared memory.
template <int NT>
__device__ __forceinline__ void mma_row(float (&acc)[NT][4], const unsigned* pa,
                                        const unsigned (&b)[NT][2]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const unsigned a[4] = {pa[g * kRowWords + t], pa[(g + 8) * kRowWords + t],
                         pa[g * kRowWords + t + 4], pa[(g + 8) * kRowWords + t + 4]};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, b[nt][0], b[nt][1]);
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
// the 4 lanes of a quad hold all COUT channels of its two pixels.
template <int NT>
__device__ __forceinline__ void bias_lrelu_norm_frag(float (&acc)[NT][4],
                                                     const float* __restrict__ bias) {
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
    ss[h] = 1.0f / sqrtf(ss[h] / static_cast<float>(8 * NT) + kEps);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] *= ss[e >> 1];
}

// B2 and B3: a tile of TH rows x 32 columns, its halo patch (rows y0 - 1 ..
// y0 + TH, columns x0 - 4 .. x0 + 35, whole groups of 8) and one chunk's
// weights [9 taps][COUT][kPadK].
template <int COUT>
struct ConvBf16 {
  using T = BfTile<COUT>;
  static constexpr int SR = T::TH + 2;    // patch rows: y0 - 1 .. y0 + TH
  static constexpr int NG = 5;            // patch columns x0 - 4 .. x0 + 35
  static constexpr int kXWords = SR * 8 * NG * kRowWords;
  static constexpr int kWWords = 9 * COUT * kRowWords;  // one chunk's weights
  static constexpr int kBytes = 4 * (kXWords + kWWords);
};

// B2's and B3's main loop: the tile's sums of a 3x3 SAME conv,
// acc[m16 tile][n8 tile][4], m16 tile mt = (row rr = mt / 2 of the warp's,
// column half mt % 2).
template <int COUT>
__device__ __forceinline__ void conv_bf16_tile(float (&acc)[BfTile<COUT>::MT][BfTile<COUT>::NT][4],
                                               unsigned* smem, const float* __restrict__ x,
                                               const unsigned* __restrict__ wk, int b, int y0,
                                               int x0, int C, int H, int W) {
  using T = BfTile<COUT>;
  using K = ConvBf16<COUT>;
  unsigned* xs = smem;
  unsigned* ws = smem + K::kXWords;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const float* xb = x + static_cast<size_t>(b) * C * H * W;
  for (int c0 = 0; c0 < C; c0 += kCK) {
    stage_w(ws, wk + static_cast<size_t>(c0 / kCK) * K::kWWords, K::kWWords);
    cp_async_commit();
    stage_x<K::SR, K::NG>(xs, xb, c0, H, W, y0 - 1, x0 - 4);
    cp_async_wait(0);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // channels 16 * kk .. + 15 of the chunk
        unsigned bf[T::NT][2];
        load_b<T::NT>(bf, ws + tap * COUT * kRowWords + 8 * kk);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          // output row warp * RW + mt / 2 reads patch row + ky; output column
          // 16 * (mt % 2) + g reads patch column 16 * (mt % 2) + g + kx + 3
          const int row = warp * T::RW + mt / 2 + ky;
          const int col = 16 * (mt % 2) + kx + 3;
          mma_row<T::NT>(acc[mt], xs + (row * 8 * K::NG + col) * kRowWords + 8 * kk, bf);
        }
      }
    }
    __syncthreads();  // every warp is done with the chunk before it is replaced
  }
}

}  // namespace probgan
