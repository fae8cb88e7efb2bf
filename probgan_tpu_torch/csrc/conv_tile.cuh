// Shared pieces of the late-stage conv kernels (through conv_ring.cuh
// packed_conv.cu's fp32 epilogues, packed_conv_rgb.cu, packed_convpool.cu,
// packed_upconv.cu and the stage-fused pair over fused_ring.cuh): tile
// geometry, the per-thread channel map, the fused bias -> LeakyReLU(0.2) ->
// PixelNorm epilogue, its PixelNorm-free forms for the discriminator, the
// synchronous 3x3 SAME conv main loop (the clock-split probe's baseline;
// conv3x3_rows also serves the stage-fused kernels' conv2) and the final
// stage's toRGB -> blend -> uint8 tail.
//
// Every kernel is an implicit GEMM on the CUDA cores in fp32: M = output
// pixels, N = output channels (8, 16, 32 or 64), K = taps x input channels.
// A PixelNorm kernel of the serving path (B1 "lrelu_norm", B2 "lrelu_norm",
// B3) takes any Cout from 1 to 64 on the tile just above it (1-8 on 8, 9-16
// on 16, 17-32 on 32, 33-64 on 64): the wrapper pads the weights, bias and
// toRGB weights with zeros to the tile's width, the padded channels' sums
// are 0 (lrelu(0) = 0 adds 0 to the sum of squares), PixelNorm divides by
// the true Cout (`inv_n` = 1 / Cout) and only channels below it are stored.
// A block owns a tile of output pixels and ALL output channels, so PixelNorm
// (a mean over channels) never leaves the block: a thread holds 8 pixels x 8
// channels in registers, and the COUT/8 lanes that share a pixel group are
// neighbours in one warp and reduce sum(x^2) with xor shuffles. A block is
// 256 threads at 32 and 64 channels; at 16 and 8 it keeps the 32-channel
// tile's 64 pixel groups (16 x 32 pixels) with 128 and 64 threads, so that
// its halo patch stays the size of the 32-channel one. In
// conv3x3_accumulate input channels stream through shared memory 8 at a
// time, with the matching weight slab beside them (the full weights, up to
// 512 KB, do not fit in a block's 227 KB); conv_ring.cuh is
// the pipelined form of the same loop, with the same bits.
#pragma once

#include <cuda_runtime.h>

namespace probgan {

constexpr int kThreads = 256;  // threads per block at 32 and 64 channels
constexpr int kCC = 8;         // input channels staged per shared-memory step
constexpr int kTM = 8;         // output pixels per thread, contiguous in a row
constexpr int kTN = 8;         // output channels per thread
constexpr float kSlope = 0.2f;
constexpr float kEps = 1e-8f;

// A clock that a main loop reads at the boundaries of a step's parts:
// NoClock in the kernels (no code), SplitClock in utils/conv_clock_split.py's
// probe (csrc/conv_clock_split.cu), which sums a block's cycles by part
// (kLapFma2: the FMAs of a two-phase walk's second phase, fused_ring.cuh).
enum Lap { kLapWait = 0, kLapFma = 1, kLapEpilogue = 2, kLapFma2 = 3 };

struct NoClock {
  __device__ __forceinline__ void lap(int) {}
};

struct SplitClock {
  long long t = 0, part[4] = {0, 0, 0, 0};
  __device__ __forceinline__ void start() { t = clock64(); }
  __device__ __forceinline__ void lap(int p) {
    const long long now = clock64();
    part[p] += now - t;
    t = now;
  }
};

template <int COUT>
struct Tile {
  static_assert(COUT == 8 || COUT == 16 || COUT == 32 || COUT == 64,
                "kernels are built for 8, 16, 32 or 64 output channels");
  static constexpr int NCG = COUT / kTN;            // lanes sharing one pixel group: 1 to 8
  static constexpr int NPG = COUT == 64 ? 32 : 64;  // pixel groups per block
  static constexpr int THREADS = NPG * NCG;         // 64, 128, 256 or 256
  static constexpr int TW = 4 * kTM;                // output columns per block (4 groups across)
  static constexpr int TH = NPG / 4;                // output rows per block: 16, or 8 at 64
};

// Output channel of a lane's n-th accumulator: two runs of 4, at 4*cg and
// 4*NCG + 4*cg, so the lanes of a quarter warp read one contiguous 128-byte
// span of a weight row (no bank conflicts) with two float4 loads each.
template <int COUT>
__device__ __forceinline__ int channel_of(int cg, int n) {
  constexpr int NCG = Tile<COUT>::NCG;
  return n < 4 ? 4 * cg + n : 4 * NCG + 4 * cg + (n - 4);
}

__device__ __forceinline__ void fma8(float (&a)[kTN], float v, const float4& w0,
                                     const float4& w1) {
  a[0] = fmaf(v, w0.x, a[0]);
  a[1] = fmaf(v, w0.y, a[1]);
  a[2] = fmaf(v, w0.z, a[2]);
  a[3] = fmaf(v, w0.w, a[3]);
  a[4] = fmaf(v, w1.x, a[4]);
  a[5] = fmaf(v, w1.y, a[5]);
  a[6] = fmaf(v, w1.z, a[6]);
  a[7] = fmaf(v, w1.w, a[7]);
}

// Sum over the NCG lanes of a pixel group (none to add at NCG = 1). Every
// lane adds the same two operands at every level (a + b == b + a in IEEE),
// so all lanes get the same bits.
template <int COUT>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = Tile<COUT>::NCG / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// bias -> lrelu(0.2) -> x * 1/sqrt(mean_c(x^2) + 1e-8), in place, for the
// first N of a thread's M pixel rows (the stage-fused kernels hold more rows
// than the kTM of a conv tile: their conv1 share). The mean is the sum
// times inv_n, 1 / the true channel count (COUT, or fewer with zeros past
// them): at a power of two an exact product, a division's bits.
template <int COUT, int M = kTM, int N = M>
__device__ __forceinline__ void bias_lrelu_norm(float (&acc)[M][kTN],
                                                const float* __restrict__ bias, int cg,
                                                float inv_n = 1.0f / COUT) {
  static_assert(N <= M, "rows held");
  float bch[kTN];
#pragma unroll
  for (int n = 0; n < kTN; ++n) bch[n] = __ldg(bias + channel_of<COUT>(cg, n));
#pragma unroll
  for (int m = 0; m < N; ++m) {
    float ss = 0.f;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      float v = acc[m][n] + bch[n];
      v = v >= 0.f ? v : kSlope * v;
      acc[m][n] = v;
      ss += v * v;
    }
    ss = group_sum<COUT>(ss);
    const float s = 1.0f / sqrtf(ss * inv_n + kEps);
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[m][n] *= s;
  }
}

// The discriminator's epilogues: bias -> lrelu(0.2) (ACT) or bias alone, in
// place. No PixelNorm, so nothing crosses lanes.
template <int COUT, bool ACT>
__device__ __forceinline__ void bias_act(float (&acc)[kTM][kTN], const float* __restrict__ bias,
                                         int cg) {
#pragma unroll
  for (int n = 0; n < kTN; ++n) {
    const float bch = __ldg(bias + channel_of<COUT>(cg, n));
#pragma unroll
    for (int m = 0; m < kTM; ++m) {
      const float v = acc[m][n] + bch;
      acc[m][n] = (!ACT || v >= 0.f) ? v : kSlope * v;
    }
  }
}

// Store a thread's 8 pixels x 8 channels (the first kTM rows of acc) into
// NCHW, the channels below `cout` (the tile's padded ones are not stored);
// `y` points at channel 0 of the thread's first pixel, `plane` = H*W.
// Rows are 32-byte aligned because the tile's columns start at multiples of 8.
template <int COUT, int M>
__device__ __forceinline__ void store_rows(float* __restrict__ y, const float (&acc)[M][kTN],
                                           int cg, size_t plane, int cout = COUT) {
#pragma unroll
  for (int n = 0; n < kTN; ++n) {
    if (channel_of<COUT>(cg, n) >= cout) continue;
    float* p = y + static_cast<size_t>(channel_of<COUT>(cg, n)) * plane;
    reinterpret_cast<float4*>(p)[0] = make_float4(acc[0][n], acc[1][n], acc[2][n], acc[3][n]);
    reinterpret_cast<float4*>(p)[1] = make_float4(acc[4][n], acc[5][n], acc[6][n], acc[7][n]);
  }
}

// The (TH+2) x (TW+2) halo patch of a conv3x3 tile, one input channel per
// plane: patch row 0 is output row y0-1, column 0 is output column x0-1; rows
// are SW floats apart so that every row starts 16-byte aligned.
template <int COUT>
struct Patch {
  static constexpr int SH = Tile<COUT>::TH + 2;  // patch rows
  static constexpr int PW = Tile<COUT>::TW + 2;  // patch columns
  static constexpr int SW = Tile<COUT>::TW + 4;  // row stride
};

// The FMAs of kCC input channels of a 3x3 SAME conv: `xs` [kCC][SH][SW]
// holds the channels' patch, `ws` [kCC][9][COUT] their weights (tap = ky*3 +
// kx). The thread's pixels are patch row pg/4 + 1, columns 8*(pg%4) + 1 .. +8,
// accumulated into the first kTM rows of acc, and every value takes its
// products in the order (c, ky, kx).
template <int COUT, int M>
__device__ __forceinline__ void conv3x3_rows(const float (*__restrict__ xs)[Patch<COUT>::SH]
                                                                         [Patch<COUT>::SW],
                                             const float (*__restrict__ ws)[9][COUT], int cg,
                                             int pg, float (&acc)[M][kTN]) {
  constexpr int NCG = Tile<COUT>::NCG;
  const int pgx = pg % 4;
  const int ty = pg / 4;
#pragma unroll 2
  for (int c = 0; c < kCC; ++c) {
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      const float* src = &xs[c][ty + ky][pgx * kTM];
      const float4 a = reinterpret_cast<const float4*>(src)[0];
      const float4 b = reinterpret_cast<const float4*>(src)[1];
      const float2 d = reinterpret_cast<const float2*>(src)[4];
      const float xin[kTM + 2] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, d.x, d.y};
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* wrow = &ws[c][ky * 3 + kx][0];
        const float4 w0 = reinterpret_cast<const float4*>(wrow)[cg];
        const float4 w1 = reinterpret_cast<const float4*>(wrow)[NCG + cg];
#pragma unroll
        for (int m = 0; m < kTM; ++m) fma8(acc[m], xin[m + kx], w0, w1);
      }
    }
  }
}

// 3x3 SAME conv of one image `xb` [C][H][W] with weights `w` [C][9][COUT]
// (tap = ky*3 + kx), accumulated into the thread's registers for the block's
// tile: rows y0..y0+TH-1, columns x0..x0+TW-1. The thread's pixels are
// row y0 + pg/4, columns x0 + 8*(pg%4) + 0..7. Each step stages kCC input
// channels of the (TH+2) x (TW+2) halo patch, zero outside the image, and
// their weights.
//
// `clk` (the probe's) is read after each step's staging and after its FMAs.
template <int COUT, class Clock = NoClock>
__device__ __forceinline__ void conv3x3_accumulate(const float* __restrict__ xb,
                                                   const float* __restrict__ w, int C,
                                                   int H, int W, int y0, int x0,
                                                   float (&acc)[kTM][kTN],
                                                   Clock* clk = nullptr) {
  using T = Tile<COUT>;
  constexpr int SH = Patch<COUT>::SH;
  constexpr int PW = Patch<COUT>::PW;
  constexpr int SW = Patch<COUT>::SW;
  __shared__ __align__(16) float xs[kCC][SH][SW];
  __shared__ __align__(16) float ws[kCC][9][COUT];

  const int tid = threadIdx.x;
  const int cg = tid % T::NCG;
  const int pg = tid / T::NCG;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    for (int e = tid; e < kCC * SH * PW; e += T::THREADS) {
      const int col = e % PW;
      const int t = e / PW;
      const int r = t % SH;
      const int c = t / SH;
      const int gy = y0 - 1 + r;
      const int gx = x0 - 1 + col;
      xs[c][r][col] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                          ? __ldg(xb + (static_cast<size_t>(c0 + c) * H + gy) * W + gx)
                          : 0.f;
    }
    const float4* wsrc = reinterpret_cast<const float4*>(w + static_cast<size_t>(c0) * 9 * COUT);
    float4* wdst = reinterpret_cast<float4*>(&ws[0][0][0]);
    for (int e = tid; e < kCC * 9 * COUT / 4; e += T::THREADS) wdst[e] = __ldg(wsrc + e);
    __syncthreads();
    if (clk) clk->lap(kLapWait);

    conv3x3_rows<COUT>(xs, ws, cg, pg, acc);
    __syncthreads();
    if (clk) clk->lap(kLapFma);
  }
}

// The final stage's tail after conv2's epilogue: 1x1 toRGB + bias -> prev +
// alpha * (rgb - prev) -> (U8: tanh -> rint((t + 1) * 127.5) -> clip ->
// uint8), NHWC. The thread's pixels are row gy, columns gx0 .. gx0+7 of image
// b (the first kTM rows of acc); `prev(k, gy, gx)` is channel k of the
// previous stage's RGB under output pixel (gy, gx). toRGB's dot is reduced
// across the NCG lanes of a pixel group by shuffles, and one lane of the group
// writes each pixel. Rounding is rintf (half to even), as jnp.round: roundf
// would round half away from zero.
template <int COUT, bool U8, class Prev, int M>
__device__ __forceinline__ void rgb_blend_store(const float (&acc)[M][kTN],
                                                const float* __restrict__ rgb_w,
                                                const float* __restrict__ rgb_b, float alpha,
                                                void* __restrict__ out, int cg, int b, int gy,
                                                int gx0, int H, int W, Prev prev) {
  float rw[3][kTN];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int n = 0; n < kTN; ++n) rw[k][n] = __ldg(rgb_w + k * COUT + channel_of<COUT>(cg, n));
  const float rb[3] = {__ldg(rgb_b), __ldg(rgb_b + 1), __ldg(rgb_b + 2)};
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    float rgb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float p = 0.f;
#pragma unroll
      for (int n = 0; n < kTN; ++n) p = fmaf(acc[m][n], rw[k][n], p);
      rgb[k] = group_sum<COUT>(p);  // all lanes take part in the shuffles
    }
    if (m % Tile<COUT>::NCG == cg) {  // one lane of the group writes pixel m
      const int gx = gx0 + m;
      const size_t o = ((static_cast<size_t>(b) * H + gy) * W + gx) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float pv = prev(k, gy, gx);
        const float v = pv + alpha * ((rgb[k] + rb[k]) - pv);
        if constexpr (U8) {
          const float t = tanhf(v);
          const float q = fminf(fmaxf(rintf((t + 1.0f) * 127.5f), 0.f), 255.f);
          static_cast<unsigned char*>(out)[o + k] = static_cast<unsigned char>(q);
        } else {
          static_cast<float*>(out)[o + k] = v;
        }
      }
    }
  }
}

}  // namespace probgan

extern "C" const char* probgan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
