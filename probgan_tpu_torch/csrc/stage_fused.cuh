// One whole generator stage in one kernel: nearest-2x upsample -> conv1 3x3 +
// bias -> LeakyReLU(0.2) -> PixelNorm -> conv2 3x3 + bias -> LeakyReLU ->
// PixelNorm, and for the final stage toRGB and the blend with the previous
// stage's RGB (conv_tile.cuh rgb_blend_store). Shared by packed_upconv_conv.cu
// (a non-final stage, features out) and packed_upconv_conv_rgb.cu (the final
// stage, RGB out). conv1's feature map never reaches device memory.
//
// Bit-equal to the two-kernel path (packed_upconv.cu, then packed_conv.cu or
// packed_conv_rgb.cu): every value takes its products in the same order
// (conv1: input channel, then dy, then dx of its parity's pre-summed taps;
// conv2: channel, ky, kx), and both epilogues reduce PixelNorm's sum over the
// same lane -> channel map (Tile<COUT>, channel_of, group_sum). Only the
// thread layout differs.
//
// A block owns a TH x 32 tile of conv2's output (Tile<COUT>: 8 rows at 64
// channels, 16 at 32) with all COUT channels. conv2 needs conv1 on the
// (TH+2) x 34 halo around it, all channels, which the block computes first
// into shared memory ("mid", conv3x3's patch layout), zero outside the image
// (conv2's SAME padding: the epilogue of a zero-padded input is not zero).
// The halo is recomputed by the neighbouring blocks: 340 conv1 pixels per 256
// outputs at 64 channels (+33%), 612 per 512 at 32 (+20%).
//
// Phase 1 (conv1): the halo's pixels fall in four parity classes (py, px) of
// (TH/2+1) x 17 pixels each, and every pixel of a class reads a 2 x 2 window
// of the same staged input patch with that class's four pre-summed taps.
// A pixel group (the NCG lanes that share a pixel, Tile<COUT>) takes P1
// consecutive pixels of one class, 8 channels a lane: 11 pixels at 64
// channels, 10 at 32, so a lane does 11/8 or 10/8 of packed_upconv's conv1
// work. The input channels stream through shared memory KC1 at a time with
// both row parities' weights. The final stage's previous RGB (toRGB of the
// stage's input, B1's `racc`) is summed over the same staged channels by one
// thread per input pixel of the tile.
//
// Phase 2 (conv2): conv3x3_rows over mid with conv2's weights streamed kCC
// channels at a time, as in packed_conv.cu.
//
// Shared memory per block: mid COUT*(TH+2)*36 floats (92,160 B at 64
// channels, 82,944 at 32) + the staging area + the previous RGB: 111,360 B
// or 95,872 B, dynamic; two blocks would fit on an H100 multiprocessor.
#pragma once

#include "conv_tile.cuh"

namespace probgan {

enum StageTail { kFeatures = 0, kRgbF32 = 1, kRgbU8 = 2 };

template <int COUT>
struct Fused {
  using T = Tile<COUT>;
  static constexpr int TH = T::TH;             // conv2 output rows per block: 8 or 16
  static constexpr int TW = T::TW;             // conv2 output columns per block: 32
  static constexpr int MH = Patch<COUT>::SH;   // conv1 rows held: y0-1 .. y0+TH
  static constexpr int MW = Patch<COUT>::SW;   // mid row stride, column 0 = x0-1
  static constexpr int KC1 = 4;                // input channels staged per phase-1 step
  static constexpr int IH = TH / 2 + 2;        // staged input rows: y0/2-1 .. y0/2+TH/2
  static constexpr int ISW = TW / 2 + 4;       // staged input row stride (18 columns used)
  static constexpr int CR = TH / 2 + 1;        // conv1 rows of one parity class
  static constexpr int CC = TW / 2 + 1;        // conv1 columns of one parity class: 17
  static constexpr int CLASS = CR * CC;        // conv1 pixels of one parity class
  static constexpr int RUNS = T::NPG / 4;      // pixel groups per class
  static constexpr int P1 = (CLASS + RUNS - 1) / RUNS;  // conv1 pixels per pixel group
  static constexpr int PH = TH / 2, PW = TW / 2;         // input pixels under the tile
  static constexpr int MID = COUT * MH * MW;   // floats of conv1's halo
  static constexpr int XS1 = KC1 * IH * ISW;   // staged input
  static constexpr int WS1 = 2 * KC1 * 8 * COUT;  // staged pre-summed conv1 taps, both py
  static constexpr int WS2 = kCC * 9 * COUT;   // staged conv2 taps
  static constexpr int STAGE = XS1 + WS1 > WS2 ? XS1 + WS1 : WS2;
  static constexpr int PREV = 3 * PH * PW;     // the previous stage's RGB under the tile
  static constexpr size_t BYTES = sizeof(float) * (MID + STAGE + PREV);
  static_assert(XS1 % 4 == 0 && MID % 4 == 0 && STAGE % 4 == 0, "16-byte aligned parts");
  static_assert(PH * PW <= kThreads, "one thread per input pixel of the tile");
};

// x [B][C][H][W]; wk1 [2 py][C][2 px][2 dy][2 dx][COUT] (packed_upconv.cu's
// pre-summed taps), b1 [COUT]; w2 [COUT][3][3][COUT] (packed_conv.cu's
// layout), b2 [COUT]. kFeatures: y [B][COUT][2H][2W] fp32. kRgbF32 / kRgbU8:
// rgb_w [3][COUT], rgb_b [3], prev_w [3][C], prev_b [3] -> y [B][2H][2W][3]
// fp32 pre-tanh or uint8.
//
// At 64 channels a lane holds 11 conv1 pixels x 8 channels in phase 1: one
// block a multiprocessor leaves it the registers to do so without spilling,
// which ran faster on an H100 than two blocks at 128 registers with spills.
// At 32 channels (10 pixels) two blocks ran faster.
template <int COUT, int TAIL>
__global__ void __launch_bounds__(kThreads, COUT == 64 ? 1 : 2)
    stage_fused_kernel(const float* __restrict__ x, const float* __restrict__ wk1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ rgb_w,
                       const float* __restrict__ rgb_b, const float* __restrict__ prev_w,
                       const float* __restrict__ prev_b, float alpha, void* __restrict__ y,
                       int C, int H, int W) {
  using F = Fused<COUT>;
  using T = Tile<COUT>;
  constexpr bool RGB = TAIL != kFeatures;
  extern __shared__ __align__(16) float smem[];
  float* mid = smem;                          // [COUT][MH][MW]
  float* xs1 = smem + F::MID;                 // [KC1][IH][ISW]
  float* ws1 = xs1 + F::XS1;                  // [2 py][KC1][2 px][2 dy][2 dx][COUT]
  float* ws2 = smem + F::MID;                 // [kCC][9][COUT], after phase 1
  float* prev_s = smem + F::MID + F::STAGE;   // [3][PH][PW]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * F::TH;  // first conv2 output row of the tile
  const int x0 = blockIdx.x * F::TW;
  const int i0 = y0 / 2 - 1, j0 = x0 / 2 - 1;  // input origin of the staged patch
  const int Ho = 2 * H, Wo = 2 * W;
  const int tid = threadIdx.x;
  const int cg = tid % T::NCG;
  const int pg = tid / T::NCG;

  // ---- phase 1: conv1 over the halo, parity class by parity class ----
  const int cls = pg / F::RUNS;
  const int py = cls >> 1, px = cls & 1;
  const int e0 = (pg % F::RUNS) * F::P1;  // first pixel of this group in its class
  const bool prev_lane = RGB && tid < F::PH * F::PW;
  const int pr = tid / F::PW, pc = tid % F::PW;
  float racc[3] = {0.f, 0.f, 0.f};
  float acc1[F::P1][kTN] = {};
  const float* xb = x + static_cast<size_t>(b) * C * H * W;
  for (int c0 = 0; c0 < C; c0 += F::KC1) {
    for (int e = tid; e < F::KC1 * F::IH * F::ISW; e += kThreads) {
      const int col = e % F::ISW;
      const int t = e / F::ISW;
      const int r = t % F::IH;
      const int c = t / F::IH;
      const int gy = i0 + r, gx = j0 + col;
      xs1[e] = (col < F::CC + 1 && gy >= 0 && gy < H && gx >= 0 && gx < W)
                   ? __ldg(xb + (static_cast<size_t>(c0 + c) * H + gy) * W + gx)
                   : 0.f;
    }
    constexpr int kSlab = F::KC1 * 8 * COUT / 4;  // float4s of one py's staged taps
    for (int e = tid; e < 2 * kSlab; e += kThreads) {
      const int p = e / kSlab;
      reinterpret_cast<float4*>(ws1)[e] = __ldg(
          reinterpret_cast<const float4*>(wk1 + (static_cast<size_t>(p) * C + c0) * 8 * COUT) +
          e % kSlab);
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < F::KC1; ++c) {
      const float* xc = xs1 + c * F::IH * F::ISW;
      if (prev_lane) {
        const float v = xc[(pr + 1) * F::ISW + pc + 1];
#pragma unroll
        for (int k = 0; k < 3; ++k) racc[k] = fmaf(v, __ldg(prev_w + k * C + c0 + c), racc[k]);
      }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float* wrow = ws1 + ((((py * F::KC1 + c) * 2 + px) * 2 + dy) * 2 + dx) * COUT;
          const float4 w0 = reinterpret_cast<const float4*>(wrow)[cg];
          const float4 w1 = reinterpret_cast<const float4*>(wrow)[T::NCG + cg];
#pragma unroll
          for (int m = 0; m < F::P1; ++m) {
            const int e = min(e0 + m, F::CLASS - 1);
            const int a = e / F::CC, bq = e % F::CC;  // class row and column
            fma8(acc1[m], xc[(a + dy) * F::ISW + bq + dx], w0, w1);
          }
        }
      }
    }
    __syncthreads();
  }

  bias_lrelu_norm<COUT, F::P1>(acc1, b1, cg);
#pragma unroll
  for (int m = 0; m < F::P1; ++m) {
    const int e = e0 + m;
    if (e < F::CLASS) {
      const int r = 2 * (e / F::CC) + 1 - py;  // halo row: conv1 row y0 - 1 + r
      const int q = 2 * (e % F::CC) + 1 - px;  // halo column: conv1 column x0 - 1 + q
      const int oy = y0 - 1 + r, ox = x0 - 1 + q;
      const bool inside = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
#pragma unroll
      for (int n = 0; n < kTN; ++n)
        mid[(channel_of<COUT>(cg, n) * F::MH + r) * F::MW + q] = inside ? acc1[m][n] : 0.f;
    }
  }
  if (prev_lane) {
#pragma unroll
    for (int k = 0; k < 3; ++k) prev_s[(k * F::PH + pr) * F::PW + pc] = racc[k] + __ldg(prev_b + k);
  }
  __syncthreads();

  // ---- phase 2: conv2 over mid ----
  float acc[kTM][kTN] = {};
  for (int c0 = 0; c0 < COUT; c0 += kCC) {
    const float4* wsrc = reinterpret_cast<const float4*>(w2 + static_cast<size_t>(c0) * 9 * COUT);
    for (int e = tid; e < kCC * 9 * COUT / 4; e += kThreads)
      reinterpret_cast<float4*>(ws2)[e] = __ldg(wsrc + e);
    __syncthreads();
    conv3x3_rows<COUT>(
        reinterpret_cast<const float(*)[F::MH][F::MW]>(mid + c0 * F::MH * F::MW),
        reinterpret_cast<const float(*)[9][COUT]>(ws2), cg, pg, acc);
    __syncthreads();
  }

  bias_lrelu_norm<COUT>(acc, b2, cg);
  const int gy = y0 + pg / 4;
  const int gx0 = x0 + (pg % 4) * kTM;
  if constexpr (RGB) {
    rgb_blend_store<COUT, TAIL == kRgbU8>(
        acc, rgb_w, rgb_b, alpha, y, cg, b, gy, gx0, Ho, Wo, [&](int k, int oy, int ox) {
          return prev_s[(k * F::PH + (oy - y0) / 2) * F::PW + (ox - x0) / 2];
        });
  } else {
    const size_t plane = static_cast<size_t>(Ho) * Wo;
    store_rows<COUT>(static_cast<float*>(y) + static_cast<size_t>(b) * COUT * plane +
                         static_cast<size_t>(gy) * Wo + gx0,
                     acc, cg, plane);
  }
}

// Launch over the whole batch: grid (2W/32, 2H/TH, B), the dynamic shared
// memory raised above the 48 KB default first. Returns the cudaError_t of the
// launch (a block that does not fit is refused here, not run).
template <int COUT, int TAIL>
int launch_stage_fused(const float* x, const float* wk1, const float* b1, const float* w2,
                       const float* b2, const float* rgb_w, const float* rgb_b,
                       const float* prev_w, const float* prev_b, float alpha, void* y, int B,
                       int C, int H, int W, cudaStream_t stream) {
  using F = Fused<COUT>;
  if (C % F::KC1 || (2 * W) % F::TW || (2 * H) % F::TH || B > 65535) return cudaErrorInvalidValue;
  const auto kernel = stage_fused_kernel<COUT, TAIL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(F::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(2 * W / F::TW, 2 * H / F::TH, B);
  kernel<<<grid, kThreads, F::BYTES, stream>>>(x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b,
                                               alpha, y, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan
