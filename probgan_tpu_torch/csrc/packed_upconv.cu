// packed_upconv: nearest-2x upsample -> 3x3 SAME conv + bias -> LeakyReLU(0.2)
// -> PixelNorm, fp32 NCHW [B][C][H][W] -> [B][Cout][2H][2W]; optionally also
// toRGB (1x1 conv + bias) of the INPUT at input resolution [B][3][H][W].
// The PixelNorm step is a template parameter: without it ("lrelu") the kernel
// gives the pre-norm tensor that the training backward recomputes.
//
// Replaces probgan_tpu/ops/pallas_packed.py:832 `packed_upconv`, conv1 of
// the 1024^2 generator's stages 7 (128 -> 64 channels, 256^2 -> 512^2) and
// 8 (64 -> 32 channels, 512^2 -> 1024^2, with the toRGB of its input that
// packed_conv_rgb blends in).
//
// The upsampled tensor never exists. By the subpixel identity, output pixel
// (2i+py, 2j+px) is a 2x2 conv of input rows i+py-1+dy and columns
// j+px-1+dx (dy, dx in {0, 1}) with taps pre-summed per parity (see
// ops/fused_upconv.py): 16 MACs per 4 outputs instead of 36. The wrapper
// pre-sums the weights into wk [2 py][C][2 px][2 dy][2 dx][Cout].
//
// Bound on the H100: operations. Per image stage 7 does 2*4*128*64*512^2 =
// 17.2 GFLOP and moves 32 MB in, 64 MB out (~180 FLOP per byte); stage 8 the
// same FLOP over 64 + 128 MB (~90 FLOP per byte). Both are above the fp32
// balance point of 20 FLOP/byte: the ceiling is the CUDA cores' 67 TFLOP/s
// (no TF32 at the parity grade).
//
// Design against that bound: a block covers output rows of ONE parity py,
// so it stages only half the pre-summed weights (8*C*Cout floats); with 256
// (stage 7) or 512 (stage 8) output pixels a block does 64 or 128 FLOP per
// weight byte it reads from L2. Each thread owns 4 input columns x both
// column parities = 8 contiguous output pixels x 8 channels in registers
// (128 FMAs per 2 input and 8 weight loads from shared memory, per staged
// channel and input row). The toRGB of the input
// reuses the staged input rows in the py = 0 blocks.
#include "conv_tile.cuh"

namespace probgan {

template <int COUT, bool NORM>
__global__ void __launch_bounds__(kThreads, 2)
    packed_upconv_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                         const float* __restrict__ bias, const float* __restrict__ rgb_w,
                         const float* __restrict__ rgb_b, float* __restrict__ y,
                         float* __restrict__ rgb, int C, int H, int W) {
  using T = Tile<COUT>;
  constexpr int TH = T::TH;      // input rows per block (output rows of one parity)
  constexpr int TJ = T::TW / 2;  // input columns per block: 16
  constexpr int SH = TH + 1;     // staged input rows: i0+py-1 .. i0+py+TH-1
  constexpr int PW = TJ + 2;     // staged input columns: j0-1 .. j0+TJ
  constexpr int SW = TJ + 4;     // row stride, 16-byte aligned rows
  __shared__ __align__(16) float xs[kCC][SH][SW];
  __shared__ __align__(16) float ws[kCC][2][2][2][COUT];  // [c][px][dy][dx][co]

  const int b = blockIdx.z;
  const int py = blockIdx.y & 1;
  const int i0 = (blockIdx.y >> 1) * TH;
  const int j0 = blockIdx.x * TJ;
  const int tid = threadIdx.x;
  const int cg = tid % T::NCG;
  const int pg = tid / T::NCG;
  const int pgx = pg % 4;
  const int r = pg / 4;
  // toRGB of the input: the py = 0 blocks own input rows i0..i0+TH-1 (staged
  // rows 1..TH), one input pixel per thread.
  const int pr = tid / TJ, pc = tid % TJ;
  const bool rgb_lane = rgb_w != nullptr && py == 0 && tid < TH * TJ;
  float racc[3] = {0.f, 0.f, 0.f};

  float acc[kTM][kTN] = {};
  const float* xb = x + static_cast<size_t>(b) * C * H * W;
  for (int c0 = 0; c0 < C; c0 += kCC) {
    for (int e = tid; e < kCC * SH * PW; e += kThreads) {
      const int col = e % PW;
      const int t = e / PW;
      const int rr = t % SH;
      const int c = t / SH;
      const int gy = i0 + py - 1 + rr;
      const int gx = j0 - 1 + col;
      xs[c][rr][col] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                           ? __ldg(xb + (static_cast<size_t>(c0 + c) * H + gy) * W + gx)
                           : 0.f;
    }
    const float4* wsrc =
        reinterpret_cast<const float4*>(wk + (static_cast<size_t>(py) * C + c0) * 8 * COUT);
    float4* wdst = reinterpret_cast<float4*>(&ws[0][0][0][0][0]);
    for (int e = tid; e < kCC * 8 * COUT / 4; e += kThreads) wdst[e] = __ldg(wsrc + e);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kCC; ++c) {
      if (rgb_lane) {
        const float v = xs[c][pr + 1][pc + 1];
#pragma unroll
        for (int k = 0; k < 3; ++k) racc[k] = fmaf(v, __ldg(rgb_w + k * C + c0 + c), racc[k]);
      }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float* src = &xs[c][r + dy][4 * pgx];
        const float4 a = reinterpret_cast<const float4*>(src)[0];
        const float2 d = reinterpret_cast<const float2*>(src)[2];
        const float xin[6] = {a.x, a.y, a.z, a.w, d.x, d.y};
#pragma unroll
        for (int px = 0; px < 2; ++px) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float* wrow = &ws[c][px][dy][dx][0];
            const float4 w0 = reinterpret_cast<const float4*>(wrow)[cg];
            const float4 w1 = reinterpret_cast<const float4*>(wrow)[T::NCG + cg];
            // input column j0 + 4*pgx + q feeds output column 2*(4*pgx + q) + px
#pragma unroll
            for (int q = 0; q < 4; ++q) fma8(acc[2 * q + px], xin[q + px + dx], w0, w1);
          }
        }
      }
    }
    __syncthreads();
  }

  if (rgb_lane) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      rgb[((static_cast<size_t>(b) * 3 + k) * H + i0 + pr) * W + j0 + pc] =
          racc[k] + __ldg(rgb_b + k);
  }
  if constexpr (NORM)
    bias_lrelu_norm<COUT>(acc, bias, cg);
  else
    bias_act<COUT, true>(acc, bias, cg);
  const int Wo = 2 * W;
  const size_t plane = static_cast<size_t>(2 * H) * Wo;
  store_rows<COUT>(y + static_cast<size_t>(b) * COUT * plane +
                       static_cast<size_t>(2 * (i0 + r) + py) * Wo + 2 * j0 + pgx * kTM,
                   acc, cg, plane);
}

template <int COUT>
int launch(const float* x, const float* wk, const float* bias, const float* rgb_w,
           const float* rgb_b, float* y, float* rgb, int B, int C, int H, int W, int epilogue,
           cudaStream_t stream) {
  using T = Tile<COUT>;
  if (C % kCC || W % (T::TW / 2) || H % T::TH) return cudaErrorInvalidValue;
  const dim3 grid(W / (T::TW / 2), 2 * (H / T::TH), B);
  if (epilogue == 0)
    packed_upconv_kernel<COUT, true>
        <<<grid, kThreads, 0, stream>>>(x, wk, bias, rgb_w, rgb_b, y, rgb, C, H, W);
  else if (epilogue == 1)
    packed_upconv_kernel<COUT, false>
        <<<grid, kThreads, 0, stream>>>(x, wk, bias, rgb_w, rgb_b, y, rgb, C, H, W);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], wk [2][C][2][2][2][Cout] (pre-summed, eq-LR scaled),
// bias [Cout], rgb_w [3][C] and rgb_b [3] or both null -> y [B][Cout][2H][2W]
// and, when rgb_w is given, rgb [B][3][H][W]; epilogue 0 = lrelu_norm,
// 1 = lrelu. Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_upconv(const float* x, const float* wk, const float* bias,
                                     const float* rgb_w, const float* rgb_b, float* y,
                                     float* rgb, int B, int C, int H, int W, int cout,
                                     int epilogue, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cout == 64)
    return probgan::launch<64>(x, wk, bias, rgb_w, rgb_b, y, rgb, B, C, H, W, epilogue, s);
  if (cout == 32)
    return probgan::launch<32>(x, wk, bias, rgb_w, rgb_b, y, rgb, B, C, H, W, epilogue, s);
  return cudaErrorInvalidValue;
}
