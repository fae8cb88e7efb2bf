// packed_conv_rgb: the final generator stage's tail in one kernel.
//   3x3 SAME conv + bias -> LeakyReLU(0.2) -> PixelNorm -> 1x1 toRGB + bias
//   -> prev + alpha * (rgb - prev), prev = nearest-2x of rgb_prev
//   -> (uint8) tanh -> rint((t + 1) * 127.5) -> clip [0, 255]
// written straight to NHWC [B][H][W][3]; the final feature map never leaves
// registers.
//
// Replaces probgan_tpu/ops/pallas_packed.py:678 `packed_conv_rgb`
// (emit_uint8=True on the serving path), the stage-8 conv2 of the 1024^2
// generator: 32 -> 32 channels at 1024^2, then RGB.
//
// Bound on the H100: operations. Per image the conv does 2*9*32*32*1024^2 =
// 19.3 GFLOP (+0.2 for toRGB) and moves 128 MB in, 3 MB of uint8 out:
// ~150 FLOP per byte, above the fp32 balance point of 20 FLOP/byte, so the
// ceiling is the CUDA cores' 67 TFLOP/s (no TF32 at the parity grade).
//
// Design against that bound: the conv main loop is packed_conv's (register
// tiles of 8 pixels x 8 channels, weights streamed through shared memory);
// the tail (conv_tile.cuh rgb_blend_store) reduces the toRGB dot across the
// lanes of a pixel group by shuffles and runs the blend and denorm in
// registers, so the kernel adds a few hundred FLOP per pixel to the conv and
// writes 3 bytes per pixel.
#include "conv_tile.cuh"

namespace probgan {

template <int COUT, bool U8>
__global__ void __launch_bounds__(kThreads, 2)
    packed_conv_rgb_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, const float* __restrict__ rgb_w,
                           const float* __restrict__ rgb_b, const float* __restrict__ prev,
                           float alpha, void* __restrict__ out, int C, int H, int W) {
  using T = Tile<COUT>;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * T::TH;
  const int x0 = blockIdx.x * T::TW;
  float acc[kTM][kTN] = {};
  conv3x3_accumulate<COUT>(x + static_cast<size_t>(b) * C * H * W, w, C, H, W, y0, x0, acc);

  const int cg = threadIdx.x % T::NCG;
  const int pg = threadIdx.x / T::NCG;
  bias_lrelu_norm<COUT>(acc, bias, cg);
  const int Hp = H / 2, Wp = W / 2;
  rgb_blend_store<COUT, U8>(acc, rgb_w, rgb_b, alpha, out, cg, b, y0 + pg / 4,
                            x0 + (pg % 4) * kTM, H, W, [&](int k, int gy, int gx) {
                              return __ldg(prev + ((static_cast<size_t>(b) * 3 + k) * Hp +
                                                   gy / 2) * Wp + gx / 2);
                            });
}

template <int COUT, bool U8>
int launch(const float* x, const float* w, const float* bias, const float* rgb_w,
           const float* rgb_b, const float* prev, float alpha, void* out, int B, int C, int H,
           int W, cudaStream_t stream) {
  using T = Tile<COUT>;
  if (C % kCC || W % T::TW || H % T::TH) return cudaErrorInvalidValue;
  const dim3 grid(W / T::TW, H / T::TH, B);
  packed_conv_rgb_kernel<COUT, U8>
      <<<grid, kThreads, 0, stream>>>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], w [C][3][3][Cout], bias [Cout], rgb_w [3][Cout], rgb_b [3],
// prev [B][3][H/2][W/2] -> out [B][H][W][3], uint8 if emit_uint8 else fp32
// pre-tanh RGB. Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_conv_rgb(const float* x, const float* w, const float* bias,
                                       const float* rgb_w, const float* rgb_b,
                                       const float* prev, float alpha, void* out,
                                       int emit_uint8, int B, int C, int H, int W, int cout,
                                       void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  if (cout == 32)
    return emit_uint8 ? launch<32, true>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, B, C, H, W, s)
                      : launch<32, false>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, B, C, H, W, s);
  if (cout == 64)
    return emit_uint8 ? launch<64, true>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, B, C, H, W, s)
                      : launch<64, false>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, B, C, H, W, s);
  return cudaErrorInvalidValue;
}
