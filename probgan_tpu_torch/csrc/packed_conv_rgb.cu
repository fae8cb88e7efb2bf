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
// the toRGB dot is reduced across the 4 lanes of a pixel group by shuffles,
// and the blend and denorm run in registers, so the kernel adds a few
// hundred FLOP per pixel to the conv and writes 3 bytes per pixel.
// Rounding is rintf (half to even), as jnp.round: roundf would round
// half away from zero.
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

  float rw[3][kTN];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int n = 0; n < kTN; ++n) rw[k][n] = __ldg(rgb_w + k * COUT + channel_of<COUT>(cg, n));
  const float rb[3] = {__ldg(rgb_b), __ldg(rgb_b + 1), __ldg(rgb_b + 2)};

  const int gy = y0 + pg / 4;
  const int gx0 = x0 + (pg % 4) * kTM;
  const int Hp = H / 2, Wp = W / 2;
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
    if (m % T::NCG == cg) {  // one lane of the group writes pixel m
      const int gx = gx0 + m;
      const size_t o = ((static_cast<size_t>(b) * H + gy) * W + gx) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float pv =
            __ldg(prev + ((static_cast<size_t>(b) * 3 + k) * Hp + gy / 2) * Wp + gx / 2);
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
