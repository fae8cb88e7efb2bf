// packed_conv_rgb_bf16: kernel modes "default" (one bf16 pass) and "mid" (the
// 2-term split) of the final generator stage's tail:
//   3x3 SAME conv of x (rounded to bf16, or at "mid" split as bf16(x) +
//   bf16(x - bf16(x))) against bf16-rounded weights (fp32 sums) + bias ->
//   LeakyReLU(0.2) -> PixelNorm -> toRGB of the features (rounded, or split)
//   with bf16-rounded weights (fp32 sums) + bias -> prev + alpha * (rgb -
//   prev), prev = nearest-2x of rgb_prev -> (uint8) tanh -> rint((t + 1) *
//   127.5) -> clip [0, 255]
// written to NHWC [B][H][W][3]; the final feature map never leaves registers.
//
// Replaces probgan_tpu/ops/pallas_packed.py:678 `packed_conv_rgb` at modes
// "default" and "mid" (`prep_conv_weights` and the toRGB `_dot` of
// :712-727, whose operands those modes round or split as the conv's), the
// stage-8 conv2 of the 1024^2 generator at the "fast" and default grades,
// and with the generator's packed mode "mid" or "default+mid": 32 -> 32
// channels at 1024^2, then RGB (64 -> 64 at 512^2 when the generator ends at
// stage 7).
//
// Bound on the H100: bytes. At batch 2 the conv does 38.7 GFLOP (0.039 ms at
// 989 TFLOP/s of bf16) and reads 268 MB of fp32 x and writes 6 MB of uint8
// (0.082 ms at 3.35 TB/s); "mid" runs twice the conv's products (0.078 ms).
//
// Design: packed_conv_bf16.cu's tile and main loop (bf16_conv.cuh
// conv_bf16_tile) and its bias -> LeakyReLU -> PixelNorm on the fragments;
// then each lane takes the toRGB products of its channels (8 * nt + 2t, + 1)
// (each feature rounded, or split, in the lane)
// for its two pixels, the quad sums them by two xor shuffles, and lane t = 0
// writes pixel g and lane t = 1 pixel g + 8 with conv_tile.cuh
// rgb_blend_store's blend and denorm.
#include "bf16_conv.cuh"

namespace probgan {

template <int COUT, int NTERM, bool U8>
__global__ void __launch_bounds__(kThreads, 2)
    packed_conv_rgb_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                                const float* __restrict__ bias, const float* __restrict__ rgb_w,
                                const float* __restrict__ rgb_b, const float* __restrict__ prev,
                                float alpha, void* __restrict__ out, int C, int H, int W) {
  using T = BfTile<COUT>;
  extern __shared__ __align__(16) unsigned bf16_smem[];
  const int tiles_x = W / 32, tiles_y = H / T::TH;
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * 32;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * T::TH;
  const int b = t / tiles_y;
  float acc[T::MT][T::NT][4];
  conv_bf16_tile<COUT, NTERM>(acc, bf16_smem, x, wk, b, y0, x0, C, H, W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const float rb[3] = {__ldg(rgb_b), __ldg(rgb_b + 1), __ldg(rgb_b + 2)};
  const int Hp = H / 2, Wp = W / 2;
  const float* pv = prev + static_cast<size_t>(b) * 3 * Hp * Wp;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    bias_lrelu_norm_frag<T::NT>(acc[mt], bias);
    float rgb[2][3];  // pixel g, pixel g + 8
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float p = 0.f;
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)  // rgb_w [3][COUT]: bf16 values (the wrapper's) in fp32
            p = fmaf(NTERM == 1 ? round_bf16(acc[mt][nt][2 * h + e])
                                : split2(acc[mt][nt][2 * h + e]),
                     __ldg(rgb_w + k * COUT + 8 * nt + 2 * tq + e), p);
        p += __shfl_xor_sync(0xffffffffu, p, 1);
        p += __shfl_xor_sync(0xffffffffu, p, 2);
        rgb[h][k] = p;
      }
    if (tq < 2) {
      const int gy = y0 + warp * T::RW + mt / 2;
      const int gx = x0 + 16 * (mt % 2) + g + 8 * tq;
      const size_t o = ((static_cast<size_t>(b) * H + gy) * W + gx) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float pk = __ldg(pv + (static_cast<size_t>(k) * Hp + gy / 2) * Wp + gx / 2);
        const float v = pk + alpha * ((rgb[tq][k] + rb[k]) - pk);
        if constexpr (U8) {
          const float th = tanhf(v);
          const float q = fminf(fmaxf(rintf((th + 1.0f) * 127.5f), 0.f), 255.f);
          static_cast<unsigned char*>(out)[o + k] = static_cast<unsigned char>(q);
        } else {
          static_cast<float*>(out)[o + k] = v;
        }
      }
    }
  }
}

template <int COUT, int NTERM, bool U8>
int launch(const float* x, const unsigned* wk, const float* bias, const float* rgb_w,
           const float* rgb_b, const float* prev, float alpha, void* out, int B, int C, int H,
           int W, int smem, cudaStream_t stream) {
  using K = ConvBf16<COUT, NTERM>;
  const long long n_tiles = static_cast<long long>(B) * (H / BfTile<COUT>::TH) * (W / 32);
  if (B < 1 || C < 8 || C % 8 || H % BfTile<COUT>::TH || W < 32 || W % 32 ||
      n_tiles > 0x7fffffff || smem != K::kBytes)
    return cudaErrorInvalidValue;
  const auto kernel = packed_conv_rgb_bf16_kernel<COUT, NTERM, U8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(
      x, wk, bias, rgb_w, rgb_b, prev, alpha, out, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W] fp32, wk [ceil(C/32)][9][Cout][40] bf16 (ops/packed.py
// conv_bf16_weights), bias [Cout], rgb_w [3][Cout] (values rounded to bf16,
// stored as fp32), rgb_b [3], prev [B][3][H/2][W/2] -> out [B][H][W][3],
// uint8 if emit_uint8 else fp32 pre-tanh RGB; terms 1 ("default") or 2
// ("mid"); Cout 8, 16, 32 or 64, C % 8 == 0, H % (8 at Cout 64, else 16) == 0,
// W % 32 == 0; smem
// the block's dynamic shared memory in bytes (ops/packed.py bf16_conv_bytes,
// checked against the kernel's). Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int probgan_packed_conv_rgb_bf16(const float* x, const void* wk, const float* bias,
                                            const float* rgb_w, const float* rgb_b,
                                            const float* prev, float alpha, void* out,
                                            int emit_uint8, int B, int C, int H, int W, int cout,
                                            int terms, int smem, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
#define PROBGAN_RGB_LAUNCH(CO, NT, U8) \
  launch<CO, NT, U8>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, B, C, H, W, smem, s)
#define PROBGAN_RGB_COUT(CO)                                                        \
  if (cout == CO) {                                                                 \
    if (terms == 1)                                                                 \
      return emit_uint8 ? PROBGAN_RGB_LAUNCH(CO, 1, true) : PROBGAN_RGB_LAUNCH(CO, 1, false); \
    if (terms == 2)                                                                 \
      return emit_uint8 ? PROBGAN_RGB_LAUNCH(CO, 2, true) : PROBGAN_RGB_LAUNCH(CO, 2, false); \
  }
  PROBGAN_RGB_COUT(8)
  PROBGAN_RGB_COUT(16)
  PROBGAN_RGB_COUT(32)
  PROBGAN_RGB_COUT(64)
#undef PROBGAN_RGB_COUT
#undef PROBGAN_RGB_LAUNCH
  return cudaErrorInvalidValue;
}
