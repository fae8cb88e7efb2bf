// packed_conv_rgb: the final generator stage's tail in one kernel.
//   3x3 SAME conv + bias -> LeakyReLU(0.2) -> PixelNorm -> 1x1 toRGB + bias
//   -> prev + alpha * (rgb - prev), prev = nearest-2x of rgb_prev
//   -> (uint8) tanh -> rint((t + 1) * 127.5) -> clip [0, 255]
// written straight to NHWC [B][H][W][3]; the final feature map never leaves
// registers.
//
// Replaces probgan_tpu/ops/pallas_packed.py:678 `packed_conv_rgb`
// (emit_uint8=True on the serving path), the stage-8 conv2 of the 1024^2
// generator: 32 -> 32 channels at 1024^2, then RGB (64 -> 64 at 512^2 when
// the generator ends at stage 7).
//
// Bound on the H100: operations. Per image the conv does 2*9*32*32*1024^2 =
// 19.3 GFLOP (+0.2 for toRGB) and moves 128 MB in, 3 MB of uint8 out:
// ~150 FLOP per byte, above the fp32 balance point of 20 FLOP/byte, so the
// ceiling is the CUDA cores' 67 TFLOP/s (no TF32 at the parity grade): 0.583
// ms at batch 2.
//
// Design against that bound: the main loop is packed_conv's pipelined ring
// (conv_ring.cuh ConvRgbRing: ConvRing<COUT, true>'s tiles, cp.async stages
// of 16 input channels, 3 stages, one persistent block an SM), so the next
// tile's copies are in flight while this tile's tail runs. The tail
// (conv_tile.cuh rgb_blend_store) reduces the toRGB dot across the lanes of
// a pixel group by shuffles and runs the blend and denorm in registers, so
// the kernel adds a few hundred FLOP per pixel to the conv and writes 3
// values per pixel. Every value keeps its fmaf chain in (input channel, ky,
// kx) order and the lane -> channel map, so the outputs have the bits of the
// synchronous loop (conv_tile.cuh conv3x3_accumulate) this kernel ran before.
//
// Cout 16 and 8 (a narrow generator's last stage, e.g. fmap_base 2048 at
// 1024²: 8 -> 8 at 1024²) run the same ring on blocks of 128 and 64 threads
// over the 32-channel tile, 8 input channels a stage, two blocks an SM; a
// pixel group is 2 lanes or 1, so toRGB's dot takes one shuffle or none.
// Any Cout from 1 to 64 and C >= 1 (4 -> 4 and 2 -> 2 at 1024² for
// fmap_base 1024 and 512, 12 -> 12 for 3072) run on the tile just above
// Cout, the weights, bias and toRGB weights zero-padded by the wrapper: the
// padded features are 0 and add 0 to toRGB's dot; PixelNorm divides by the
// true Cout (conv_tile.cuh).
#include "conv_ring.cuh"

namespace probgan {

template <int COUT, bool U8>
__global__ void __launch_bounds__(Tile<COUT>::THREADS, 1)
    packed_conv_rgb_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, const float* __restrict__ rgb_w,
                           const float* __restrict__ rgb_b, const float* __restrict__ prev,
                           float alpha, void* __restrict__ out, int C, int H, int W,
                           int cout, int n_tiles) {
  extern __shared__ __align__(16) float ring_smem[];
  ConvRgbRing<COUT, U8> cv(x, w, bias, rgb_w, rgb_b, prev, alpha, out, C, H, W, cout);
  NoClock clk;
  ring_walk(cv, ring_smem, n_tiles, clk);
}

template <int COUT, bool U8>
int launch(const float* x, const float* w, const float* bias, const float* rgb_w,
           const float* rgb_b, const float* prev, float alpha, void* out, int B, int C, int H,
           int W, int cout, int n_blocks, int smem, cudaStream_t stream) {
  using T = Tile<COUT>;
  using Ring = ConvRgbRing<COUT, U8>;
  const long long n_tiles = static_cast<long long>(B) * (H / T::TH) * (W / T::TW);
  if (B < 1 || C < 1 || cout < 1 || cout > COUT || W % T::TW || H % T::TH || n_tiles < 1 ||
      n_tiles > 0x7fffffff || n_blocks < 1 || smem != Ring::kBytes)
    return cudaErrorInvalidValue;
  const auto kernel = packed_conv_rgb_kernel<COUT, U8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, T::THREADS, smem, stream>>>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, C,
                                                 H, W, cout, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W] (16-byte aligned, C >= 1), w [C][3][3][T], bias [T], rgb_w
// [3][T] (T the least of 8, 16, 32 and 64 at or above Cout, 1 to 64; zeros
// past Cout), rgb_b [3], prev [B][3][H/2][W/2] -> out [B][H][W][3],
// uint8 if emit_uint8 else fp32 pre-tanh RGB; n_blocks persistent blocks
// (ops/packed.py:persistent_blocks) and the ring's dynamic shared memory in
// bytes (ops/packed.py:conv_ring_bytes, checked against the kernel's).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_conv_rgb(const float* x, const float* w, const float* bias,
                                       const float* rgb_w, const float* rgb_b,
                                       const float* prev, float alpha, void* out,
                                       int emit_uint8, int B, int C, int H, int W, int cout,
                                       int n_blocks, int smem, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
#define PROBGAN_RGB(CO)                                                                      \
  (emit_uint8                                                                                \
       ? launch<CO, true>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, B, C, H, W, cout,      \
                          n_blocks, smem, s)                                                 \
       : launch<CO, false>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, B, C, H, W, cout,     \
                           n_blocks, smem, s))
  if (cout < 1 || cout > 64) return cudaErrorInvalidValue;
  if (cout <= 8) return PROBGAN_RGB(8);
  if (cout <= 16) return PROBGAN_RGB(16);
  if (cout <= 32) return PROBGAN_RGB(32);
  return PROBGAN_RGB(64);
#undef PROBGAN_RGB
}
