// packed_conv_bf16: kernel mode "default" (one bf16 pass) of packed_conv's
// "lrelu_norm" epilogue: 3x3 SAME conv of bf16-rounded x and weights, fp32
// sums, + bias -> LeakyReLU(0.2) -> PixelNorm in fp32, fp32 NCHW in and out.
//
// Replaces probgan_tpu/ops/pallas_packed.py:382 `packed_conv` at mode
// "default" (the taps' weights rounded as they are, `prep_conv_weights`
// :374), the stage-7 conv2 of the 1024^2 generator at the "fast" and default
// grades: 64 -> 64 channels at 512^2.
//
// Bound on the H100: bytes. At batch 2 the conv does 38.7 GFLOP (0.039 ms
// at the 989 TFLOP/s of bf16) and moves 134 MB of fp32 in and 134 MB out
// (0.080 ms at 3.35 TB/s): ~144 FLOP a byte, under the ~295 where the
// tensor cores would become the limit.
//
// Design (bf16_conv.cuh): one block a tile of 8 rows x 32 columns x all 64
// channels (16 rows at Cout 32); the patch of 10 x 40 pixels and the chunk's
// 9 x Cout x 32 weights in shared memory as bf16, 32 input channels a chunk;
// each warp one row of two m16 tiles x eight n8 tiles; two blocks an SM.
// The epilogue runs on the mma fragments: the 4 lanes of a quad hold all
// channels of two pixels and reduce PixelNorm's sum by two xor shuffles;
// the stores of a warp fill whole 32-byte sectors (8 neighbouring pixels of
// 4 channels).
#include "bf16_conv.cuh"

namespace probgan {

template <int COUT>
__global__ void __launch_bounds__(kThreads, 2)
    packed_conv_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                            const float* __restrict__ bias, float* __restrict__ y, int C, int H,
                            int W) {
  using T = BfTile<COUT>;
  extern __shared__ __align__(16) unsigned bf16_smem[];
  const int tiles_x = W / 32, tiles_y = H / T::TH;
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * 32;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * T::TH;
  const int b = t / tiles_y;
  float acc[T::MT][T::NT][4];
  conv_bf16_tile<COUT>(acc, bf16_smem, x, wk, b, y0, x0, C, H, W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    bias_lrelu_norm_frag<T::NT>(acc[mt], bias);
    float* row = y + static_cast<size_t>(b) * COUT * plane +
                 static_cast<size_t>(y0 + warp * T::RW + mt / 2) * W + x0 + 16 * (mt % 2) + g;
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      float* p = row + static_cast<size_t>(8 * nt + 2 * tq) * plane;
      p[0] = acc[mt][nt][0];
      p[plane] = acc[mt][nt][1];
      p[8] = acc[mt][nt][2];
      p[plane + 8] = acc[mt][nt][3];
    }
  }
}

template <int COUT>
int launch(const float* x, const unsigned* wk, const float* bias, float* y, int B, int C, int H,
           int W, int smem, cudaStream_t stream) {
  using K = ConvBf16<COUT>;
  const long long n_tiles = static_cast<long long>(B) * (H / BfTile<COUT>::TH) * (W / 32);
  if (B < 1 || C < kCK || C % kCK || H % BfTile<COUT>::TH || W < 32 || W % 32 ||
      n_tiles > 0x7fffffff || smem != K::kBytes)
    return cudaErrorInvalidValue;
  const auto kernel = packed_conv_bf16_kernel<COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(x, wk, bias, y, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W] fp32, wk [C/32][9][Cout][40] bf16 (ops/packed.py
// conv_bf16_weights: eq-LR scaled, rounded to bf16, taps ky*3 + kx, 8 zeros
// after each run of 32 input channels), bias [Cout] -> y [B][Cout][H][W];
// Cout 32 or 64, C % 32 == 0, H % (8 or 16) == 0, W % 32 == 0; smem the
// block's dynamic shared memory in bytes (ops/packed.py bf16_conv_bytes,
// checked against the kernel's). Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int probgan_packed_conv_bf16(const float* x, const void* wk, const float* bias,
                                        float* y, int B, int C, int H, int W, int cout,
                                        int smem, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
  if (cout == 64) return probgan::launch<64>(x, w, bias, y, B, C, H, W, smem, s);
  if (cout == 32) return probgan::launch<32>(x, w, bias, y, B, C, H, W, smem, s);
  return cudaErrorInvalidValue;
}
