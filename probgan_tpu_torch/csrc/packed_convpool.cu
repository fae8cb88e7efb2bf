// packed_convpool: 3x3 SAME conv + bias -> LeakyReLU(0.2) (or nothing) ->
// 2x2 mean pool, fp32 NCHW. The full-resolution conv output never reaches
// device memory: only the pooled tensor is written.
//
// Replaces probgan_tpu/ops/pallas_packed.py:452 `packed_convpool`, the conv2 +
// downsample of the discriminator's two first blocks at 1024^2: 32 -> 64
// channels at 1024^2 -> 512^2, and 64 -> 128 at 512^2 -> 256^2. With the
// epilogue "none" it is the mean-pooled conv that the upconv's input gradient
// needs: 32 -> 64 at 1024^2 and 64 -> 128 at 512^2 in the 1024^2 train step,
// and at the narrow generator's (fmap_base 2048) 8 -> 16 at 1024^2 and
// 16 -> 32 at 512^2, on the blocks of 128 threads at a slab of 16 (and of 64
// at a slab of 8, which that step does not reach).
//
// Bound on the H100: operations. Per image the stage-8 call does
// 2*9*32*64*1024^2 = 38.7 GFLOP and moves 134 MB in + 67 MB out: ~190 FLOP
// per byte against the card's fp32 balance point of 20 FLOP/byte (67 TFLOP/s
// over 3.35 TB/s; this grade is fp32 without TF32, so the CUDA cores are the
// ceiling). Unfused, the conv output (268 MB per image) would be written and
// read again by the pool.
//
// Design. The implicit GEMM of conv_tile.cuh with two changes. (1) There is
// no PixelNorm, so a block need not own every output channel: the grid's z
// dimension walks (image, slab of CT = 64, 32, 16 or 8 output channels, the
// largest that divides Cout), which covers Cout = 128 with the 8 x 8 register
// tile unchanged, and the narrow discriminators' 8 -> 16 at 1024² and
// 16 -> 32 at 512² (fmap_base 2048) on blocks of 128 and 64 threads; the wrapper
// lays the weights out slab by slab so that a block's weights stay one
// contiguous stream. (2) A thread's 8 pixels are a 2 x 4 patch (the POOL map
// of conv3x3_accumulate), two whole pooling windows, so the pool is four
// adds in registers. The mean is taken rows first, then columns:
// 0.5 * (0.5 * (a00 + a10) + 0.5 * (a01 + a11)); the activation comes before
// the pool, as in the TPU kernel.
#include "conv_tile.cuh"

namespace probgan {

template <int CT, bool ACT>
__global__ void __launch_bounds__(Tile<CT>::THREADS, 2)
    packed_convpool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, float* __restrict__ y, int C, int H,
                           int W, int n_slabs) {
  using T = Tile<CT>;
  const int b = blockIdx.z / n_slabs;
  const int slab = blockIdx.z % n_slabs;
  const int y0 = blockIdx.y * T::TH;
  const int x0 = blockIdx.x * T::TW;
  float acc[kTM][kTN] = {};
  conv3x3_accumulate<CT, true>(x + static_cast<size_t>(b) * C * H * W,
                               w + static_cast<size_t>(slab) * C * 9 * CT, C, H, W, y0, x0, acc);

  const int cg = threadIdx.x % T::NCG;
  const int pg = threadIdx.x / T::NCG;
  bias_act<CT, ACT>(acc, bias + slab * CT, cg);

  // Pooled pixel (y0/2 + pg/8, x0/2 + 2*(pg%8) + j), j = 0, 1.
  const int Hp = H / 2, Wp = W / 2;
  const size_t plane = static_cast<size_t>(Hp) * Wp;
  const int cout = n_slabs * CT;
  float* out = y + (static_cast<size_t>(b) * cout + slab * CT) * plane +
               static_cast<size_t>(y0 / 2 + pg / 8) * Wp + x0 / 2 + 2 * (pg % 8);
#pragma unroll
  for (int n = 0; n < kTN; ++n) {
    float2 v;
    v.x = 0.5f * (0.5f * (acc[0][n] + acc[4][n]) + 0.5f * (acc[1][n] + acc[5][n]));
    v.y = 0.5f * (0.5f * (acc[2][n] + acc[6][n]) + 0.5f * (acc[3][n] + acc[7][n]));
    *reinterpret_cast<float2*>(out + static_cast<size_t>(channel_of<CT>(cg, n)) * plane) = v;
  }
}

template <int CT>
int launch(const float* x, const float* w, const float* bias, float* y, int B, int C, int H,
           int W, int cout, int act, cudaStream_t stream) {
  using T = Tile<CT>;
  if (C % kCC || W % T::TW || H % T::TH || cout % CT) return cudaErrorInvalidValue;
  const int n_slabs = cout / CT;
  const dim3 grid(W / T::TW, H / T::TH, B * n_slabs);
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  if (act)
    packed_convpool_kernel<CT, true><<<grid, T::THREADS, 0, stream>>>(x, w, bias, y, C, H, W,
                                                                       n_slabs);
  else
    packed_convpool_kernel<CT, false><<<grid, T::THREADS, 0, stream>>>(x, w, bias, y, C, H, W,
                                                                        n_slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], w [Cout/CT][C][3][3][CT] (eq-LR scaled, CT the largest of 64,
// 32, 16 and 8 that divides Cout), bias [Cout] -> y [B][Cout][H/2][W/2];
// act 1 = LeakyReLU(0.2) before the pool, 0 = none.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_convpool(const float* x, const float* w, const float* bias,
                                       float* y, int B, int C, int H, int W, int cout, int act,
                                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cout > 0 && cout % 64 == 0)
    return probgan::launch<64>(x, w, bias, y, B, C, H, W, cout, act, s);
  if (cout > 0 && cout % 32 == 0)
    return probgan::launch<32>(x, w, bias, y, B, C, H, W, cout, act, s);
  if (cout > 0 && cout % 16 == 0)
    return probgan::launch<16>(x, w, bias, y, B, C, H, W, cout, act, s);
  if (cout > 0 && cout % 8 == 0)
    return probgan::launch<8>(x, w, bias, y, B, C, H, W, cout, act, s);
  return cudaErrorInvalidValue;
}
