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
// Design (conv_ring.cuh ConvPoolRing, on packed_conv's fp32 ring): the
// implicit GEMM of conv_tile.cuh with no PixelNorm, so a block need not own
// every output channel: persistent blocks (one an SM at slabs of 64 and 32,
// two at 16 and 8; ops/packed.py persistent_blocks) walk tiles of TH x 32
// outputs x a slab of CT = 64, 32, 16 or 8 output channels (the largest
// that divides Cout), the slab fastest, which covers Cout = 128 with the
// 8 x 8 register tile unchanged and the narrow discriminators' 8 -> 16 at
// 1024² and 16 -> 32 at 512² (fmap_base 2048) on blocks of 128 and 64
// threads; the wrapper lays the weights out slab by slab so that a block's
// weights stay one contiguous stream. Each tile's input channels stream 16
// at a time (8 at slabs of 16 and 8) through a ring of 3 shared-memory
// stages filled by cp.async while the FMAs of an earlier stage run, one
// barrier a stage. A thread's 8 pixels are a 2 x 4 patch, two whole pooling
// windows, so the pool is four adds in registers. The mean is taken rows
// first, then columns: 0.5 * (0.5 * (a00 + a10) + 0.5 * (a01 + a11)); the
// activation comes before the pool, as in the TPU kernel. Every value takes
// its FMAs in the order (input channel, ky, kx): the bits of the
// synchronous loop this kernel ran before (8 channels staged with plain
// loads between two barriers, two blocks an SM, one a tile), and of
// packed_conv "lrelu" pooled in this order.
//
// Any Cout >= 1 and any C >= 1 (the upconv's input gradient of the
// generators of fmap_base 1024, 512 and 3072: in 4 out 8, in 2 out 4, in 12
// out 24): the slabs of Cout rounded up to a multiple of 8, the wrapper's
// weights and bias zero-padded past Cout, and only the channels below Cout
// stored; input channels past C are zero in the patch and the weights
// (conv_ring.cuh), so they add exact zeros.
#include "conv_ring.cuh"

namespace probgan {

template <int CT, bool ACT>
__global__ void __launch_bounds__(Tile<CT>::THREADS, 1)
    packed_convpool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ bias, float* __restrict__ y, int C, int H,
                           int W, int n_slabs, int cout, int n_tiles) {
  extern __shared__ __align__(16) float ring_smem[];
  ConvPoolRing<CT, ACT> cv(x, w, bias, y, C, H, W, n_slabs, cout);
  NoClock clk;
  ring_walk(cv, ring_smem, n_tiles, clk);
}

template <int CT>
int launch(const float* x, const float* w, const float* bias, float* y, int B, int C, int H,
           int W, int cout, int act, int blocks, int smem, cudaStream_t stream) {
  using T = Tile<CT>;
  const int n_slabs = (cout + CT - 1) / CT;  // the last one's channels past Cout padded
  const long long n_tiles = static_cast<long long>(B) * (H / T::TH) * (W / T::TW) * n_slabs;
  if (B < 1 || C < 1 || H < T::TH || H % T::TH || W < T::TW || W % T::TW ||
      n_tiles > 0x7fffffff || blocks < 1 || blocks > n_tiles ||
      smem != ConvPoolRing<CT, true>::kBytes || reinterpret_cast<size_t>(x) % 16)
    return cudaErrorInvalidValue;
  const auto kernel = act ? packed_convpool_kernel<CT, true> : packed_convpool_kernel<CT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, T::THREADS, smem, stream>>>(x, w, bias, y, C, H, W, n_slabs, cout,
                                               static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W] 16-byte aligned, w [C8/CT][C][3][3][CT] (eq-LR scaled; C8
// Cout rounded up to a multiple of 8, CT the largest of 64, 32, 16 and 8
// that divides it, zeros past Cout), bias [C8] (zeros past Cout) ->
// y [B][Cout][H/2][W/2]; act 1 = LeakyReLU(0.2) before the pool, 0 = none;
// any Cout >= 1 and C >= 1, H % (8 at a slab of 64, else 16) == 0,
// W % 32 == 0; blocks the
// persistent blocks (1 .. tiles; ops/packed.py persistent_blocks), smem the
// block's dynamic shared memory in bytes (ops/packed.py conv_ring_bytes,
// checked against the ring's). Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int probgan_packed_convpool(const float* x, const float* w, const float* bias,
                                       float* y, int B, int C, int H, int W, int cout, int act,
                                       int blocks, int smem, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define PROBGAN_POOL(CT) probgan::launch<CT>(x, w, bias, y, B, C, H, W, cout, act, blocks, smem, s)
  if (cout < 1) return cudaErrorInvalidValue;
  const int c8 = (cout + 7) / 8 * 8;
  if (c8 % 64 == 0) return PROBGAN_POOL(64);
  if (c8 % 32 == 0) return PROBGAN_POOL(32);
  if (c8 % 16 == 0) return PROBGAN_POOL(16);
  return PROBGAN_POOL(8);
#undef PROBGAN_POOL
}
