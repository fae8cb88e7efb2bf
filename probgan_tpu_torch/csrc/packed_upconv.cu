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
// Design against that bound (conv_ring.cuh): a tile is the output rows of
// ONE parity py under 8 (Cout 64) or 16 (Cout 32) input rows and 16 input
// columns, so it stages only half the pre-summed weights (8*C*Cout floats).
// Each thread owns 4 input columns x both column parities = 8 contiguous
// output pixels x 8 channels in registers (128 FMAs per 3 input and 8 weight
// reads from shared memory, per staged channel and input row). Input
// channels stream 16 at a time through a ring of 3 cp.async stages, one
// barrier a stage, and one persistent block an SM walks the tiles (both
// parities of a patch one after the other). The toRGB of the input reuses
// the staged input rows in the py = 0 tiles. The previous loop (the
// conv3x3_accumulate pattern: 8 channels a step, scalar bounds-checked
// loads between two barriers, nothing in flight during the FMAs, 128
// registers with spills) reached 35-42% of the bound (NVIDIA H100 80GB HBM3,
// 700 W, utils/bench_kernels.py); the same pattern in B2 spent 53-66% of
// its blocks' cycles waiting on its staging (utils/conv_clock_split.py).
// This loop: 43-47% at batch 2, 50% (stage 7) at batch 8; what still holds
// it is in conv_ring.cuh's UpconvRing note.
//
// Cout 16 and 8 (a narrow generator's stages, e.g. fmap_base 2048 at 1024²:
// 32 -> 16 from 256², 16 -> 8 from 512² with the toRGB of its input) run the
// same ring on blocks of 128 and 64 threads under 16 input rows, 8 input
// channels a stage, two blocks an SM (conv_ring.cuh UpconvRing).
//
// "lrelu_norm" at any Cout from 1 to 64 and any C >= 1 (a generator whose
// last stages are narrower than 8 or no power of two: fmap_base 512 or 1024
// at 1024² ends 8 -> 4 or 4 -> 2, fmap_base 3072 runs 96 -> 48, 48 -> 24,
// 24 -> 12) runs on the tile of the width just above Cout, with the
// wrapper's zero-padded taps and bias; PixelNorm divides by the true Cout
// and only its channels are stored (conv_tile.cuh). "lrelu" (the training
// backward's recompute of those generators' stages) takes the same widths
// on the same tiles: the pre-activations of "lrelu_norm" bit for bit, one
// kernel with another epilogue.
//
// Every output value keeps its one fp32 accumulator fed by fmaf in the order
// (input channel, dy, dx) and the epilogues of conv_tile.cuh: the bits of
// the previous loop, which the stage-fused kernels (fused_ring.cuh) equal.
#include "conv_ring.cuh"

namespace probgan {

template <int COUT, bool NORM>
__global__ void __launch_bounds__(Tile<COUT>::THREADS, 1)
    packed_upconv_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                         const float* __restrict__ bias, const float* __restrict__ rgb_w,
                         const float* __restrict__ rgb_b, float* __restrict__ y,
                         float* __restrict__ rgb, int C, int H, int W, int cout,
                         int n_tiles) {
  extern __shared__ __align__(16) float ring_smem[];
  UpconvRing<COUT, NORM> cv(x, wk, bias, rgb_w, rgb_b, y, rgb, C, H, W, cout);
  NoClock clk;
  ring_walk(cv, ring_smem, n_tiles, clk);
}

template <int COUT>
int launch(const float* x, const float* wk, const float* bias, const float* rgb_w,
           const float* rgb_b, float* y, float* rgb, int B, int C, int H, int W, int cout,
           int epilogue, int n_blocks, int smem, cudaStream_t stream) {
  using Ring = UpconvRing<COUT, true>;
  const long long n_tiles = 2LL * B * (H / Ring::TH) * (W / Ring::TJ);
  // both epilogues: any C >= 1 and Cout up to the tile's
  if (B < 1 || C < 1 || cout < 1 || cout > COUT || W % Ring::TJ || H % Ring::TH || n_tiles < 1 ||
      n_tiles > 0x7fffffff || n_blocks < 1 || smem != Ring::kBytes ||
      (epilogue != 0 && epilogue != 1))
    return cudaErrorInvalidValue;
  const auto kernel =
      epilogue == 0 ? packed_upconv_kernel<COUT, true> : packed_upconv_kernel<COUT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, Tile<COUT>::THREADS, smem, stream>>>(x, wk, bias, rgb_w, rgb_b, y, rgb, C,
                                                          H, W, cout, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], wk [2][C][2][2][2][T] (pre-summed, eq-LR scaled, zeros past
// Cout), bias [T] (zeros past Cout), rgb_w [3][C] and rgb_b [3] or both null
// -> y [B][Cout][2H][2W] and, when rgb_w is given, rgb [B][3][H][W]; T the
// tile's width, the least of 8, 16, 32 and 64 at or above Cout; epilogue 0 =
// lrelu_norm, 1 = lrelu, both at Cout 1 to 64 and C >= 1 (toRGB with
// lrelu_norm only); n_blocks persistent blocks and the ring's dynamic shared memory
// in bytes (ops/packed.py:upconv_ring_bytes, checked against the kernel's);
// x and wk 16-byte aligned. Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int probgan_packed_upconv(const float* x, const float* wk, const float* bias,
                                     const float* rgb_w, const float* rgb_b, float* y,
                                     float* rgb, int B, int C, int H, int W, int cout,
                                     int epilogue, int n_blocks, int smem, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define PROBGAN_UP(CO) \
  probgan::launch<CO>(x, wk, bias, rgb_w, rgb_b, y, rgb, B, C, H, W, cout, epilogue, n_blocks, \
                      smem, s)
  if (cout < 1 || cout > 64) return cudaErrorInvalidValue;
  if (cout <= 8) return PROBGAN_UP(8);
  if (cout <= 16) return PROBGAN_UP(16);
  if (cout <= 32) return PROBGAN_UP(32);
  return PROBGAN_UP(64);
#undef PROBGAN_UP
}
