// packed_upconv_conv: one whole non-final generator stage, fused.
//   nearest-2x upsample -> conv1 3x3 + bias -> LeakyReLU(0.2) -> PixelNorm
//   -> conv2 3x3 + bias -> LeakyReLU(0.2) -> PixelNorm
// fp32 NCHW [B][C][H][W] -> [B][Cout][2H][2W]; conv1's feature map never
// reaches device memory. Bit-equal to packed_upconv.cu followed by
// packed_conv.cu (the design is in fused_ring.cuh: persistent blocks walking
// runs of tiles down a column on a cp.async ring, conv1's halo rows carried
// from tile to tile).
//
// Replaces probgan_tpu/ops/pallas_packed.py:973 `packed_upconv_conv`, the
// stage-7 block of the 1024^2 generator under PROBGAN_STAGE_FUSED=1
// (128 -> 64 -> 64 channels, 256^2 -> 512^2), and of a narrow generator
// (fmap_base 2048: 64 -> 32 at stage 6, 32 -> 16 at stage 7).
//
// Bound on the H100: operations. Per image conv1 does 2*4*128*64*512^2 =
// 17.2 GFLOP and conv2 2*9*64*64*512^2 = 19.3 GFLOP, and the kernel moves
// 32 MB in and 64 MB out (~380 FLOP per byte, far above the fp32 balance
// point of 20): the ceiling is the CUDA cores' 67 TFLOP/s, 1.090 ms at batch
// 2. Against the pair it saves one write and one read of the 64 MB conv1 map
// a image (~0.04 ms at 3.35 TB/s) and pays conv1 on the halo columns and on
// two rows a run (+7-8% of conv1's FLOPs on the path's shapes).
#include "fused_ring.cuh"

// x [B][C][H][W] (16-byte aligned), wk1 [2][C][2][2][2][Cout] (pre-summed,
// eq-LR scaled), b1 [Cout], w2 [Cout][3][3][Cout] (eq-LR scaled), b2 [Cout]
// -> y [B][Cout][2H][2W]; n_blocks persistent blocks over ranges of
// per_block tiles (one more for the first `extra`) and the dynamic shared
// memory in bytes (ops/packed.py fused_split, fused_ring_bytes, checked
// against the kernel's); Cout 8, 16, 32 or 64. Returns the cudaError_t of
// the launch.
extern "C" int probgan_packed_upconv_conv(const float* x, const float* wk1, const float* b1,
                                          const float* w2, const float* b2, float* y, int B,
                                          int C, int H, int W, int cout, int n_blocks,
                                          int per_block, int extra, int smem, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
#define PROBGAN_FUSED(CO)                                                                    \
  if (cout == CO)                                                                            \
    return launch_fused<CO, kFeatures>(x, wk1, b1, w2, b2, nullptr, nullptr, nullptr, nullptr, \
                                       0.f, y, B, C, H, W, n_blocks, per_block, extra, smem, s);
  PROBGAN_FUSED(64)
  PROBGAN_FUSED(32)
  PROBGAN_FUSED(16)
  PROBGAN_FUSED(8)
#undef PROBGAN_FUSED
  return cudaErrorInvalidValue;
}
