// packed_upconv_conv_bf16: kernel modes "default" (one bf16 pass) and "mid"
// (the 2-term split) of one whole non-final generator stage, fused.
//   nearest-2x upsample -> conv1 3x3 + bias -> LeakyReLU(0.2) -> PixelNorm
//   -> conv2 3x3 + bias -> LeakyReLU(0.2) -> PixelNorm
// fp32 NCHW [B][C][H][W] -> [B][Cout][2H][2W]; conv1's feature map stays in
// shared memory, rounded (split) as conv2 reads it. Bit-equal per mode to
// packed_upconv_bf16.cu followed by packed_conv_bf16.cu (the design is in
// fused_bf16.cuh).
//
// Replaces probgan_tpu/ops/pallas_packed.py:973 `packed_upconv_conv` at modes
// "default" and "mid": the stage-7 block of the 1024^2 generator under
// PROBGAN_STAGE_FUSED=1 (128 -> 64 -> 64 channels, 256^2 -> 512^2) at the
// "fast" and default grades (G's "mid" and "default+mid" at "mid"), and of
// a narrow generator (fmap_base 2048: 64 -> 32 at stage 6, 32 -> 16 at 7).
//
// Bound on the H100: operations, 0.074 ms at batch 2 at 989 TFLOP/s of bf16
// ("mid" 0.148 ms), above the bytes (101 MB a image in and out, 0.060 ms).
#include "fused_bf16.cuh"

// x [B][C][H][W] fp32, wk1 [2 py][ceil(C/32)][2 px][4 (dy, dx)][Cout][40] bf16
// (ops/packed.py upconv_bf16_weights), b1 [Cout], wk2 [ceil(Cout/32)][9][Cout][40]
// bf16 (conv_bf16_weights), b2 [Cout] -> y [B][Cout][2H][2W]; tally, when not
// null, gains the conv1 pixels the blocks store into their maps; Cout 8, 16,
// 32 or 64, terms 1 ("default") or 2 ("mid"), C % 8 == 0, 2H % (8 at Cout 64,
// else 16) == 0, W % 16 == 0; smem the block's dynamic shared memory in bytes
// (ops/packed.py fused_bf16_bytes, checked against the kernel's). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_upconv_conv_bf16(const float* x, const void* wk1, const float* b1,
                                               const void* wk2, const float* b2, float* y,
                                               unsigned long long* tally, int B, int C, int H,
                                               int W, int cout, int terms, int smem,
                                               void* stream) {
  using namespace probgan;
  return launch_fused_bf16_any<kBfFeatures>(
      x, static_cast<const unsigned*>(wk1), b1, static_cast<const unsigned*>(wk2), b2, nullptr,
      nullptr, nullptr, nullptr, 0.f, y, tally, B, C, H, W, cout, terms, smem,
      static_cast<cudaStream_t>(stream));
}
