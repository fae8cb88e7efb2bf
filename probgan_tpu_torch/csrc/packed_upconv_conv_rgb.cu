// packed_upconv_conv_rgb: the whole final generator stage in one kernel.
//   nearest-2x upsample -> conv1 + bias -> LeakyReLU -> PixelNorm -> conv2 +
//   bias -> LeakyReLU -> PixelNorm -> 1x1 toRGB + bias -> prev + alpha *
//   (rgb - prev), prev = toRGB_{s-1}(x) nearest-upsampled 2x
//   -> (uint8) tanh -> rint((t + 1) * 127.5) -> clip [0, 255]
// from fp32 NCHW [B][C][H][W] straight to NHWC [B][2H][2W][3], uint8 or fp32
// pre-tanh. Only the RGB reaches device memory. Bit-equal to packed_upconv.cu
// (with its toRGB of the input) followed by packed_conv_rgb.cu (the design is
// in fused_ring.cuh; each tile sums the previous RGB of the input pixels under
// it, once).
//
// Replaces probgan_tpu/ops/pallas_packed.py:1058 `packed_upconv_conv_rgb`,
// the final stage of the generator under PROBGAN_STAGE_FUSED=1: stage 8 of
// the 1024^2 config (64 -> 32 -> 32 channels, 512^2 -> 1024^2), or stage 7
// when it is the last one rendered (128 -> 64 -> 64, 256^2 -> 512^2); of a
// narrow generator (fmap_base 2048) 16 -> 8 at stage 8, 32 -> 16 at stage 7.
//
// Bound on the H100: operations. Per image at stage 8 conv1 does
// 2*4*64*32*1024^2 = 17.2 GFLOP, conv2 2*9*32*32*1024^2 = 19.3 GFLOP and the
// two toRGBs 0.2 GFLOP; it moves 64 MB in and 3 MB (uint8) or 12 MB out:
// 1.099 ms at batch 2 at the CUDA cores' 67 TFLOP/s.
#include "fused_ring.cuh"

// x [B][C][H][W] (16-byte aligned), wk1 [2][C][2][2][2][Cout], b1 [Cout],
// w2 [Cout][3][3][Cout], b2 [Cout], rgb_w [3][Cout], rgb_b [3], prev_w [3][C],
// prev_b [3] -> out [B][2H][2W][3], uint8 if emit_uint8 else fp32 pre-tanh
// RGB; n_blocks, per_block, extra and smem as probgan_packed_upconv_conv
// takes them; Cout 8, 16, 32 or 64. Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int probgan_packed_upconv_conv_rgb(const float* x, const float* wk1, const float* b1,
                                              const float* w2, const float* b2,
                                              const float* rgb_w, const float* rgb_b,
                                              const float* prev_w, const float* prev_b,
                                              float alpha, void* out, int emit_uint8, int B,
                                              int C, int H, int W, int cout, int n_blocks,
                                              int per_block, int extra, int smem, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
#define PROBGAN_FUSED_RGB(CO)                                                                 \
  if (cout == CO)                                                                             \
    return emit_uint8 ? launch_fused<CO, kRgbU8>(x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w,     \
                                                 prev_b, alpha, out, B, C, H, W, n_blocks,    \
                                                 per_block, extra, smem, s)                   \
                      : launch_fused<CO, kRgbF32>(x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w,    \
                                                  prev_b, alpha, out, B, C, H, W, n_blocks,   \
                                                  per_block, extra, smem, s);
  PROBGAN_FUSED_RGB(64)
  PROBGAN_FUSED_RGB(32)
  PROBGAN_FUSED_RGB(16)
  PROBGAN_FUSED_RGB(8)
#undef PROBGAN_FUSED_RGB
  return cudaErrorInvalidValue;
}
