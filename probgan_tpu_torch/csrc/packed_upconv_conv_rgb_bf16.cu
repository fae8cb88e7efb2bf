// packed_upconv_conv_rgb_bf16: kernel modes "default" (one bf16 pass) and
// "mid" (the 2-term split) of the whole final generator stage in one kernel.
//   nearest-2x upsample -> conv1 + bias -> LeakyReLU -> PixelNorm -> conv2 +
//   bias -> LeakyReLU -> PixelNorm -> toRGB of the features (rounded, or
//   split) + bias -> prev + alpha * (rgb - prev), prev = nearest-2x of
//   toRGB_{s-1}(x) (of the rounded, or split, input) -> (uint8) tanh ->
//   rint((t + 1) * 127.5) -> clip [0, 255]
// from fp32 NCHW [B][C][H][W] straight to NHWC [B][2H][2W][3], uint8 or fp32
// pre-tanh. Only the RGB reaches device memory. Bit-equal per mode to
// packed_upconv_bf16.cu (with its toRGB of the input) followed by
// packed_conv_rgb_bf16.cu (the design is in fused_bf16.cuh).
//
// Replaces probgan_tpu/ops/pallas_packed.py:1058 `packed_upconv_conv_rgb` at
// modes "default" and "mid": the final stage of the generator under
// PROBGAN_STAGE_FUSED=1 at the "fast" and default grades, stage 8 of the
// 1024^2 config (64 -> 32 -> 32 channels, 512^2 -> 1024^2), or stage 7 when it
// is the last one rendered (128 -> 64 -> 64, 256^2 -> 512^2); of a narrow
// generator (fmap_base 2048) 16 -> 8 at stage 8, 32 -> 16 at stage 7.
//
// Bound on the H100: operations. Per image at stage 8 conv1 does
// 2*4*64*32*1024^2 = 17.2 GFLOP, conv2 2*9*32*32*1024^2 = 19.3 GFLOP and the
// two toRGBs 0.2 GFLOP: 0.074 ms at batch 2 at 989 TFLOP/s ("mid" 0.148 ms),
// above its bytes (67 MB in and 3 MB of uint8 out a image: 0.042 ms).
#include "fused_bf16.cuh"

// x [B][C][H][W] fp32, wk1, b1, wk2, b2 as probgan_packed_upconv_conv_bf16
// takes them, rgb_w [3][Cout] and prev_w [3][C] (values rounded to bf16,
// stored as fp32), rgb_b [3], prev_b [3] -> out [B][2H][2W][3], uint8 if
// emit_uint8 else fp32 pre-tanh RGB; tally, terms, smem and the shape rules
// as probgan_packed_upconv_conv_bf16 takes them. Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int probgan_packed_upconv_conv_rgb_bf16(
    const float* x, const void* wk1, const float* b1, const void* wk2, const float* b2,
    const float* rgb_w, const float* rgb_b, const float* prev_w, const float* prev_b,
    float alpha, void* out, int emit_uint8, unsigned long long* tally, int B, int C, int H,
    int W, int cout, int terms, int smem, void* stream) {
  using namespace probgan;
  const auto w1 = static_cast<const unsigned*>(wk1);
  const auto w2 = static_cast<const unsigned*>(wk2);
  const auto s = static_cast<cudaStream_t>(stream);
  if (emit_uint8)
    return launch_fused_bf16_any<kBfRgbU8>(x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b,
                                           alpha, out, tally, B, C, H, W, cout, terms, smem, s);
  return launch_fused_bf16_any<kBfRgbF32>(x, w1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b,
                                          alpha, out, tally, B, C, H, W, cout, terms, smem, s);
}
