// packed_conv: 3x3 SAME conv + bias -> epilogue, fp32 NCHW. The epilogue is
// LeakyReLU(0.2) -> PixelNorm ("lrelu_norm", the generator), LeakyReLU(0.2)
// alone ("lrelu", the discriminator's conv1) or nothing ("none").
//
// Replaces probgan_tpu/ops/pallas_packed.py:382 `packed_conv`: the stage-7
// conv2 of the 1024^2 generator (64 -> 64 channels at 512^2, "lrelu_norm")
// and the conv1 of the discriminator's two first blocks (32 -> 32 at 1024^2,
// 64 -> 64 at 512^2, "lrelu").
//
// Bound on the H100: operations. Per image the conv does 2*9*64*64*512^2 =
// 19.3 GFLOP and moves 2 * 64 MB (input read once, output written once):
// ~300 FLOP per byte, far above the card's fp32 balance point of 67 TFLOP/s
// over 3.35 TB/s = 20 FLOP/byte. The parity grade is fp32 without TF32, so
// the tensor cores do not apply and the ceiling is the CUDA cores' 67 TFLOP/s.
//
// Design against that bound: register tiling (8 pixels x 8 channels a
// thread) gives 192 FMAs per 9 shared-memory loads in the inner loop; the
// 147 KB of weights stream through shared memory 8 input channels at a time
// (with the matching halo patch), so each block reads them once from L2;
// the epilogue runs in registers and writes the features once. The PixelNorm
// step is a template parameter: the discriminator's form compiles it out.
#include "conv_tile.cuh"

namespace probgan {

enum Epilogue { kLreluNorm = 0, kLrelu = 1, kNone = 2 };

template <int COUT, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
    packed_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y, int C, int H,
                       int W) {
  using T = Tile<COUT>;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * T::TH;
  const int x0 = blockIdx.x * T::TW;
  float acc[kTM][kTN] = {};
  conv3x3_accumulate<COUT>(x + static_cast<size_t>(b) * C * H * W, w, C, H, W, y0, x0, acc);

  const int cg = threadIdx.x % T::NCG;
  const int pg = threadIdx.x / T::NCG;
  if constexpr (EPI == kLreluNorm)
    bias_lrelu_norm<COUT>(acc, bias, cg);
  else
    bias_act<COUT, EPI == kLrelu>(acc, bias, cg);
  const size_t plane = static_cast<size_t>(H) * W;
  store_rows<COUT>(y + static_cast<size_t>(b) * COUT * plane +
                       static_cast<size_t>(y0 + pg / 4) * W + x0 + (pg % 4) * kTM,
                   acc, cg, plane);
}

template <int COUT>
int launch(const float* x, const float* w, const float* bias, float* y, int B, int C, int H,
           int W, int epilogue, cudaStream_t stream) {
  using T = Tile<COUT>;
  if (C % kCC || W % T::TW || H % T::TH) return cudaErrorInvalidValue;
  const dim3 grid(W / T::TW, H / T::TH, B);
  if (epilogue == kLreluNorm)
    packed_conv_kernel<COUT, kLreluNorm><<<grid, kThreads, 0, stream>>>(x, w, bias, y, C, H, W);
  else if (epilogue == kLrelu)
    packed_conv_kernel<COUT, kLrelu><<<grid, kThreads, 0, stream>>>(x, w, bias, y, C, H, W);
  else if (epilogue == kNone)
    packed_conv_kernel<COUT, kNone><<<grid, kThreads, 0, stream>>>(x, w, bias, y, C, H, W);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], w [C][3][3][Cout] (eq-LR scaled), bias [Cout] -> y [B][Cout][H][W];
// epilogue 0 = lrelu_norm, 1 = lrelu, 2 = none.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_conv(const float* x, const float* w, const float* bias, float* y,
                                   int B, int C, int H, int W, int cout, int epilogue,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cout == 64) return probgan::launch<64>(x, w, bias, y, B, C, H, W, epilogue, s);
  if (cout == 32) return probgan::launch<32>(x, w, bias, y, B, C, H, W, epilogue, s);
  return cudaErrorInvalidValue;
}
