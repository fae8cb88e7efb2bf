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
// Without PixelNorm a block need not own every output channel, so the grid's
// z dimension walks (image, slab of CT = 64 or 32 output channels) as in
// packed_convpool.cu: any Cout that is a multiple of 32 (the training
// backward recomputes the 64 -> 128 conv of the discriminator this way).
#include "conv_tile.cuh"

namespace probgan {

enum Epilogue { kLreluNorm = 0, kLrelu = 1, kNone = 2 };

template <int COUT, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
    packed_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y, int C, int H,
                       int W, int n_slabs) {
  using T = Tile<COUT>;
  const int b = blockIdx.z / n_slabs;
  const int slab = blockIdx.z % n_slabs;  // always 0 with PixelNorm
  const int y0 = blockIdx.y * T::TH;
  const int x0 = blockIdx.x * T::TW;
  float acc[kTM][kTN] = {};
  conv3x3_accumulate<COUT>(x + static_cast<size_t>(b) * C * H * W,
                           w + static_cast<size_t>(slab) * C * 9 * COUT, C, H, W, y0, x0, acc);

  const int cg = threadIdx.x % T::NCG;
  const int pg = threadIdx.x / T::NCG;
  if constexpr (EPI == kLreluNorm)
    bias_lrelu_norm<COUT>(acc, bias, cg);
  else
    bias_act<COUT, EPI == kLrelu>(acc, bias + slab * COUT, cg);
  const size_t plane = static_cast<size_t>(H) * W;
  store_rows<COUT>(y + (static_cast<size_t>(b) * n_slabs + slab) * COUT * plane +
                       static_cast<size_t>(y0 + pg / 4) * W + x0 + (pg % 4) * kTM,
                   acc, cg, plane);
}

template <int COUT>
int launch(const float* x, const float* w, const float* bias, float* y, int B, int C, int H,
           int W, int cout, int epilogue, cudaStream_t stream) {
  using T = Tile<COUT>;
  if (C % kCC || W % T::TW || H % T::TH || cout % COUT) return cudaErrorInvalidValue;
  const int n_slabs = cout / COUT;
  if (epilogue == kLreluNorm && n_slabs != 1) return cudaErrorInvalidValue;
  const dim3 grid(W / T::TW, H / T::TH, B * n_slabs);
  if (grid.z > 65535u) return cudaErrorInvalidValue;
  if (epilogue == kLreluNorm)
    packed_conv_kernel<COUT, kLreluNorm>
        <<<grid, kThreads, 0, stream>>>(x, w, bias, y, C, H, W, n_slabs);
  else if (epilogue == kLrelu)
    packed_conv_kernel<COUT, kLrelu>
        <<<grid, kThreads, 0, stream>>>(x, w, bias, y, C, H, W, n_slabs);
  else if (epilogue == kNone)
    packed_conv_kernel<COUT, kNone>
        <<<grid, kThreads, 0, stream>>>(x, w, bias, y, C, H, W, n_slabs);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], w [Cout/CT][C][3][3][CT] (eq-LR scaled; CT = 64 when Cout is
// a multiple of 64, else 32: for Cout 32 or 64 that is [C][3][3][Cout]),
// bias [Cout] -> y [B][Cout][H][W]; epilogue 0 = lrelu_norm (Cout 32 or 64
// only), 1 = lrelu, 2 = none.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_conv(const float* x, const float* w, const float* bias, float* y,
                                   int B, int C, int H, int W, int cout, int epilogue,
                                   void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (cout > 0 && cout % 64 == 0)
    return probgan::launch<64>(x, w, bias, y, B, C, H, W, cout, epilogue, s);
  if (cout > 0 && cout % 32 == 0)
    return probgan::launch<32>(x, w, bias, y, B, C, H, W, cout, epilogue, s);
  return cudaErrorInvalidValue;
}
