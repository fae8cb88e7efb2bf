// A probe, not a kernel of any path: packed_conv's "lrelu" epilogue on the
// synchronous loop (conv_tile.cuh conv3x3_accumulate, the loop packed_conv ran before the
// ring, a grid of tiles, two blocks an SM) and on the pipelined one (conv_ring.cuh, one
// persistent block an SM), and packed_conv_rgb's uint8 tail on the ring (ConvRgbRing), each
// block summing its cycles (clock64, read by every thread, written by thread 0) into three
// parts:
//   wait      staging: the old loop's loads and first barrier; the ring's
//             wait for its stage, the barrier and the next stage's copies
//             issued;
//   fma       the FMAs of a step (the old loop: and its second barrier);
//   epilogue  bias, LeakyReLU and the stores (the ring: of each tile; B3: with
//             PixelNorm, toRGB, the blend and the uint8 denorm).
// Run by utils/conv_clock_split.py, which builds it on first use.
#include "conv_ring.cuh"

namespace probgan {

template <int COUT>
__global__ void __launch_bounds__(kThreads, 2)
    old_loop_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y, int C, int H, int W,
                    int n_slabs, long long* __restrict__ clocks) {
  using T = Tile<COUT>;
  SplitClock clk;
  clk.start();
  const int b = blockIdx.z / n_slabs;
  const int slab = blockIdx.z % n_slabs;
  const int y0 = blockIdx.y * T::TH;
  const int x0 = blockIdx.x * T::TW;
  float acc[kTM][kTN] = {};
  conv3x3_accumulate<COUT, false, SplitClock>(x + static_cast<size_t>(b) * C * H * W,
                                              w + static_cast<size_t>(slab) * C * 9 * COUT, C,
                                              H, W, y0, x0, acc, &clk);
  const int cg = threadIdx.x % T::NCG;
  const int pg = threadIdx.x / T::NCG;
  bias_act<COUT, true>(acc, bias + slab * COUT, cg);
  const size_t plane = static_cast<size_t>(H) * W;
  store_rows<COUT>(y + (static_cast<size_t>(b) * n_slabs + slab) * COUT * plane +
                       static_cast<size_t>(y0 + pg / 4) * W + x0 + (pg % 4) * kTM,
                   acc, cg, plane);
  clk.lap(kLapEpilogue);
  if (threadIdx.x == 0) {
    const size_t blk = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
                       blockIdx.x;
    for (int p = 0; p < 3; ++p) clocks[3 * blk + p] = clk.part[p];
  }
}

template <int COUT>
__global__ void __launch_bounds__(kThreads, 1)
    ring_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y, int C, int H, int W,
                int n_slabs, int n_tiles, long long* __restrict__ clocks) {
  extern __shared__ __align__(16) float ring_smem[];
  ConvRing<COUT, false> cv(x, w, bias, y, C, H, W, n_slabs);
  SplitClock clk;
  clk.start();
  ring_walk(cv, ring_smem, n_tiles, clk);
  if (threadIdx.x == 0)
    for (int p = 0; p < 3; ++p) clocks[3 * blockIdx.x + p] = clk.part[p];
}

template <int COUT>
__global__ void __launch_bounds__(kThreads, 1)
    rgb_ring_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ rgb_w,
                    const float* __restrict__ rgb_b, const float* __restrict__ prev, float alpha,
                    void* __restrict__ out, int C, int H, int W, int n_tiles,
                    long long* __restrict__ clocks) {
  extern __shared__ __align__(16) float ring_smem[];
  ConvRgbRing<COUT, true> cv(x, w, bias, rgb_w, rgb_b, prev, alpha, out, C, H, W);
  SplitClock clk;
  clk.start();
  ring_walk(cv, ring_smem, n_tiles, clk);
  if (threadIdx.x == 0)
    for (int p = 0; p < 3; ++p) clocks[3 * blockIdx.x + p] = clk.part[p];
}

template <int COUT>
int launch(const float* x, const float* w, const float* bias, void* y, int B, int C, int H,
           int W, int cout, int mode, int n_blocks, int smem, long long* clocks,
           const float* rgb_w, const float* rgb_b, const float* prev, float alpha,
           cudaStream_t stream) {
  using T = Tile<COUT>;
  const int n_slabs = cout / COUT;
  if (C % 8 || W % T::TW || H % T::TH) return cudaErrorInvalidValue;
  if (mode == 2) {
    if (n_slabs != 1 || smem != ConvRgbRing<COUT, true>::kBytes) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(rgb_ring_kernel<COUT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rgb_ring_kernel<COUT><<<n_blocks, kThreads, smem, stream>>>(
        x, w, bias, rgb_w, rgb_b, prev, alpha, y, C, H, W, B * (H / T::TH) * (W / T::TW),
        clocks);
    return static_cast<int>(cudaGetLastError());
  }
  float* yf = static_cast<float*>(y);
  if (!mode) {
    old_loop_kernel<COUT><<<dim3(W / T::TW, H / T::TH, B * n_slabs), kThreads, 0, stream>>>(
        x, w, bias, yf, C, H, W, n_slabs, clocks);
    return static_cast<int>(cudaGetLastError());
  }
  if (smem != ConvRing<COUT, false>::kBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ring_kernel<COUT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ring_kernel<COUT><<<n_blocks, kThreads, smem, stream>>>(
      x, w, bias, yf, C, H, W, n_slabs, B * (H / T::TH) * (W / T::TW) * n_slabs, clocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// packed_conv's arguments for "lrelu" (w in its slab layout); mode 0 = the
// old loop (grid of W/32 x H/TH x B*slabs blocks), 1 = the ring (n_blocks
// blocks, smem bytes), 2 = packed_conv_rgb's uint8 tail on the ring (y its
// uint8 NHWC output; rgb_w, rgb_b, prev and alpha as packed_conv_rgb takes
// them, Cout 32 or 64); clocks [blocks][3] int64 cycles by part.
extern "C" int probgan_conv_clock_split(const float* x, const float* w, const float* bias,
                                        void* y, int B, int C, int H, int W, int cout,
                                        int mode, int n_blocks, int smem, long long* clocks,
                                        const float* rgb_w, const float* rgb_b,
                                        const float* prev, float alpha, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (mode == 2 && cout != 32 && cout != 64) return cudaErrorInvalidValue;
  if (cout > 0 && cout % 64 == 0)
    return probgan::launch<64>(x, w, bias, y, B, C, H, W, cout, mode, n_blocks, smem, clocks,
                               rgb_w, rgb_b, prev, alpha, s);
  if (cout > 0 && cout % 32 == 0)
    return probgan::launch<32>(x, w, bias, y, B, C, H, W, cout, mode, n_blocks, smem, clocks,
                               rgb_w, rgb_b, prev, alpha, s);
  return cudaErrorInvalidValue;
}
