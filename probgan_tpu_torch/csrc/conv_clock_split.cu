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
// And the stage-fused kernels B10 / B11 (fused_ring.cuh, probgan_conv_clock_split_fused)
// in four parts: wait, conv1's FMAs, conv2's FMAs, and the epilogues (conv1's into
// shared memory with the carried rows' move, conv2's with its stores or RGB tail);
// FusedTally also records each tile the walk takes (its image, first row, first column
// and whether it starts a run) and counts the conv1 pixels it stores into shared memory.
// Run by utils/conv_clock_split.py, which builds it on first use.
#include "conv_ring.cuh"
#include "fused_ring.cuh"

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
  conv3x3_accumulate<COUT, SplitClock>(x + static_cast<size_t>(b) * C * H * W,
                                       w + static_cast<size_t>(slab) * C * 9 * COUT, C, H, W,
                                       y0, x0, acc, &clk);
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

// The stage-fused walk's record: tiles [n_tiles][4] (image, first row,
// first column, starts a run) written by thread 0 as conv1's epilogue of the
// tile begins; each lane of channel group 0 counts the conv1 pixels it
// stores into mid (one a pixel, halo and zero padding included).
struct FusedTally {
  int* tiles;
  long long pixels = 0;
  __device__ __forceinline__ void tile(int t, int b, int y0, int x0, bool first) {
    if (threadIdx.x == 0) {
      int* o = tiles + 4 * static_cast<size_t>(t);
      o[0] = b;
      o[1] = y0;
      o[2] = x0;
      o[3] = first;
    }
  }
  __device__ __forceinline__ void pixel() { ++pixels; }
};

template <int COUT, int TAIL>
__global__ void __launch_bounds__(kThreads, 1)
    fused_split_kernel(const float* __restrict__ x, const float* __restrict__ wk1,
                       const float* __restrict__ b1, const float* __restrict__ w2,
                       const float* __restrict__ b2, const float* __restrict__ rgb_w,
                       const float* __restrict__ rgb_b, const float* __restrict__ prev_w,
                       const float* __restrict__ prev_b, float alpha, void* __restrict__ y,
                       int C, int H, int W, int n_tiles, int per_block, int extra,
                       long long* __restrict__ clocks, int* __restrict__ tiles,
                       unsigned long long* __restrict__ pixels) {
  SplitClock clk;
  FusedTally tally{tiles};
  clk.start();
  fused_walk<COUT, TAIL>(x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha, y, C, H, W,
                         n_tiles, per_block, extra, clk, tally);
  if (threadIdx.x == 0)
    for (int p = 0; p < 4; ++p) clocks[4 * blockIdx.x + p] = clk.part[p];
  if (tally.pixels) atomicAdd(pixels, static_cast<unsigned long long>(tally.pixels));
}

template <int COUT, int TAIL>
int launch_fused_split(const float* x, const float* wk1, const float* b1, const float* w2,
                       const float* b2, const float* rgb_w, const float* rgb_b,
                       const float* prev_w, const float* prev_b, float alpha, void* y, int B,
                       int C, int H, int W, int n_blocks, int per_block, int extra, int smem,
                       long long* clocks, int* tiles, unsigned long long* pixels,
                       cudaStream_t stream) {
  const long long n_tiles =
      fused_checked_tiles<COUT, TAIL>(B, C, H, W, n_blocks, per_block, extra, smem);
  if (n_tiles < 1) return cudaErrorInvalidValue;
  const auto kernel = fused_split_kernel<COUT, TAIL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, kThreads, smem, stream>>>(x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b,
                                               alpha, y, C, H, W, static_cast<int>(n_tiles),
                                               per_block, extra, clocks, tiles, pixels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// packed_upconv_conv's arguments (tail 0; rgb_w .. prev_b null) or
// packed_upconv_conv_rgb's (tail 1 fp32, 2 uint8); clocks [blocks][4] int64
// cycles by part (wait, conv1's FMAs, epilogues, conv2's FMAs); tiles
// [n_tiles][4] int32 the walk's record of each tile; pixels one uint64 (zeroed
// by the caller) the conv1 pixels stored into mid.
extern "C" int probgan_conv_clock_split_fused(const float* x, const float* wk1, const float* b1,
                                              const float* w2, const float* b2,
                                              const float* rgb_w, const float* rgb_b,
                                              const float* prev_w, const float* prev_b,
                                              float alpha, void* y, int tail, int B, int C,
                                              int H, int W, int cout, int n_blocks,
                                              int per_block, int extra, int smem,
                                              long long* clocks, int* tiles,
                                              unsigned long long* pixels, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
#define PROBGAN_FUSED_SPLIT(CO, TA)                                                          \
  launch_fused_split<CO, TA>(x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha, y, B, C, \
                             H, W, n_blocks, per_block, extra, smem, clocks, tiles, pixels, s)
  if (cout == 64)
    return tail == 0   ? PROBGAN_FUSED_SPLIT(64, kFeatures)
           : tail == 1 ? PROBGAN_FUSED_SPLIT(64, kRgbF32)
                       : PROBGAN_FUSED_SPLIT(64, kRgbU8);
  if (cout == 32)
    return tail == 0   ? PROBGAN_FUSED_SPLIT(32, kFeatures)
           : tail == 1 ? PROBGAN_FUSED_SPLIT(32, kRgbF32)
                       : PROBGAN_FUSED_SPLIT(32, kRgbU8);
#undef PROBGAN_FUSED_SPLIT
  return cudaErrorInvalidValue;
}

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
