// packed_convpool_bf16: kernel modes "default" (one bf16 pass) and "mid" (the
// 2-term split) of packed_convpool: 3x3 SAME conv of x rounded to bf16 (or
// at "mid" as bf16(x) + bf16(x - bf16(x))) against bf16-rounded weights, fp32
// sums, + bias -> LeakyReLU(0.2) ("lrelu") or nothing ("none") -> 2x2 mean
// pool, fp32 NCHW in and out. Only the pooled tensor is written.
//
// Replaces probgan_tpu/ops/pallas_packed.py:452 `packed_convpool` at modes
// "default" and "mid" (`prep_conv_weights` :374, `stack_weights` :122,
// `_stack_x` :144): the discriminator's conv2 + downsample at the "fast"
// grade ("mid") and at packed_train_mode "default" / "mid" ("lrelu": 32 -> 64
// at 1024^2 -> 512^2, 64 -> 128 at 512^2 -> 256^2), and x4 the upconv's input
// gradient in that train step ("none", the same shapes; in the narrow
// generator's step, fmap_base 2048, also 8 -> 16 at 1024^2, a slab of 16).
//
// Bound on the H100: at batch 2, 32 -> 64 at 1024^2 is 77.3 GFLOP a pass
// (0.078 ms at the 989 TFLOP/s of bf16), 154.6 at "mid"'s two (0.156 ms),
// and moves 268 MB of fp32 in and 134 MB out (0.120 ms at 3.35 TB/s): bytes
// at "default", operations (nearly a tie) at "mid".
//
// Design (bf16_conv.cuh): packed_conv_bf16.cu's tile (8 rows x 32 columns x
// a slab of 64 channels, slabs fastest) and main loop, with the m16 tiles
// laid over two rows of 8 columns (kPool2x8): the lane that holds pixel g of
// a row holds pixel g of the row below in d[2], d[3], so a 2x2 window's
// vertical mean is one add in a thread and its horizontal mean one xor
// shuffle of 4 lanes. The mean is taken rows first, then columns,
// 0.5 * (0.5 * (a00 + a10) + 0.5 * (a01 + a11)), after the activation, as in
// packed_convpool.cu. The layout moves no sum: each pixel is summed in
// packed_conv_bf16's order, so packed_conv "lrelu" at the same mode pooled in
// this order gives these bits (convpool_lrelu's mask recompute relies on it).
#include "bf16_conv.cuh"

namespace probgan {

template <int COUT, int NTERM, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
    packed_convpool_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                                const float* __restrict__ bias, float* __restrict__ y, int C,
                                int H, int W, int n_slabs) {
  using T = BfTile<COUT>;
  using K = ConvBf16<COUT, NTERM>;
  extern __shared__ __align__(16) unsigned bf16_smem[];
  const int tiles_x = W / 32, tiles_y = H / T::TH;
  int t = blockIdx.x;
  const int slab = t % n_slabs;
  t /= n_slabs;
  const int x0 = (t % tiles_x) * 32;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * T::TH;
  const int b = t / tiles_y;
  float acc[T::MT][T::NT][4];
  conv_bf16_tile<COUT, NTERM, kPool2x8>(
      acc, bf16_smem, x, wk + static_cast<size_t>(slab) * bf16_chunks(C) * K::kWWords, b, y0,
      x0, C, H, W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int Hp = H / 2, Wp = W / 2;
  const size_t plane = static_cast<size_t>(Hp) * Wp;
  const int odd = g & 1;  // even lanes store channel 2 tq, odd ones 2 tq + 1
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    bias_act_frag<T::NT, EPI>(acc[mt], bias + slab * COUT);
    // rows y0 + 2 (q / 4), + 1 and columns x0 + 8 (q % 4) + g pool into
    // row y0 / 2 + q / 4, column x0 / 2 + 4 (q % 4) + g / 2
    const int q = warp * T::MT + mt;
    float* row = y + (static_cast<size_t>(b) * n_slabs + slab) * COUT * plane +
                 static_cast<size_t>(y0 / 2 + q / 4) * Wp + x0 / 2 + 4 * (q % 4) + g / 2;
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      // channels 8 nt + 2 tq (+ 1): the column's two rows, then the column g ^ 1
      // of the same window (a + b == b + a: both lanes get the same bits)
      const float v0 = 0.5f * (acc[mt][nt][0] + acc[mt][nt][2]);
      const float v1 = 0.5f * (acc[mt][nt][1] + acc[mt][nt][3]);
      const float p0 = 0.5f * (v0 + __shfl_xor_sync(0xffffffffu, v0, 4));
      const float p1 = 0.5f * (v1 + __shfl_xor_sync(0xffffffffu, v1, 4));
      row[static_cast<size_t>(8 * nt + 2 * tq + odd) * plane] = odd ? p1 : p0;
    }
  }
}

template <int COUT, int NTERM, int EPI>
int launch(const float* x, const unsigned* wk, const float* bias, float* y, int B, int C, int H,
           int W, int cout, int smem, cudaStream_t stream) {
  using K = ConvBf16<COUT, NTERM>;
  const int n_slabs = cout / COUT;
  const long long n_tiles =
      static_cast<long long>(B) * (H / BfTile<COUT>::TH) * (W / 32) * n_slabs;
  if (B < 1 || C < 8 || C % 8 || H % BfTile<COUT>::TH || W < 32 || W % 32 ||
      cout % COUT || n_tiles > 0x7fffffff || smem != K::kBytes)
    return cudaErrorInvalidValue;
  const auto kernel = packed_convpool_bf16_kernel<COUT, NTERM, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(x, wk, bias, y, C, H, W,
                                                                      n_slabs);
  return static_cast<int>(cudaGetLastError());
}

template <int NTERM, int EPI>
int launch_slab(const float* x, const unsigned* wk, const float* bias, float* y, int B, int C,
                int H, int W, int cout, int smem, cudaStream_t stream) {
  if (cout > 0 && cout % 64 == 0)
    return launch<64, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  if (cout > 0 && cout % 32 == 0)
    return launch<32, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  if (cout > 0 && cout % 16 == 0)
    return launch<16, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  if (cout > 0 && cout % 8 == 0)
    return launch<8, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace probgan

// x [B][C][H][W] fp32, wk [Cout/slab][ceil(C/32)][9][slab][40] bf16
// (ops/packed.py conv_bf16_weights, packed_conv_bf16's layout; slab the
// largest of 64, 32, 16 and 8 that divides Cout), bias [Cout] -> y
// [B][Cout][H/2][W/2]; terms 1 ("default") or 2 ("mid"); act 1 =
// LeakyReLU(0.2) before the pool, 0 = none; Cout a
// multiple of 8, C % 8 == 0, H % (8 at a slab of 64, else 16) == 0,
// W % 32 == 0; smem the block's
// dynamic shared memory in bytes (ops/packed.py bf16_conv_bytes). Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_convpool_bf16(const float* x, const void* wk, const float* bias,
                                            float* y, int B, int C, int H, int W, int cout,
                                            int terms, int act, int smem, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
#define PROBGAN_POOL_LAUNCH(NT, EPI) launch_slab<NT, EPI>(x, w, bias, y, B, C, H, W, cout, smem, s)
  if (terms == 1) return act ? PROBGAN_POOL_LAUNCH(1, kLrelu) : PROBGAN_POOL_LAUNCH(1, kNone);
  if (terms == 2) return act ? PROBGAN_POOL_LAUNCH(2, kLrelu) : PROBGAN_POOL_LAUNCH(2, kNone);
#undef PROBGAN_POOL_LAUNCH
  return cudaErrorInvalidValue;
}
