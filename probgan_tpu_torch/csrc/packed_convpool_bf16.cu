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
// Design (bf16_ring.cuh ConvPoolBf16Ring, on packed_conv_bf16's ring):
// packed_conv_bf16.cu's tile (8 rows x 32 columns x a slab of 64 channels,
// 16 rows at 32, 16 and 8, slabs fastest), persistent blocks (one an SM)
// and its ring of two stages of 32 input channels (the fp32 patch, rounded
// or split as the A fragments are loaded, and the chunk's bf16 weights),
// filled by cp.async while the products of the stage before run, with the
// m16 tiles laid over two rows of 8 columns (kPool2x8): the lane that holds
// pixel g of a row holds pixel g of the row below in d[2], d[3], so a 2x2
// window's vertical mean is one add in a thread and its horizontal mean one
// xor shuffle of 4 lanes. The mean is taken rows first, then columns,
// 0.5 * (0.5 * (a00 + a10) + 0.5 * (a01 + a11)), after the activation, as in
// packed_convpool.cu. The layout moves no sum: each pixel is summed in
// packed_conv_bf16's order (chunks, taps, k16 halves, terms), the order
// bf16_ring.cuh fixes, and packed_conv "lrelu" at the same mode pooled in
// this order gives these bits (convpool_lrelu's mask recompute relies on
// it). Any Cout >= 1 and C >= 1 (the upconv's input gradient of the
// generators of fmap_base 1024, 512 and 3072: in 4 out 8, in 2 out 4, in 12
// out 24): the slabs of Cout rounded up to a multiple of 8, the wrapper's
// weights and bias zero-padded, only the channels below Cout stored; a
// partial chunk's channels past C are zero in the patch and the weights.
#include "bf16_ring.cuh"

namespace probgan {

template <int COUT, int NTERM, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    packed_convpool_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                                const float* __restrict__ bias, float* __restrict__ y, int C,
                                int H, int W, int n_slabs, int cout, int n_tiles) {
  extern __shared__ __align__(16) float bf16_ring_smem[];
  ConvPoolBf16Ring<COUT, NTERM, EPI> cv(x, wk, bias, y, C, H, W, n_slabs, cout);
  bf16_ring_walk(cv, bf16_ring_smem, n_tiles);
}

template <int COUT, int NTERM, int EPI>
int launch(const float* x, const unsigned* wk, const float* bias, float* y, int B, int C, int H,
           int W, int cout, int blocks, int smem, cudaStream_t stream) {
  using K = ConvPoolBf16Ring<COUT, NTERM, EPI>;
  const int n_slabs = (cout + COUT - 1) / COUT;  // the last one's channels past Cout padded
  const long long n_tiles =
      static_cast<long long>(B) * (H / BfTile<COUT>::TH) * (W / 32) * n_slabs;
  if (B < 1 || C < 1 || cout < 1 || H < BfTile<COUT>::TH || H % BfTile<COUT>::TH || W < 32 ||
      W % 32 || n_tiles > 0x7fffffff || blocks < 1 || blocks > n_tiles ||
      smem != K::kBytes || reinterpret_cast<size_t>(x) % 16)
    return cudaErrorInvalidValue;
  const auto kernel = packed_convpool_bf16_kernel<COUT, NTERM, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(x, wk, bias, y, C, H, W, n_slabs, cout,
                                             static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The geometry the ring was compiled with at a slab of COUT channels:
// {stages, bytes a block, blocks an SM at those bytes}.
template <int COUT, int NTERM>
int geometry(int* out) {
  return ring_geometry<ConvPoolBf16Ring<COUT, NTERM, kLrelu>>(
      packed_convpool_bf16_kernel<COUT, NTERM, kLrelu>, out);
}

template <int NTERM, int EPI>
int launch_slab(const float* x, const unsigned* wk, const float* bias, float* y, int B, int C,
                int H, int W, int cout, int blocks, int smem, cudaStream_t stream) {
#define PROBGAN_POOL_SLAB(S) \
  launch<S, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream)
  if (cout < 1) return cudaErrorInvalidValue;
  const int c8 = (cout + 7) / 8 * 8;  // slabs of Cout rounded up to a multiple of 8
  if (c8 % 64 == 0) return PROBGAN_POOL_SLAB(64);
  if (c8 % 32 == 0) return PROBGAN_POOL_SLAB(32);
  if (c8 % 16 == 0) return PROBGAN_POOL_SLAB(16);
  return PROBGAN_POOL_SLAB(8);
#undef PROBGAN_POOL_SLAB
}

}  // namespace probgan

// x [B][C][H][W] fp32, 16-byte aligned, wk [C8/slab][ceil(C/32)][9][slab]
// [40] bf16 (ops/packed.py conv_bf16_weights, packed_conv_bf16's layout; C8
// Cout rounded up to a multiple of 8, slab the largest of 64, 32, 16 and 8
// that divides it, zeros past Cout and past C), bias [C8] (zeros past Cout)
// -> y [B][Cout][H/2][W/2]; terms 1 ("default") or 2 ("mid"); act 1 =
// LeakyReLU(0.2) before the pool, 0 = none; any Cout >= 1 and C >= 1,
// H % (8 at a slab of 64, else 16) == 0, W % 32 == 0; blocks the
// persistent blocks (1 .. tiles; ops/packed.py persistent_blocks), smem the
// block's dynamic shared memory in bytes (ops/packed.py bf16_ring_bytes,
// checked against the ring's). Returns the cudaError_t of the launch
// (0 = launched).
extern "C" int probgan_packed_convpool_bf16(const float* x, const void* wk, const float* bias,
                                            float* y, int B, int C, int H, int W, int cout,
                                            int terms, int act, int blocks, int smem,
                                            void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
#define PROBGAN_POOL_LAUNCH(NT, EPI) \
  launch_slab<NT, EPI>(x, w, bias, y, B, C, H, W, cout, blocks, smem, s)
  if (terms == 1) return act ? PROBGAN_POOL_LAUNCH(1, kLrelu) : PROBGAN_POOL_LAUNCH(1, kNone);
  if (terms == 2) return act ? PROBGAN_POOL_LAUNCH(2, kLrelu) : PROBGAN_POOL_LAUNCH(2, kNone);
#undef PROBGAN_POOL_LAUNCH
  return cudaErrorInvalidValue;
}

// out[3] = {stages, bytes a block, blocks an SM} of the ring at a slab of
// `slab` channels (8, 16, 32 or 64) and `terms` terms, as compiled.
extern "C" int probgan_packed_convpool_bf16_geometry(int slab, int terms, int* out) {
  using namespace probgan;
#define PROBGAN_GEOMETRY(S) \
  if (slab == S) return terms == 1 ? geometry<S, 1>(out) : geometry<S, 2>(out);
  if (terms != 1 && terms != 2) return cudaErrorInvalidValue;
  PROBGAN_GEOMETRY(64)
  PROBGAN_GEOMETRY(32)
  PROBGAN_GEOMETRY(16)
  PROBGAN_GEOMETRY(8)
#undef PROBGAN_GEOMETRY
  return cudaErrorInvalidValue;
}
