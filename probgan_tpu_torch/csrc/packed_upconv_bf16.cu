// packed_upconv_bf16: kernel modes "default" (one bf16 pass) and "mid" (the
// 2-term split) of packed_upconv: nearest-2x upsample -> 3x3 SAME conv as the
// four parity 2x2 convs of x (rounded to bf16, or at "mid" split as bf16(x) +
// bf16(x - bf16(x))) against bf16-rounded PRE-SUMMED taps (fp32 sums) + bias
// -> LeakyReLU(0.2) -> PixelNorm ("lrelu_norm") or LeakyReLU alone ("lrelu":
// the train step's pre-norm recompute) in fp32, [B][C][H][W] ->
// [B][Cout][2H][2W] fp32; optionally also toRGB of the input (rounded, or
// split) with bf16-rounded weights (fp32 sums) + bias at input resolution
// [B][3][H][W].
//
// Replaces probgan_tpu/ops/pallas_packed.py:832 `packed_upconv` at modes
// "default" and "mid": the upsample is folded into the per-parity taps before they are
// rounded (`prep_upconv_weights` :800-830), so the kernel takes
// bf16(w_a + w_b), not bf16(w_a) + bf16(w_b): the wrapper rounds the taps of
// ops/fused_upconv.py parity_weights (rows summed first, then columns, the
// JAX order). Its toRGB (:864, :880) is a mode dot too. It is conv1 of the
// 1024^2 generator's stages 7 (128 -> 64 channels, 256^2 -> 512^2) and 8
// (64 -> 32, 512^2 -> 1024^2, with toRGB) at the "fast" and default grades
// and of the train step at packed_train_mode "default" (forward and
// recompute); at "mid", the same stages of generate with the generator's
// packed mode "mid" and of the train step at packed_train_mode "mid".
//
// Bound on the H100: bytes. At batch 2 stage 7 does 34.4 GFLOP (0.035 ms at
// 989 TFLOP/s of bf16) and moves 67 MB in and 134 MB out (0.060 ms at 3.35
// TB/s); stage 8 the same FLOP over 67 + 268 MB (0.100 ms). "mid" runs twice
// the products (0.070 ms), still under the bytes.
//
// Design (bf16_ring.cuh UpconvBf16Ring): a tile is the output rows of ONE
// parity py under TH input rows (8 at Cout 64, 16 below) and 16 input
// columns, both column parities, all Cout; persistent blocks, one an SM,
// walk the tiles with the
// parity fastest, so both parities of a patch run side by side and share it
// in L2. Each tile's input channels stream 32 at a time through a ring of
// three shared-memory stages (the fp32 patch of TH + 1 rows x 24 columns and
// the parity's 2 px x 4 (dy, dx) x Cout x 32 bf16 taps of the chunk),
// filled by cp.async while the products of an earlier stage run; the input
// is rounded (at "mid" split) as the A fragments are loaded. A warp's m16
// tiles are (its input row, column parity px): 16 input columns of one
// parity each, whose two parities' sums a lane holds for the same output
// channel and neighbouring output columns, stored as one float2. The toRGB
// of the input runs in the py = 0 tiles, one input pixel a thread, from the
// staged patch, each value rounded (at "mid" split) as the mma reads it.
// Cout 16 and 8 (a narrow generator: 32 -> 16 from 256², 16 -> 8 from 512²
// with toRGB) keep the 16-row tile with two or one n8 tiles; C 16 is one
// k16 step a tap, and the toRGB sums only the chunk's C - c0 channels.
// "lrelu_norm" takes any Cout from 1 to 64 and any C >= 1 (8 -> 4, 4 -> 2,
// 96 -> 48, 48 -> 24, 24 -> 12 in the generators of fmap_base 1024, 512 and
// 3072) on the tile just above Cout, with the wrapper's zero-padded taps and
// bias (bf16_ring.cuh); "lrelu" (the training backward's recompute) takes
// the same widths on the same tiles: "lrelu_norm"'s pre-activations bit for
// bit.
#include "bf16_ring.cuh"

namespace probgan {

template <int COUT, int NTERM, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    packed_upconv_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                              const float* __restrict__ bias, const float* __restrict__ rgb_w,
                              const float* __restrict__ rgb_b, float* __restrict__ y,
                              float* __restrict__ rgb, int C, int H, int W, int cout,
                              int n_tiles) {
  extern __shared__ __align__(16) float bf16_ring_smem[];
  UpconvBf16Ring<COUT, NTERM, EPI> cv(x, wk, bias, rgb_w, rgb_b, y, rgb, C, H, W, cout);
  bf16_ring_walk(cv, bf16_ring_smem, n_tiles);
}

template <int COUT, int NTERM, int EPI>
int launch(const float* x, const unsigned* wk, const float* bias, const float* rgb_w,
           const float* rgb_b, float* y, float* rgb, int B, int C, int H, int W, int cout,
           int blocks, int smem, cudaStream_t stream) {
  using K = UpconvBf16Ring<COUT, NTERM, EPI>;
  const long long n_tiles = 2LL * B * (H / BfTile<COUT>::TH) * (W / 16);
  if (B < 1 || C < 1 || cout < 1 || cout > COUT || H % BfTile<COUT>::TH || W < 16 || W % 16 ||
      n_tiles > 0x7fffffff || blocks < 1 || blocks > n_tiles || smem != K::kBytes ||
      reinterpret_cast<size_t>(x) % 16 || reinterpret_cast<size_t>(rgb_w) % 16 ||
      (rgb_w == nullptr) != (rgb == nullptr) ||
      (EPI != kLreluNorm && rgb_w != nullptr))
    return cudaErrorInvalidValue;
  const auto kernel = packed_upconv_bf16_kernel<COUT, NTERM, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(x, wk, bias, rgb_w, rgb_b, y, rgb, C, H, W, cout,
                                             static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The geometry the ring was compiled with at Cout channels: {stages, bytes a
// block, blocks an SM at those bytes}.
template <int COUT, int NTERM>
int geometry(int* out) {
  return ring_geometry<UpconvBf16Ring<COUT, NTERM, kLreluNorm>>(
      packed_upconv_bf16_kernel<COUT, NTERM, kLreluNorm>, out);
}

}  // namespace probgan

// x [B][C][H][W] fp32, wk [2 py][ceil(C/32)][2 px][4 (dy, dx)][T][40] bf16
// (ops/packed.py upconv_bf16_weights: the pre-summed parity taps, eq-LR
// scaled, rounded to bf16, 8 zeros after each run of 32 input channels,
// zeros past C and past Cout), bias [T] (zeros past Cout), rgb_w [3][C4]
// (C rounded up to 4, zeros past C; values rounded to bf16, stored as fp32,
// 16-byte aligned) and rgb_b [3] or
// both null -> y [B][Cout][2H][2W] and, with rgb_w, rgb [B][3][H][W]; T the
// least of 8, 16, 32 and 64 at or above Cout; terms 1 ("default") or 2
// ("mid"); epilogue 0 "lrelu_norm" or 1 "lrelu" (no toRGB), both at Cout 1
// to 64 and C >= 1; H % (8 at T 64, else 16) == 0,
// W % 16 == 0, x 16-byte aligned; blocks the persistent
// blocks (1 .. tiles; ops/packed.py persistent_blocks), smem the block's
// dynamic shared memory in bytes (ops/packed.py bf16_upconv_ring_bytes,
// checked against the kernel's). Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int probgan_packed_upconv_bf16(const float* x, const void* wk, const float* bias,
                                          const float* rgb_w, const float* rgb_b, float* y,
                                          float* rgb, int B, int C, int H, int W, int cout,
                                          int terms, int epilogue, int blocks, int smem,
                                          void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
#define PROBGAN_UP_COUT(CO, NT, EPI) \
  launch<CO, NT, EPI>(x, w, bias, rgb_w, rgb_b, y, rgb, B, C, H, W, cout, blocks, smem, s)
#define PROBGAN_UP_LAUNCH(NT, EPI)                                 \
  (cout > 32   ? PROBGAN_UP_COUT(64, NT, EPI)                      \
   : cout > 16 ? PROBGAN_UP_COUT(32, NT, EPI)                      \
   : cout > 8  ? PROBGAN_UP_COUT(16, NT, EPI)                      \
               : PROBGAN_UP_COUT(8, NT, EPI))
  if (cout < 1 || cout > 64) return cudaErrorInvalidValue;
  if (terms == 1 && epilogue == kLreluNorm) return PROBGAN_UP_LAUNCH(1, kLreluNorm);
  if (terms == 1 && epilogue == kLrelu) return PROBGAN_UP_LAUNCH(1, kLrelu);
  if (terms == 2 && epilogue == kLreluNorm) return PROBGAN_UP_LAUNCH(2, kLreluNorm);
  if (terms == 2 && epilogue == kLrelu) return PROBGAN_UP_LAUNCH(2, kLrelu);
#undef PROBGAN_UP_LAUNCH
#undef PROBGAN_UP_COUT
  return cudaErrorInvalidValue;
}

// out[3] = {stages, bytes a block, blocks an SM} of the ring at Cout 8, 16,
// 32 or 64 and `terms` terms, as compiled.
extern "C" int probgan_packed_upconv_bf16_geometry(int cout, int terms, int* out) {
  using namespace probgan;
#define PROBGAN_GEOMETRY(CO) \
  if (cout == CO) return terms == 1 ? geometry<CO, 1>(out) : geometry<CO, 2>(out);
  if (terms != 1 && terms != 2) return cudaErrorInvalidValue;
  PROBGAN_GEOMETRY(64)
  PROBGAN_GEOMETRY(32)
  PROBGAN_GEOMETRY(16)
  PROBGAN_GEOMETRY(8)
#undef PROBGAN_GEOMETRY
  return cudaErrorInvalidValue;
}
