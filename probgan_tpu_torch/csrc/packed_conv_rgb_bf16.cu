// packed_conv_rgb_bf16: kernel modes "default" (one bf16 pass) and "mid" (the
// 2-term split) of the final generator stage's tail:
//   3x3 SAME conv of x (rounded to bf16, or at "mid" split as bf16(x) +
//   bf16(x - bf16(x))) against bf16-rounded weights (fp32 sums) + bias ->
//   LeakyReLU(0.2) -> PixelNorm -> toRGB of the features (rounded, or split)
//   with bf16-rounded weights (fp32 sums) + bias -> prev + alpha * (rgb -
//   prev), prev = nearest-2x of rgb_prev -> (uint8) tanh -> rint((t + 1) *
//   127.5) -> clip [0, 255]
// written to NHWC [B][H][W][3]; the final feature map never leaves registers.
//
// Replaces probgan_tpu/ops/pallas_packed.py:678 `packed_conv_rgb` at modes
// "default" and "mid" (`prep_conv_weights` and the toRGB `_dot` of
// :712-727, whose operands those modes round or split as the conv's), the
// stage-8 conv2 of the 1024^2 generator at the "fast" and default grades,
// and with the generator's packed mode "mid" or "default+mid": 32 -> 32
// channels at 1024^2, then RGB (64 -> 64 at 512^2 when the generator ends at
// stage 7; 8 -> 8 at 1024^2 and 16 -> 16 at 512^2 in the narrow generator,
// fmap_base 2048).
//
// Bound on the H100: bytes. At batch 2 the conv does 38.7 GFLOP (0.039 ms at
// 989 TFLOP/s of bf16) and reads 268 MB of fp32 x and writes 6 MB of uint8
// (0.082 ms at 3.35 TB/s); "mid" runs twice the conv's products (0.078 ms).
//
// Design (bf16_ring.cuh ConvRgbBf16Ring, on packed_conv_bf16's ring):
// persistent blocks, one an SM, walk packed_conv's tiles of 8 rows x 32
// columns at 64 channels (16 rows at 32, 16 and 8), all Cout in one slab;
// each tile's input channels stream 32 at a time through a ring of two
// shared-memory stages (the fp32 halo patch and the chunk's bf16 weights),
// filled by cp.async while the products of the stage before run, the
// activations rounded (at "mid" split) as the A fragments are loaded: B2
// "lrelu_norm"'s ring, sums and order, so each feature has its bits. The
// epilogue runs on the mma fragments while the next tile's first chunk is
// in flight: bias -> LeakyReLU -> PixelNorm (the quad's two xor shuffles),
// then each lane the toRGB products of its channels (8 * nt + 2t, + 1) for
// its two pixels, each feature rounded (or split) in the lane, the quad's
// sum by two xor shuffles, and lane t = 0 writes pixel g and lane t = 1
// pixel g + 8 with conv_tile.cuh rgb_blend_store's blend and denorm; the
// lane's prev values are loaded first and the stores come after every m16
// tile's sums (bf16_ring.cuh: the tail is latency-bound). Every sum keeps
// the order bf16_ring.cuh fixes. Any Cout from 1 to 64 and any C >= 1
// (4 -> 4 and 2 -> 2 at 1024² for fmap_base 1024 and 512, 12 -> 12 for
// 3072) run on the tile just above Cout, the weights, bias and toRGB weights
// zero-padded by the wrapper; PixelNorm divides by the true Cout.
#include "bf16_ring.cuh"

namespace probgan {

template <int COUT, int NTERM, bool U8>
__global__ void __launch_bounds__(kThreads, 1)
    packed_conv_rgb_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                                const float* __restrict__ bias, const float* __restrict__ rgb_w,
                                const float* __restrict__ rgb_b, const float* __restrict__ prev,
                                float alpha, void* __restrict__ out, int C, int H, int W,
                                int cout, int n_tiles) {
  extern __shared__ __align__(16) float bf16_ring_smem[];
  ConvRgbBf16Ring<COUT, NTERM, U8> cv(x, wk, bias, rgb_w, rgb_b, prev, alpha, out, C, H, W,
                                      cout);
  bf16_ring_walk(cv, bf16_ring_smem, n_tiles);
}

template <int COUT, int NTERM, bool U8>
int launch(const float* x, const unsigned* wk, const float* bias, const float* rgb_w,
           const float* rgb_b, const float* prev, float alpha, void* out, int B, int C, int H,
           int W, int cout, int blocks, int smem, cudaStream_t stream) {
  using K = ConvRgbBf16Ring<COUT, NTERM, U8>;
  const long long n_tiles = static_cast<long long>(B) * (H / BfTile<COUT>::TH) * (W / 32);
  if (B < 1 || C < 1 || cout < 1 || cout > COUT || H % BfTile<COUT>::TH || W < 32 || W % 32 ||
      n_tiles > 0x7fffffff || blocks < 1 || blocks > n_tiles || smem != K::kBytes ||
      reinterpret_cast<size_t>(x) % 16)
    return cudaErrorInvalidValue;
  const auto kernel = packed_conv_rgb_bf16_kernel<COUT, NTERM, U8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(x, wk, bias, rgb_w, rgb_b, prev, alpha, out, C, H,
                                             W, cout, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// The geometry the ring was compiled with at Cout COUT: {stages, bytes a
// block, blocks an SM at those bytes}.
template <int COUT, int NTERM>
int geometry(int* out) {
  return ring_geometry<ConvRgbBf16Ring<COUT, NTERM, true>>(
      packed_conv_rgb_bf16_kernel<COUT, NTERM, true>, out);
}

}  // namespace probgan

// x [B][C][H][W] fp32, 16-byte aligned, wk [ceil(C/32)][9][T][40] bf16
// (ops/packed.py conv_bf16_weights: packed_conv_bf16's layout at one slab),
// bias [T], rgb_w [3][T] (values rounded to bf16, stored as fp32), T the
// least of 8, 16, 32 and 64 at or above Cout (1 to 64), zeros past Cout;
// rgb_b [3], prev [B][3][H/2][W/2] -> out [B][H][W][3], uint8 if emit_uint8
// else fp32 pre-tanh RGB; terms 1 ("default") or 2 ("mid"); C >= 1,
// H % (8 at T 64, else 16) == 0, W % 32 == 0; blocks
// the persistent blocks (1 .. tiles; ops/packed.py persistent_blocks), smem
// the block's dynamic shared memory in bytes (ops/packed.py bf16_ring_bytes,
// checked against the ring's). Returns the cudaError_t of the launch (0 =
// launched).
extern "C" int probgan_packed_conv_rgb_bf16(const float* x, const void* wk, const float* bias,
                                            const float* rgb_w, const float* rgb_b,
                                            const float* prev, float alpha, void* out,
                                            int emit_uint8, int B, int C, int H, int W, int cout,
                                            int terms, int blocks, int smem, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
#define PROBGAN_RGB_LAUNCH(CO, NT, U8) \
  launch<CO, NT, U8>(x, w, bias, rgb_w, rgb_b, prev, alpha, out, B, C, H, W, cout, blocks, smem, s)
#define PROBGAN_RGB_COUT(CO)                                                                  \
  if (cout > CO / 2 || CO == 8) {  /* the least tile at or above cout */                     \
    if (terms == 1)                                                                           \
      return emit_uint8 ? PROBGAN_RGB_LAUNCH(CO, 1, true) : PROBGAN_RGB_LAUNCH(CO, 1, false); \
    if (terms == 2)                                                                           \
      return emit_uint8 ? PROBGAN_RGB_LAUNCH(CO, 2, true) : PROBGAN_RGB_LAUNCH(CO, 2, false); \
  }
  if (cout < 1 || cout > 64) return cudaErrorInvalidValue;
  PROBGAN_RGB_COUT(64)
  PROBGAN_RGB_COUT(32)
  PROBGAN_RGB_COUT(16)
  PROBGAN_RGB_COUT(8)
#undef PROBGAN_RGB_COUT
#undef PROBGAN_RGB_LAUNCH
  return cudaErrorInvalidValue;
}

// out[3] = {stages, bytes a block, blocks an SM} of the ring at Cout `cout`
// (8, 16, 32 or 64) and `terms` terms, as compiled.
extern "C" int probgan_packed_conv_rgb_bf16_geometry(int cout, int terms, int* out) {
  using namespace probgan;
#define PROBGAN_GEOMETRY(S) \
  if (cout == S) return terms == 1 ? geometry<S, 1>(out) : geometry<S, 2>(out);
  if (terms != 1 && terms != 2) return cudaErrorInvalidValue;
  PROBGAN_GEOMETRY(64)
  PROBGAN_GEOMETRY(32)
  PROBGAN_GEOMETRY(16)
  PROBGAN_GEOMETRY(8)
#undef PROBGAN_GEOMETRY
  return cudaErrorInvalidValue;
}
