// packed_conv_bf16: the bf16 kernel modes of packed_conv, 3x3 SAME conv with
// fp32 sums, fp32 NCHW in and out, mode "default" (one bf16 pass: x and
// weights rounded to bf16) or "mid" (the 2-term split: x as bf16(x) +
// bf16(x - bf16(x)), weights rounded), each with the epilogues "lrelu_norm"
// (+ bias -> LeakyReLU(0.2) -> PixelNorm), "lrelu" (+ bias -> LeakyReLU) and
// "none" (+ bias).
//
// Replaces probgan_tpu/ops/pallas_packed.py:382 `packed_conv` at modes
// "default" and "mid" (`prep_conv_weights` :374, `stack_weights` :122,
// `_stack_x` :144): "default" is the stage-7 conv2 of the 1024^2 generator
// at the "fast" and default grades (64 -> 64 at 512^2); "mid" serves the
// discriminator at the "fast" grade (conv1, "lrelu": 32 -> 32 at 1024^2,
// 64 -> 64 at 512^2); both serve the train step at packed_train_mode
// "default" / "mid": the generator's conv2 forward ("lrelu_norm") and its
// pre-norm recompute ("lrelu"), the discriminator's conv1 ("lrelu"),
// convpool_lrelu's mask recompute ("lrelu": 32 -> 64 at 1024^2, 64 -> 128 at
// 512^2) and the input gradients ("none": 32 -> 32 and 64 -> 32 at 1024^2,
// 64 -> 64 and 128 -> 64 at 512^2).
//
// Bound on the H100: bytes. At batch 2, 64 -> 64 at 512^2 does 38.7 GFLOP
// (0.039 ms at the 989 TFLOP/s of bf16; "mid" runs twice the products,
// 0.078 ms) and moves 134 MB of fp32 in and 134 MB out (0.080 ms at 3.35
// TB/s): ~144 FLOP a byte a pass, under the ~295 where the tensor cores
// would become the limit.
//
// Design (bf16_ring.cuh ConvBf16Ring): persistent blocks, one an SM, walk
// tiles of 8 rows x 32 columns x a slab of 64 channels (16 rows at 32, 16
// and 8), the slab
// fastest so that the slabs of a tile run side by side and share its patch
// in L2; each tile's input channels stream 32 at a time through a ring of
// two shared-memory stages (the fp32 patch of 10 x 40 pixels, 18 x 40 at
// the narrower slabs, and the chunk's 9 x slab x 32 bf16 weights), filled by
// cp.async while the products of the stage before run; the activations are
// rounded (at "mid" split) as the A fragments are loaded. Each warp owns
// one row of two m16 tiles x eight n8 tiles (two rows of them x 4, 2 or 1
// n8 tiles below 64). The epilogue runs on the mma fragments: the 4 lanes
// of a quad hold all channels of two pixels and reduce PixelNorm's sum by
// two xor shuffles; the stores of a warp fill whole 32-byte sectors (8
// neighbouring pixels of 4 channels). Slabs of 16 and 8 channels (a narrow
// generator's late stages: 16 -> 16 at 512², 8 -> 8 at 1024², and their
// training backward's input gradients, "none" 8 -> 8 and 16 -> 8 at 1024²,
// 16 -> 16 and 32 -> 16 at 512²) keep the 16-row tile with two or one n8
// tiles a warp, at every epilogue; C % 32 != 0 ends in a partial chunk,
// staged with zeros past C. "lrelu_norm" takes any Cout from 1 to 64 and any
// C >= 1 (4 -> 4, 24 -> 24, 48 -> 48 in the generators of fmap_base 512 and
// 3072) on the tile just above Cout, the wrapper's weights and bias
// zero-padded to it (bf16_ring.cuh); "lrelu" and "none" take any Cout >= 1
// and any C >= 1 (the training backward of those generators: the recompute
// and input gradient 4 -> 4, 2 -> 2, 12 -> 12) on the slabs of Cout rounded
// up to a multiple of 8, zero-padded the same way, storing only the
// channels below Cout.
#include "bf16_ring.cuh"

namespace probgan {

template <int COUT, int NTERM, int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    packed_conv_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                            const float* __restrict__ bias, float* __restrict__ y, int C, int H,
                            int W, int n_slabs, int cout, int n_tiles) {
  extern __shared__ __align__(16) float bf16_ring_smem[];
  ConvBf16Ring<COUT, NTERM, EPI> cv(x, wk, bias, y, C, H, W, n_slabs, cout);
  bf16_ring_walk(cv, bf16_ring_smem, n_tiles);
}

template <int COUT, int NTERM, int EPI>
int launch(const float* x, const unsigned* wk, const float* bias, float* y, int B, int C, int H,
           int W, int cout, int blocks, int smem, cudaStream_t stream) {
  using K = ConvBf16Ring<COUT, NTERM, EPI>;
  // "lrelu_norm": one slab of up to COUT channels; "lrelu" and "none": slabs
  // of COUT, the last one's channels past Cout zero-padded by the wrapper
  // and not stored. Any C >= 1.
  const int n_slabs = EPI == kLreluNorm ? 1 : (cout + COUT - 1) / COUT;
  const long long n_tiles =
      static_cast<long long>(B) * (H / BfTile<COUT>::TH) * (W / 32) * n_slabs;
  if (B < 1 || C < 1 || H % BfTile<COUT>::TH || W < 32 || W % 32 || cout < 1 ||
      (EPI == kLreluNorm && cout > COUT) || n_tiles > 0x7fffffff ||
      blocks < 1 || blocks > n_tiles ||
      smem != K::kBytes || reinterpret_cast<size_t>(x) % 16)
    return cudaErrorInvalidValue;
  const auto kernel = packed_conv_bf16_kernel<COUT, NTERM, EPI>;
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
  return ring_geometry<ConvBf16Ring<COUT, NTERM, kLrelu>>(
      packed_conv_bf16_kernel<COUT, NTERM, kLrelu>, out);
}

// A slab of the largest of 64, 32, 16 and 8 channels that divides Cout
// rounded up to a multiple of 8 (ops/packed.py _pool_slab of it); PixelNorm
// needs all Cout in one slab, the least of them at or above Cout
// (ops/packed.py norm_tile).
template <int NTERM, int EPI>
int launch_slab(const float* x, const unsigned* wk, const float* bias, float* y, int B, int C,
                int H, int W, int cout, int blocks, int smem, cudaStream_t stream) {
  if constexpr (EPI == kLreluNorm) {
    if (cout < 1 || cout > 64) return cudaErrorInvalidValue;
    if (cout > 32) return launch<64, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem,
                                                 stream);
    if (cout > 16) return launch<32, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem,
                                                 stream);
    if (cout > 8) return launch<16, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem,
                                                stream);
    return launch<8, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream);
  }
  if (cout <= 0) return cudaErrorInvalidValue;
  const int c8 = (cout + 7) / 8 * 8;
  if (c8 % 64 == 0)
    return launch<64, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream);
  if (c8 % 32 == 0)
    return launch<32, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream);
  if (c8 % 16 == 0)
    return launch<16, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream);
  return launch<8, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream);
}

template <int NTERM>
int launch_epilogue(const float* x, const unsigned* wk, const float* bias, float* y, int B,
                    int C, int H, int W, int cout, int epilogue, int blocks, int smem,
                    cudaStream_t stream) {
  if (epilogue == kLreluNorm)
    return launch_slab<NTERM, kLreluNorm>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream);
  if (epilogue == kLrelu)
    return launch_slab<NTERM, kLrelu>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream);
  if (epilogue == kNone)
    return launch_slab<NTERM, kNone>(x, wk, bias, y, B, C, H, W, cout, blocks, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace probgan

// x [B][C][H][W] fp32, 16-byte aligned, wk [Cout/slab][ceil(C/32)][9][slab][40]
// bf16 (ops/packed.py conv_bf16_weights: eq-LR scaled, rounded to bf16, taps
// ky*3 + kx, 8 zeros after each run of 32 input channels, zeros past C),
// bias [Cout] -> y [B][Cout][H][W]; terms 1 ("default") or 2 ("mid");
// epilogue 0 "lrelu_norm" (Cout 1 to 64, any C >= 1: one slab, the least of
// 8, 16, 32 and 64 at or above Cout, wk and bias zero-padded to it), 1
// "lrelu" or 2 "none" (any Cout >= 1: slabs of Cout rounded up to a
// multiple of 8, wk and bias zero-padded to it; y holds the true Cout),
// H % (8 at a slab of 64, else 16) == 0, W % 32 == 0; blocks the persistent
// blocks (1 .. tiles; ops/packed.py persistent_blocks), smem the block's
// dynamic shared memory in bytes (ops/packed.py bf16_ring_bytes, checked
// against the kernel's). Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_conv_bf16(const float* x, const void* wk, const float* bias,
                                        float* y, int B, int C, int H, int W, int cout,
                                        int terms, int epilogue, int blocks, int smem,
                                        void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
  if (terms == 1)
    return launch_epilogue<1>(x, w, bias, y, B, C, H, W, cout, epilogue, blocks, smem, s);
  if (terms == 2)
    return launch_epilogue<2>(x, w, bias, y, B, C, H, W, cout, epilogue, blocks, smem, s);
  return cudaErrorInvalidValue;
}

// out[3] = {stages, bytes a block, blocks an SM} of the ring at a slab of
// `slab` channels (8, 16, 32 or 64) and `terms` terms, as compiled.
extern "C" int probgan_packed_conv_bf16_geometry(int slab, int terms, int* out) {
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
