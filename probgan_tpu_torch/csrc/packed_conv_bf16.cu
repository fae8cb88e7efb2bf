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
// Design (bf16_conv.cuh): one block a tile of 8 rows x 32 columns x a slab of
// 64 channels (16 rows at 32), the slab fastest in the walk so that the slabs
// of a tile run together and share its patch in L2; the patch of 10 x 40
// pixels (one plane a term) and the chunk's 9 x slab x 32 weights in shared
// memory as bf16, 32 input channels a chunk; each warp one row of two m16
// tiles x eight n8 tiles. The epilogue runs on the mma fragments: the 4 lanes
// of a quad hold all channels of two pixels and reduce PixelNorm's sum by two
// xor shuffles; the stores of a warp fill whole 32-byte sectors (8
// neighbouring pixels of 4 channels). Slabs of 16 and 8 channels (a narrow
// generator's late stages: 16 -> 16 at 512², 8 -> 8 at 1024², and their
// training backward's input gradients, "none" 8 -> 8 and 16 -> 8 at 1024²,
// 16 -> 16 and 32 -> 16 at 512²) keep the 16-row tile with two or one n8
// tiles a warp, at every epilogue; C % 32 != 0 ends in a partial chunk
// (bf16_conv.cuh).
#include "bf16_conv.cuh"

namespace probgan {

template <int COUT, int NTERM, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
    packed_conv_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                            const float* __restrict__ bias, float* __restrict__ y, int C, int H,
                            int W, int n_slabs) {
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
  conv_bf16_tile<COUT, NTERM>(acc, bf16_smem, x,
                              wk + static_cast<size_t>(slab) * bf16_chunks(C) * K::kWWords, b,
                              y0, x0, C, H, W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* bs = bias + slab * COUT;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    if constexpr (EPI == kLreluNorm)
      bias_lrelu_norm_frag<T::NT>(acc[mt], bs);
    else
      bias_act_frag<T::NT, EPI>(acc[mt], bs);
    float* row = y + (static_cast<size_t>(b) * n_slabs + slab) * COUT * plane +
                 static_cast<size_t>(y0 + warp * T::RW + mt / 2) * W + x0 + 16 * (mt % 2) + g;
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt) {
      float* p = row + static_cast<size_t>(8 * nt + 2 * tq) * plane;
      p[0] = acc[mt][nt][0];
      p[plane] = acc[mt][nt][1];
      p[8] = acc[mt][nt][2];
      p[plane + 8] = acc[mt][nt][3];
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
  const auto kernel = packed_conv_bf16_kernel<COUT, NTERM, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(x, wk, bias, y, C, H, W,
                                                                      n_slabs);
  return static_cast<int>(cudaGetLastError());
}

// A slab of the largest of 64, 32, 16 and 8 channels that divides Cout
// (ops/packed.py _pool_slab); PixelNorm needs all Cout in one slab.
template <int NTERM, int EPI>
int launch_slab(const float* x, const unsigned* wk, const float* bias, float* y, int B, int C,
                int H, int W, int cout, int smem, cudaStream_t stream) {
  if (cout <= 0 || cout % 8 ||
      (EPI == kLreluNorm && cout != 8 && cout != 16 && cout != 32 && cout != 64))
    return cudaErrorInvalidValue;
  if (cout % 64 == 0) return launch<64, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  if (cout % 32 == 0) return launch<32, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  if (cout % 16 == 0) return launch<16, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  return launch<8, NTERM, EPI>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
}

template <int NTERM>
int launch_epilogue(const float* x, const unsigned* wk, const float* bias, float* y, int B,
                    int C, int H, int W, int cout, int epilogue, int smem, cudaStream_t stream) {
  if (epilogue == kLreluNorm)
    return launch_slab<NTERM, kLreluNorm>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  if (epilogue == kLrelu)
    return launch_slab<NTERM, kLrelu>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  if (epilogue == kNone)
    return launch_slab<NTERM, kNone>(x, wk, bias, y, B, C, H, W, cout, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace probgan

// x [B][C][H][W] fp32, wk [Cout/slab][ceil(C/32)][9][slab][40] bf16
// (ops/packed.py conv_bf16_weights: eq-LR scaled, rounded to bf16, taps
// ky*3 + kx, 8 zeros after each run of 32 input channels, zeros past C),
// bias [Cout] -> y [B][Cout][H][W]; terms 1 ("default") or 2 ("mid");
// epilogue 0 "lrelu_norm" (Cout 8, 16, 32 or 64), 1 "lrelu" (Cout a
// multiple of 8), 2 "none" (Cout a multiple of 8); C % 8 == 0,
// H % (8 at a slab of 64, else 16) == 0, W % 32 == 0; smem the block's dynamic shared memory in
// bytes (ops/packed.py bf16_conv_bytes, checked against the kernel's).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_conv_bf16(const float* x, const void* wk, const float* bias,
                                        float* y, int B, int C, int H, int W, int cout,
                                        int terms, int epilogue, int smem, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
  if (terms == 1) return launch_epilogue<1>(x, w, bias, y, B, C, H, W, cout, epilogue, smem, s);
  if (terms == 2) return launch_epilogue<2>(x, w, bias, y, B, C, H, W, cout, epilogue, smem, s);
  return cudaErrorInvalidValue;
}
