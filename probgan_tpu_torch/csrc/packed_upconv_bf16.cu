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
// Design (bf16_conv.cuh): a tile is the output rows of ONE parity py under
// TH input rows (8 at Cout 64, 16 at 32) and 16 input columns, both column
// parities, all Cout: so a block stages only its parity's taps, 2 px x 4
// (dy, dx) x Cout x 32 a chunk, beside the patch of TH + 1 rows x 24 columns.
// A warp's m16 tiles are (its input row, column parity px): 16 input columns
// of one parity each, whose two parities' sums a lane holds for the same
// output channel and neighbouring output columns, stored as one float2.
// Blocks walk the tiles with the parity fastest, so both parities of a patch
// run at about the same time and share it in L2. The toRGB of the input runs
// in the py = 0 tiles, one input pixel a thread, from the staged patch (at
// "mid" x_hi + x_lo, the split value). Cout 16 and 8 (a narrow generator:
// 32 -> 16 from 256², 16 -> 8 from 512² with toRGB) keep the 16-row tile
// with two or one n8 tiles; C 16 is one k16 step a tap, and the toRGB sums
// only the chunk's C - c0 channels.
#include "bf16_conv.cuh"

namespace probgan {

template <int COUT, int NTERM>
struct UpconvBf16 {
  using T = BfTile<COUT>;
  static constexpr int SR = T::TH + 1;   // patch rows: i0 + py - 1 .. i0 + py + TH - 1
  static constexpr int NG = 3;           // patch columns j0 - 4 .. j0 + 19
  static constexpr int kXWords = SR * 8 * NG * kRowWords;  // one term's plane
  static constexpr int kWWords = 8 * COUT * kRowWords;  // [2 px][4 taps][COUT][kPadK]
  static constexpr int kBytes = 4 * (NTERM * kXWords + kWWords);
};

template <int COUT, int NTERM, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
    packed_upconv_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk,
                              const float* __restrict__ bias, const float* __restrict__ rgb_w,
                              const float* __restrict__ rgb_b, float* __restrict__ y,
                              float* __restrict__ rgb, int C, int H, int W) {
  using T = BfTile<COUT>;
  using K = UpconvBf16<COUT, NTERM>;
  extern __shared__ __align__(16) unsigned bf16_smem[];
  unsigned* xs = bf16_smem;
  unsigned* ws = bf16_smem + NTERM * K::kXWords;
  const int tiles_x = W / 16, tiles_y = H / T::TH;
  int t = blockIdx.x;
  const int py = t & 1;
  t >>= 1;
  const int j0 = (t % tiles_x) * 16;
  t /= tiles_x;
  const int i0 = (t % tiles_y) * T::TH;
  const int b = t / tiles_y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  // toRGB of the input: the py = 0 tiles own input rows i0 .. i0 + TH - 1
  // (patch rows 1 .. TH), one input pixel a thread
  const bool with_rgb = rgb_w != nullptr && py == 0 && threadIdx.x < T::TH * 16;
  const int pr = threadIdx.x / 16, pc = threadIdx.x % 16;
  float racc[3] = {0.f, 0.f, 0.f};

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  const float* xb = x + static_cast<size_t>(b) * C * H * W;
  const unsigned* wpy = wk + static_cast<size_t>(py) * bf16_chunks(C) * K::kWWords;
  for (int c0 = 0; c0 < C; c0 += kCK) {
    stage_w(ws, wpy + static_cast<size_t>(c0 / kCK) * K::kWWords, K::kWWords);
    cp_async_commit();
    stage_chunk<K::SR, K::NG, NTERM>(xs, xb, c0, C, H, W, i0 + py - 1, j0 - 4);
    cp_async_wait(0);
    __syncthreads();
    const int c_n = min(kCK, C - c0);            // the chunk's channels
    const int halves = c_n > kCK / 2 ? 2 : 1;  // block-uniform
    if (with_rgb) {
      const auto* px = reinterpret_cast<const __nv_bfloat16*>(xs) +
                       ((pr + 1) * 8 * K::NG + pc + 4) * kPadK;
#pragma unroll 4
      for (int c = 0; c < c_n; ++c) {
        // x_hi, + x_lo from the next plane at "mid": the sum is exact
        const float v = NTERM == 1 ? __bfloat162float(px[c])
                                   : __bfloat162float(px[c]) +
                                         __bfloat162float(px[c + 2 * K::kXWords]);
#pragma unroll
        for (int k = 0; k < 3; ++k) racc[k] = fmaf(v, __ldg(rgb_w + k * C + c0 + c), racc[k]);
      }
    }
#pragma unroll 1
    for (int tap = 0; tap < 4; ++tap) {
      const int dy = tap >> 1, dx = tap & 1;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // channels 16 * kk .. + 15 of the chunk
        if (kk >= halves) break;
#pragma unroll
        for (int pxp = 0; pxp < 2; ++pxp) {
          unsigned bf[T::NT][2];
          load_b<T::NT>(bf, ws + (pxp * 4 + tap) * COUT * kRowWords + 8 * kk);
#pragma unroll
          for (int rr = 0; rr < T::RW; ++rr) {
            // input row i0 + warp * RW + rr reads patch row + dy; output
            // column 2 * (j0 + g) + pxp reads input column j0 + g + pxp + dx - 1,
            // patch column g + pxp + dx + 3
            const int row = warp * T::RW + rr + dy;
            const int col = pxp + dx + 3;
            mma_row<T::NT, NTERM>(acc[2 * rr + pxp],
                                  xs + (row * 8 * K::NG + col) * kRowWords + 8 * kk,
                                  8 * kRowWords, K::kXWords, bf);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the chunk before it is replaced
  }

  if (with_rgb) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      rgb[((static_cast<size_t>(b) * 3 + k) * H + i0 + pr) * W + j0 + pc] = racc[k] + __ldg(rgb_b + k);
  }
  const int Wo = 2 * W;
  const size_t plane = static_cast<size_t>(2 * H) * Wo;
#pragma unroll
  for (int rr = 0; rr < T::RW; ++rr) {
    if constexpr (EPI == kLreluNorm) {
      bias_lrelu_norm_frag<T::NT>(acc[2 * rr], bias);
      bias_lrelu_norm_frag<T::NT>(acc[2 * rr + 1], bias);
    } else {
      bias_act_frag<T::NT, EPI>(acc[2 * rr], bias);
      bias_act_frag<T::NT, EPI>(acc[2 * rr + 1], bias);
    }
    float* row = y + static_cast<size_t>(b) * COUT * plane +
                 static_cast<size_t>(2 * (i0 + warp * T::RW + rr) + py) * Wo + 2 * (j0 + g);
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // channel 8 * nt + 2 * tq + e % 2; pixel g (e < 2) or g + 8
        float* p = row + static_cast<size_t>(8 * nt + 2 * tq + (e & 1)) * plane + (e >> 1) * 16;
        *reinterpret_cast<float2*>(p) = make_float2(acc[2 * rr][nt][e], acc[2 * rr + 1][nt][e]);
      }
  }
}

template <int COUT, int NTERM, int EPI>
int launch(const float* x, const unsigned* wk, const float* bias, const float* rgb_w,
           const float* rgb_b, float* y, float* rgb, int B, int C, int H, int W, int smem,
           cudaStream_t stream) {
  using K = UpconvBf16<COUT, NTERM>;
  const long long n_tiles = 2LL * B * (H / BfTile<COUT>::TH) * (W / 16);
  if (B < 1 || C < 8 || C % 8 || H % BfTile<COUT>::TH || W < 16 || W % 16 ||
      n_tiles > 0x7fffffff || smem != K::kBytes || (rgb_w == nullptr) != (rgb == nullptr) ||
      (EPI != kLreluNorm && rgb_w != nullptr))
    return cudaErrorInvalidValue;
  const auto kernel = packed_upconv_bf16_kernel<COUT, NTERM, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(x, wk, bias, rgb_w, rgb_b,
                                                                      y, rgb, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W] fp32, wk [2 py][ceil(C/32)][2 px][4 (dy, dx)][Cout][40] bf16
// (ops/packed.py upconv_bf16_weights: the pre-summed parity taps, eq-LR
// scaled, rounded to bf16, 8 zeros after each run of 32 input channels,
// zeros past C),
// bias [Cout], rgb_w [3][C] (values rounded to bf16, stored as fp32) and
// rgb_b [3] or both null -> y [B][Cout][2H][2W] and, with rgb_w, rgb
// [B][3][H][W]; terms 1 ("default") or 2 ("mid"); epilogue 0 "lrelu_norm" or
// 1 "lrelu" (no toRGB); Cout 8, 16, 32 or 64, C % 8 == 0, H % (8 at Cout 64,
// else 16) == 0, W % 16 == 0; smem the block's dynamic shared memory in
// bytes (ops/packed.py bf16_upconv_bytes, checked against the kernel's).
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_upconv_bf16(const float* x, const void* wk, const float* bias,
                                          const float* rgb_w, const float* rgb_b, float* y,
                                          float* rgb, int B, int C, int H, int W, int cout,
                                          int terms, int epilogue, int smem, void* stream) {
  using namespace probgan;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto w = static_cast<const unsigned*>(wk);
#define PROBGAN_UP_COUT(CO, NT, EPI) \
  launch<CO, NT, EPI>(x, w, bias, rgb_w, rgb_b, y, rgb, B, C, H, W, smem, s)
#define PROBGAN_UP_LAUNCH(NT, EPI)                                 \
  (cout == 64   ? PROBGAN_UP_COUT(64, NT, EPI)                     \
   : cout == 32 ? PROBGAN_UP_COUT(32, NT, EPI)                     \
   : cout == 16 ? PROBGAN_UP_COUT(16, NT, EPI)                     \
                : PROBGAN_UP_COUT(8, NT, EPI))
  if (cout != 8 && cout != 16 && cout != 32 && cout != 64) return cudaErrorInvalidValue;
  if (terms == 1 && epilogue == kLreluNorm) return PROBGAN_UP_LAUNCH(1, kLreluNorm);
  if (terms == 1 && epilogue == kLrelu) return PROBGAN_UP_LAUNCH(1, kLrelu);
  if (terms == 2 && epilogue == kLreluNorm) return PROBGAN_UP_LAUNCH(2, kLreluNorm);
  if (terms == 2 && epilogue == kLrelu) return PROBGAN_UP_LAUNCH(2, kLrelu);
#undef PROBGAN_UP_LAUNCH
#undef PROBGAN_UP_COUT
  return cudaErrorInvalidValue;
}
