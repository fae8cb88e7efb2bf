// packed_conv_wgrad: the weight gradient of a 3x3 SAME conv, fp32 NCHW:
//   dW[o][c][ky][kx] = sum over (b, y, x) of
//                      x_pad[b][c][y + ky - 1][x + kx - 1] * dpre[b][o][y][x]
// with x [B][C][H][W] the conv's input (zero outside the image) and dpre
// [B][Cout][H][W] the cotangent of its pre-bias output. Full fp32 FMAs.
//
// Replaces probgan_tpu/ops/pallas_packed.py:558 `packed_conv_wgrad`, which
// every backward of ops/packed_vjp.py calls: at batch 2 of the 1024^2 train
// step, (C, Cout, H) = (32, 32, 1024), (32, 64, 1024), (64, 64, 512),
// (64, 128, 512) in the discriminator and (128, 64, 512), (64, 32, 1024),
// (64, 64, 512), (32, 32, 1024) in the generator.
//
// Bound on the H100: operations. (32, 64, 1024) at batch 2 does
// 2*9*32*64*2*1024^2 = 77 GFLOP over 268 + 537 MB read and 74 KB written:
// ~96 FLOP per byte against the fp32 balance point of 20 (67 TFLOP/s over
// 3.35 TB/s; this grade is fp32 without TF32, so the CUDA cores are the
// ceiling).
//
// Design. It is a GEMM with a tiny output ([9*C] x [Cout], 9,216 to 73,728
// floats) and a huge reduction (2 to 4 million pixels): a split-K problem.
// The TPU kernel keeps the whole sum in fast memory across a grid that runs
// in order; blocks here run in no order, so:
//  * grid.x walks (slab of 8 input channels) x (slab of 32 output channels),
//    grid.y splits the pixels: block (s, k) owns pixel tiles k, k + grid.y,
//    ... of 8 rows x 32 columns, and sums all of them in registers;
//  * a warp owns one row of the tile; a lane owns one input channel and 8
//    output channels, so 9 taps x 8 = 72 sums. Walking along its row it
//    keeps the 3x3 input window in registers: per pixel 3 new inputs and 8
//    cotangents are read from shared memory for 72 FMAs;
//  * at the end the 8 warps' sums are added in shared memory in warp order,
//    and the block writes its partial [9][8][32] into
//    partials[k][9][C][Cout]; a second kernel adds the grid.y partials in
//    ascending k and writes dW in OIHW. No atomics: every sum has one fixed
//    order, so equal inputs give equal bits.
// Halo: a tile stages rows y0-1 .. y0+8 and columns x0-1 .. x0+32 of its own
// image only, zero outside [0, H) x [0, W), so no tile reads a neighbouring
// image. Output channels past Cout (Cout % 32 != 0) are staged as zeros and
// never written.
#include "conv_tile.cuh"

namespace probgan {

constexpr int kWgCS = 8;                      // input channels per block
constexpr int kWgOS = 32;                     // output channels per block
constexpr int kWgTN = 8;                      // output channels per lane
constexpr int kWgTR = 8;                      // tile rows: one warp each
constexpr int kWgTW = 32;                     // tile columns
constexpr int kWgXW = kWgTW + 2;              // staged input row, with halo
constexpr int kWgXCS = (kWgTR + 2) * kWgXW;   // staged input channel: 340 floats
// Row stride of the staged cotangents [o][pixel]: 8 * 257 = 8 (mod 32), so
// the four 8-channel groups of a warp read four different banks.
constexpr int kWgPS = kWgTR * kWgTW + 1;
static_assert(kWgCS * (kWgOS / kWgTN) * kWgTR == kThreads, "one lane per (row, c, o-group)");
static_assert(kWgTR * kWgCS * kWgOS <= kWgOS * kWgPS, "the reduction scratch reuses ds");
static_assert(kWgTR * kWgTW == kThreads, "one thread per tile pixel when staging");

__global__ void __launch_bounds__(kThreads, 2)
    packed_conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dpre,
                             float* __restrict__ partials, int B, int C, int H, int W, int Cout,
                             int n_oslabs) {
  __shared__ float xs[kWgCS * kWgXCS];
  __shared__ float ds[kWgOS * kWgPS];

  const int tid = threadIdx.x;
  const int og = tid & 3;         // group of 8 output channels
  const int c = (tid >> 2) & 7;   // input channel of the slab
  const int pl = tid >> 5;        // tile row = warp
  const int c0 = (blockIdx.x / n_oslabs) * kWgCS;
  const int o0 = (blockIdx.x % n_oslabs) * kWgOS;
  const int tiles_x = W / kWgTW;
  const int tiles_img = tiles_x * (H / kWgTR);
  const int n_tiles = B * tiles_img;
  const size_t plane = static_cast<size_t>(H) * W;

  float acc[9][kWgTN] = {};
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int b = t / tiles_img;
    const int y0 = ((t % tiles_img) / tiles_x) * kWgTR;
    const int x0 = (t % tiles_x) * kWgTW;
    const float* xb = x + (static_cast<size_t>(b) * C + c0) * plane;
    const float* db = dpre + (static_cast<size_t>(b) * Cout + o0) * plane;
    // Stage the input: the (row, column) of a halo element is decoded once
    // and serves the slab's 8 channels.
    for (int e = tid; e < kWgXCS; e += kThreads) {
      const int gy = y0 - 1 + e / kWgXW;
      const int gx = x0 - 1 + e % kWgXW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float* src = xb + (static_cast<ptrdiff_t>(gy) * W + gx);  // read only if inside
#pragma unroll
      for (int cc = 0; cc < kWgCS; ++cc)
        xs[cc * kWgXCS + e] = inside ? __ldg(src + static_cast<size_t>(cc) * plane) : 0.f;
    }
    // Stage the cotangent: thread (row pl, column tid % 32) of the tile, one
    // coalesced row segment per warp and output channel.
    {
      const float* src = db + static_cast<size_t>(y0 + pl) * W + x0 + (tid & 31);
#pragma unroll 8
      for (int o = 0; o < kWgOS; ++o)
        ds[o * kWgPS + tid] = (o0 + o < Cout) ? __ldg(src + static_cast<size_t>(o) * plane) : 0.f;
    }
    __syncthreads();

    // Pixel (pl, col) of the tile sees staged input rows pl..pl+2 and
    // columns col..col+2: tap (ky, kx) is win[ky][kx].
    const float* xrow = xs + c * kWgXCS + pl * kWgXW;
    const float* drow = ds + og * kWgTN * kWgPS + pl * kWgTW;
    float win[3][3];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      win[ky][0] = xrow[ky * kWgXW];
      win[ky][1] = xrow[ky * kWgXW + 1];
    }
#pragma unroll 4
    for (int col = 0; col < kWgTW; ++col) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) win[ky][2] = xrow[ky * kWgXW + col + 2];
      float d[kWgTN];
#pragma unroll
      for (int n = 0; n < kWgTN; ++n) d[n] = drow[n * kWgPS + col];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int n = 0; n < kWgTN; ++n)
            acc[ky * 3 + kx][n] = fmaf(win[ky][kx], d[n], acc[ky * 3 + kx][n]);
        }
        win[ky][0] = win[ky][1];
        win[ky][1] = win[ky][2];
      }
    }
    __syncthreads();
  }

  // Add the 8 warps' sums, tap by tap, in warp order; thread (rc, ro) owns
  // input channel rc and output channel ro of the slab.
  const int rc = tid >> 5;
  const int ro = tid & 31;
  const size_t slab_stride = static_cast<size_t>(C) * Cout;
  float* out = partials + static_cast<size_t>(blockIdx.y) * 9 * slab_stride +
               static_cast<size_t>(c0 + rc) * Cout + o0 + ro;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    __syncthreads();
    float* dst = ds + (pl * kWgCS + c) * kWgOS + og * kWgTN;
#pragma unroll
    for (int n = 0; n < kWgTN; ++n) dst[n] = acc[t][n];
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int p = 0; p < kWgTR; ++p) s += ds[(p * kWgCS + rc) * kWgOS + ro];
    if (o0 + ro < Cout) out[t * slab_stride] = s;
  }
}

// dW[o][c][tap] = sum over k, ascending, of partials[k][tap][c][o].
__global__ void packed_conv_wgrad_reduce_kernel(const float* __restrict__ partials,
                                                float* __restrict__ dw, int C, int Cout,
                                                int ksplit) {
  const int n = 9 * C * Cout;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < ksplit; ++k) s += partials[static_cast<size_t>(k) * n + i];
  const int o = i % Cout;
  const int c = (i / Cout) % C;
  const int t = i / (Cout * C);
  dw[(static_cast<size_t>(o) * C + c) * 9 + t] = s;
}

}  // namespace probgan

// x [B][C][H][W], dpre [B][Cout][H][W], scratch partials [ksplit][9][C][Cout]
// -> dw [Cout][C][3][3]. C % 8 == 0, Cout % 8 == 0, H % 8 == 0, W % 32 == 0,
// 1 <= ksplit <= 65535. Returns the cudaError_t of the launches (0 = both
// launched).
extern "C" int probgan_packed_conv_wgrad(const float* x, const float* dpre, float* partials,
                                         float* dw, int B, int C, int H, int W, int cout,
                                         int ksplit, void* stream) {
  using namespace probgan;
  if (B < 1 || C < kWgCS || C % kWgCS || cout < 8 || cout % 8 || H % kWgTR || W % kWgTW ||
      H < kWgTR || W < kWgTW || ksplit < 1 || ksplit > 65535)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_oslabs = (cout + kWgOS - 1) / kWgOS;
  const dim3 grid((C / kWgCS) * n_oslabs, ksplit);
  packed_conv_wgrad_kernel<<<grid, kThreads, 0, s>>>(x, dpre, partials, B, C, H, W, cout,
                                                     n_oslabs);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int n = 9 * C * cout;
  packed_conv_wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partials, dw, C, cout, ksplit);
  return static_cast<int>(cudaGetLastError());
}
