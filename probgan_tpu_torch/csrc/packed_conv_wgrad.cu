// packed_conv_wgrad: the weight gradient of a 3x3 SAME conv, fp32 NCHW:
//   dW[o][c][ky][kx] = sum over (b, y, x) of
//                      x_pad[b][c][y + ky - 1][x + kx - 1] * dpre[b][o][y][x]
// with x [B][C][H][W] the conv's input (zero outside the image) and dpre
// [B][Cout][H][W] the cotangent of its pre-bias output.
//
// Replaces probgan_tpu/ops/pallas_packed.py:558 `packed_conv_wgrad`, which
// every backward of ops/packed_vjp.py calls: at batch 2 of the 1024^2 train
// step, (C, Cout, H) = (32, 32, 1024), (32, 64, 1024), (64, 64, 512),
// (64, 128, 512) in the discriminator and (128, 64, 512), (64, 32, 1024),
// (64, 64, 512), (32, 32, 1024) in the generator.
//
// Grade: 3xTF32 on the tensor cores, fp32 by accuracy. Each fp32 operand v
// is split into hi = tf32(v) (round to nearest, ties away) and lo = v - hi,
// which the tensor cores read truncated to TF32, and every product is
// hi*hi + hi*lo + lo*hi with fp32 accumulation: what is dropped, lo*lo and
// the truncation of lo, is about 2^-21 of a product, so dW lies within ~1e-6
// of its largest entry of the fp32 sum. Why not fp32
// FMAs: (64, 128, 512) at batch 2 is 77.3 GFLOP, which cuDNN's fp32 wgrad
// does in 1.48 ms on an H100; the CUDA cores' 67 TFLOP/s would need 78% of
// peak to tie that. The tensor cores' 495 TFLOP/s of TF32 give 165 TFLOP/s
// of fp32-accurate product after the three passes.
//
// Bound on the H100: operations. 3 * 77.3 GFLOP of TF32 over 495 TFLOP/s =
// 0.469 ms for the 77.3 GFLOP shapes (0.234 ms for the 38.7 GFLOP ones),
// against 403-805 MB of input, 0.12-0.24 ms at 3.35 TB/s.
//
// Design: an implicit GEMM, M = Cout, N = 9 * C, K = B * H * W pixels.
//  * Split-K over a fixed number of blocks (the wrapper's constant, not the
//    card's SM count): grid.x walks (slab of 32 input channels) x (slab of
//    O_S = 64 or 32 output channels), grid.y splits the pixel tiles (TR rows
//    x 32 columns of one image): block (s, k) owns tiles k, k + grid.y, ...
//    and sums them in registers; a second kernel adds the grid.y partials in
//    ascending k. No atomics: equal inputs give equal bits.
//  * A block streams its tiles through a ring of 3 shared-memory stages with
//    cp.async (16 bytes, .cg): dpre [O_S][TR*32] and x [32][TR+2][40], the
//    halo rows and a 4-column margin on each side, zero outside the tile's
//    own image. The nine tap-shifted B operands are read from that one
//    staged halo tile; no im2col reaches device memory.
//  * Warp (wm, wn) owns output channels wm*32 .. +32 (two m16 tiles) and
//    input channels wn*8 .. +8 at all nine taps (nine n8 tiles): 72 fp32
//    sums a thread, no reduction across warps. Per k8 step of 8 pixels it
//    loads its A fragments (dpre) and, tap by tap, the B fragment (x shifted
//    by the tap), splits each value into hi and lo as it is loaded, and runs
//    mma.sync.m16n8k8 TF32 three times per (m, n) tile: lo*hi, hi*lo, then
//    hi*hi, into a part that is added into the thread's sums every 8 k
//    steps (see `part` below). The split happens at the fragment load, not
//    at staging, so the ring holds fp32 only and three stages fit.
//  * Bank-conflict-free fragment loads: dpre rows are padded to TR*32 + 4
//    floats and x channel planes to (TR+2)*40 + 4, both 4 mod 8 words apart,
//    so the 8 row groups x 4 lanes of a fragment hit 32 distinct banks.
// Tilings, as the caller picks them: O_S = 64, TR = 4 (8 warps, 195 KB of
// shared memory, one block per SM) for Cout % 64 == 0; otherwise O_S = 32,
// TR = 2 (4 warps, 89 KB, two per SM). Channels past C or Cout are staged as
// zeros and never written, so any C >= 1 and Cout >= 1 run: the generators
// of fmap_base 1024, 512 and 3072 train stages of 8 -> 4, 4 -> 2 and
// 24 -> 12 (dW (4, 8), (4, 4), (2, 4), (2, 2), (12, 24), (12, 12)) on the
// 32-channel tiling, a warp whose 8 input channels or 32 output channels
// lie wholly past them skipping its products. The split over blocks
// (ops/packed.py wgrad_ksplit) and with it dW's bits depend only on the
// shapes.
// `wgmma` is a later step: its shared-memory descriptors want aligned tiles,
// and the kx shift of the taps breaks that alignment.
#include "async_copy.cuh"
#include "conv_tile.cuh"
#include "tf32x3.cuh"

namespace probgan {

constexpr int kWgCS = 32;      // input channels per block: four warps' 8-channel groups
constexpr int kWgTW = 32;      // tile columns
constexpr int kWgXW = 40;      // staged x row: columns x0-4 .. x0+35, in 16-byte chunks
constexpr int kWgStages = 3;

template <int TR>
struct WgradTile {
  static constexpr int kDs = TR * kWgTW + 4;       // dpre row stride (floats), 4 mod 32
  static constexpr int kXs = (TR + 2) * kWgXW + 4;  // x channel stride, 4 mod 8 words
  static constexpr int kKSteps = TR * kWgTW / 8;
};

template <int WM, int TR>
__host__ __device__ constexpr size_t wgrad_stage_floats() {
  return static_cast<size_t>(32 * WM) * WgradTile<TR>::kDs +
         static_cast<size_t>(kWgCS) * WgradTile<TR>::kXs;
}

template <int WM, int TR>
__device__ __forceinline__ void wgrad_issue_tile(const float* __restrict__ x,
                                                 const float* __restrict__ dpre, float* stage,
                                                 int t, int C, int H, int W, int Cout, int c0,
                                                 int o0) {
  using T = WgradTile<TR>;
  constexpr int kOS = 32 * WM;
  constexpr int kThreadsW = 128 * WM;
  const int tiles_x = W / kWgTW;
  const int tiles_img = tiles_x * (H / TR);
  const int b = t / tiles_img;
  const int rem = t - b * tiles_img;
  const int y0 = (rem / tiles_x) * TR;
  const int x0 = (rem % tiles_x) * kWgTW;
  float* ds = stage;
  float* xs = stage + kOS * T::kDs;
  for (int idx = threadIdx.x; idx < kOS * TR * 8; idx += kThreadsW) {
    const int o = idx / (TR * 8);
    const int r = (idx >> 3) % TR;
    const int ch = idx & 7;
    const bool valid = o0 + o < Cout;
    const float* src =
        valid ? dpre + (static_cast<size_t>(b) * Cout + o0 + o) * H * W +
                    static_cast<size_t>(y0 + r) * W + x0 + ch * 4
              : dpre;
    cp_async16(ds + o * T::kDs + r * kWgTW + ch * 4, src, valid);
  }
  constexpr int kChunks = kWgXW / 4;
  for (int idx = threadIdx.x; idx < kWgCS * (TR + 2) * kChunks; idx += kThreadsW) {
    const int c = idx / ((TR + 2) * kChunks);
    const int hr = (idx / kChunks) % (TR + 2);
    const int ch = idx % kChunks;
    const int gy = y0 - 1 + hr;
    const int gx = x0 - 4 + ch * 4;
    const bool valid = c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src =
        valid ? x + (static_cast<size_t>(b) * C + c0 + c) * H * W + static_cast<size_t>(gy) * W + gx
              : x;
    cp_async16(xs + c * T::kXs + hr * kWgXW + ch * 4, src, valid);
  }
}

template <int WM, int TR>
__global__ void __launch_bounds__(128 * WM, 2 / WM)
    packed_conv_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dpre,
                             float* __restrict__ partials, int B, int C, int H, int W, int Cout,
                             int n_oslabs) {
  using T = WgradTile<TR>;
  constexpr int kOS = 32 * WM;
  constexpr size_t kStage = wgrad_stage_floats<WM, TR>();
  extern __shared__ __align__(16) float wg_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the mma fragments' row group and thread in group
  const int wm = warp >> 2, wn = warp & 3;
  const int c0 = (blockIdx.x / n_oslabs) * kWgCS;
  const int o0 = (blockIdx.x % n_oslabs) * kOS;
  const int n_tiles = B * (W / kWgTW) * (H / TR);
  const int n_mine =
      blockIdx.y < n_tiles ? (n_tiles - blockIdx.y + gridDim.y - 1) / gridDim.y : 0;
  // A warp whose channels lie past C or Cout sums zeros: it skips the products.
  const bool active = c0 + wn * 8 < C && o0 + wm * 32 < Cout;

  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < n_mine)
      wgrad_issue_tile<WM, TR>(x, dpre, wg_smem + s * kStage, blockIdx.y + s * gridDim.y, C, H,
                               W, Cout, c0, o0);
    cp_async_commit();
  }

  // acc: the block's sums; part: the last 8 k steps' (64 pixels'). The
  // tensor cores round each mma's sum toward zero, a bias of up to an ulp of
  // the accumulator per instruction that grows with the instructions summed
  // into one accumulator: over a block's ~16,000 pixels it lies far outside
  // the fp32 grade. Each 24-instruction part is added into acc with an fp32
  // add that rounds to nearest, which bounds the bias by the part's own size.
  float acc[2][9][4], part[2][9][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = part[mt][t][e] = 0.f;

  for (int it = 0; it < n_mine; ++it) {
    cp_async_wait(kWgStages - 2);
    // Tile `it` has landed for every thread, and the stage of tile it - 1
    // has been read by every warp: it takes tile it + 2.
    __syncthreads();
    {
      const int nx = it + kWgStages - 1;
      if (nx < n_mine)
        wgrad_issue_tile<WM, TR>(x, dpre, wg_smem + (nx % kWgStages) * kStage,
                                 blockIdx.y + nx * gridDim.y, C, H, W, Cout, c0, o0);
      cp_async_commit();
    }
    if (!active) continue;
    const float* ds = wg_smem + (it % kWgStages) * kStage;
    const float* xs = ds + kOS * T::kDs;
    const float* pa = ds + (wm * 32 + g) * T::kDs + tig;
    const float* pb = xs + (wn * 8 + g) * T::kXs + 3 + tig;  // column x0 - 1 + tig
#pragma unroll 1
    for (int s = 0; s < T::kKSteps; ++s) {
      const int r = s >> 2;
      const int col = (s & 3) * 8;
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = pa + mt * 16 * T::kDs + r * kWgTW + col;
        split_tf32(p[0], ah[mt][0], al[mt][0]);
        split_tf32(p[8 * T::kDs], ah[mt][1], al[mt][1]);
        split_tf32(p[4], ah[mt][2], al[mt][2]);
        split_tf32(p[8 * T::kDs + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* q = pb + (r + ky) * kWgXW + kx + col;
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(q[0], bh0, bl0);
          split_tf32(q[4], bh1, bl1);
          // the three terms, small first, with the two m16 tiles' chains
          // interleaved
          float(&d0)[4] = part[0][ky * 3 + kx];
          float(&d1)[4] = part[1][ky * 3 + kx];
          mma_tf32(d0, al[0], bh0, bh1);
          mma_tf32(d1, al[1], bh0, bh1);
          mma_tf32(d0, ah[0], bl0, bl1);
          mma_tf32(d1, ah[1], bl0, bl1);
          mma_tf32(d0, ah[0], bh0, bh1);
          mma_tf32(d1, ah[1], bh0, bh1);
        }
      }
      if ((s & 7) == 7) {  // warp-uniform
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int t = 0; t < 9; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mt][t][e] += part[mt][t][e];
              part[mt][t][e] = 0.f;
            }
      }
    }
  }
  cp_async_wait(0);

  // partials[k][tap][c][o]: d[0] (o, c), d[1] (o, c + 1), d[2] (o + 8, c),
  // d[3] (o + 8, c + 1), with o = o0 + wm*32 + mt*16 + g, c = c0 + wn*8 + 2*tig.
  float* out = partials + static_cast<size_t>(blockIdx.y) * 9 * C * Cout;
  const int c = c0 + wn * 8 + 2 * tig;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int o = o0 + wm * 32 + mt * 16 + g;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      float* dst = out + (static_cast<size_t>(t) * C + c) * Cout + o;
      if (c < C) {
        if (o < Cout) dst[0] = acc[mt][t][0];
        if (o + 8 < Cout) dst[8] = acc[mt][t][2];
      }
      if (c + 1 < C) {
        if (o < Cout) dst[Cout] = acc[mt][t][1];
        if (o + 8 < Cout) dst[Cout + 8] = acc[mt][t][3];
      }
    }
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

template <int WM, int TR>
int launch_wgrad(const float* x, const float* dpre, float* partials, int B, int C, int H, int W,
                 int cout, int ksplit, cudaStream_t s) {
  const size_t smem = kWgStages * wgrad_stage_floats<WM, TR>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(packed_conv_wgrad_kernel<WM, TR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_oslabs = (cout + 32 * WM - 1) / (32 * WM);
  const dim3 grid(((C + kWgCS - 1) / kWgCS) * n_oslabs, ksplit);
  packed_conv_wgrad_kernel<WM, TR><<<grid, 128 * WM, smem, s>>>(x, dpre, partials, B, C, H, W,
                                                                 cout, n_oslabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], dpre [B][Cout][H][W], scratch partials [ksplit][9][C][Cout]
// -> dw [Cout][C][3][3]. Any C >= 1 and Cout >= 1, H % 8 == 0, W % 32 == 0,
// x and dpre 16-byte aligned, 1 <= ksplit <= 65535. The caller picks the
// tiling (ops/packed.py:wgrad_tiling) and sizes ksplit for it: o_slab 64 with
// rows 4 (Cout % 64 == 0), or o_slab 32 with rows 2; any other pair is refused.
// Returns the cudaError_t of the launches (0 = both launched).
extern "C" int probgan_packed_conv_wgrad(const float* x, const float* dpre, float* partials,
                                         float* dw, int B, int C, int H, int W, int cout,
                                         int o_slab, int rows, int ksplit, void* stream) {
  using namespace probgan;
  const bool wide = o_slab == 64 && rows == 4 && cout % 64 == 0;
  const bool narrow = o_slab == 32 && rows == 2;
  if (B < 1 || C < 1 || cout < 1 || H < 8 || H % 8 || W < kWgTW ||
      W % kWgTW || ksplit < 1 || ksplit > 65535 || !(wide || narrow))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = wide ? launch_wgrad<2, 4>(x, dpre, partials, B, C, H, W, cout, ksplit, s)
                       : launch_wgrad<1, 2>(x, dpre, partials, B, C, H, W, cout, ksplit, s);
  if (err != 0) return err;
  const int n = 9 * C * cout;
  packed_conv_wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partials, dw, C, cout, ksplit);
  return static_cast<int>(cudaGetLastError());
}
