// packed_conv_wgrad_bf16: kernel mode "default" (one bf16 pass) of
// packed_conv_wgrad, the weight gradient of a 3x3 SAME conv, fp32 NCHW:
//   dW[o][c][ky][kx] = sum over (b, y, x) of
//       bf16(x_pad[b][c][y + ky - 1][x + kx - 1]) * bf16(dpre[b][o][y][x])
// with x [B][C][H][W] the conv's input (zero outside the image), dpre
// [B][Cout][H][W] the cotangent of its pre-bias output, both operands rounded
// to bf16 (to nearest even) and the products summed in fp32.
//
// Replaces probgan_tpu/ops/pallas_packed.py:558 `packed_conv_wgrad` at mode
// "default" (its dot at Precision.DEFAULT, :592-621): every weight gradient
// of the train step at packed_train_mode "default", the reference's training
// default. At batch 2 of the 1024^2 step, (C, Cout, H) = (32, 32, 1024),
// (32, 64, 1024), (64, 64, 512), (64, 128, 512) in the discriminator and
// (128, 64, 512), (64, 32, 1024), (64, 64, 512), (32, 32, 1024) in the
// generator.
//
// Bound on the H100: bytes. x and dpre are read once as fp32, 403-805 MB a
// shape (0.12-0.24 ms at 3.35 TB/s); the products are 38.7-77.3 GFLOP
// (0.039-0.078 ms at the 989 TFLOP/s of bf16).
//
// Design: packed_conv_wgrad.cu's implicit GEMM, M = Cout, N = 9 * C, K =
// B * H * W pixels, with its split-K over the wrapper's constant number of
// blocks, its ring of 3 cp.async stages of fp32 tiles (dpre [O_S][TR*32],
// x [32][TR+2][40] with the halo rows and a 4-column margin), its warp layout
// (warp (wm, wn): output channels wm*32 .. +32, input channels wn*8 .. +8 at
// all nine taps, 72 fp32 sums a thread) and its second kernel that adds the
// partials in ascending k (no atomics: equal inputs give equal bits). What
// changes is the product: one mma.sync.m16n8k16 with bf16 operands a
// (m, n) tile and k16 step of 16 pixels, where the fp32 kernel ran three
// TF32 m16n8k8 a k8 step. The operands are rounded at the fragment load (two
// neighbouring pixels packed into one register), so the ring keeps fp32 and
// any tap's column shift reads the same staged tile. A product of two bf16
// values is exact in fp32: the kernel and its twin (the nine einsums on the
// rounded operands) differ only in the order of the sums. The tensor cores
// round each mma's sum toward zero; a part of 4 k16 steps (64 pixels) is
// added into the thread's fp32 sums with a rounded add, which keeps that bias
// within the part's own size (see packed_conv_wgrad.cu).
//  * dpre rows are padded to TR*32 + 8 floats (8 mod 32 words): the A
//    fragments are float2 loads, and each half-warp's 16 lanes (4 row groups
//    x 4 lanes, two words each) hit 32 distinct banks. The x fragments are
//    scalar loads at any tap's shift (an odd shift breaks float2 alignment).
// Tilings, as the caller picks them (ops/packed.py:wgrad_tiling, the fp32
// kernel's): O_S = 64, TR = 4 (8 warps, 198 KB of shared memory, one block an
// SM) for Cout % 64 == 0; otherwise O_S = 32, TR = 2 (4 warps, 91 KB, two an
// SM). Channels past C or Cout are staged as zeros and never written.
#include "async_copy.cuh"
#include "bf16_conv.cuh"

namespace probgan {

constexpr int kWbCS = 32;      // input channels per block: four warps' 8-channel groups
constexpr int kWbTW = 32;      // tile columns
constexpr int kWbXW = 40;      // staged x row: columns x0-4 .. x0+35, in 16-byte chunks
constexpr int kWbStages = 3;

template <int TR>
struct WgradBf16Tile {
  static constexpr int kDs = TR * kWbTW + 8;        // dpre row stride (floats), 8 mod 32
  static constexpr int kXs = (TR + 2) * kWbXW + 4;  // x channel stride (floats)
  static constexpr int kKSteps = TR * kWbTW / 16;   // k16 steps a tile: two a row
};

template <int WM, int TR>
__host__ __device__ constexpr size_t wgrad_bf16_stage_floats() {
  return static_cast<size_t>(32 * WM) * WgradBf16Tile<TR>::kDs +
         static_cast<size_t>(kWbCS) * WgradBf16Tile<TR>::kXs;
}

// Stage tile t's dpre rows of the block's output channels and its x halo
// patch of the block's input channels into `stage` (cp.async, zeros outside
// the image and past C or Cout).
template <int WM, int TR>
__device__ __forceinline__ void wgrad_bf16_issue_tile(const float* __restrict__ x,
                                                      const float* __restrict__ dpre,
                                                      float* stage, int t, int C, int H, int W,
                                                      int Cout, int c0, int o0) {
  using T = WgradBf16Tile<TR>;
  constexpr int kOS = 32 * WM;
  constexpr int kThreadsW = 128 * WM;
  const int tiles_x = W / kWbTW;
  const int tiles_img = tiles_x * (H / TR);
  const int b = t / tiles_img;
  const int rem = t - b * tiles_img;
  const int y0 = (rem / tiles_x) * TR;
  const int x0 = (rem % tiles_x) * kWbTW;
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
    cp_async16(ds + o * T::kDs + r * kWbTW + ch * 4, src, valid);
  }
  constexpr int kChunks = kWbXW / 4;
  for (int idx = threadIdx.x; idx < kWbCS * (TR + 2) * kChunks; idx += kThreadsW) {
    const int c = idx / ((TR + 2) * kChunks);
    const int hr = (idx / kChunks) % (TR + 2);
    const int ch = idx % kChunks;
    const int gy = y0 - 1 + hr;
    const int gx = x0 - 4 + ch * 4;
    const bool valid = c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src =
        valid ? x + (static_cast<size_t>(b) * C + c0 + c) * H * W + static_cast<size_t>(gy) * W + gx
              : x;
    cp_async16(xs + c * T::kXs + hr * kWbXW + ch * 4, src, valid);
  }
}

template <int WM, int TR>
__global__ void __launch_bounds__(128 * WM, 2 / WM)
    packed_conv_wgrad_bf16_kernel(const float* __restrict__ x, const float* __restrict__ dpre,
                                  float* __restrict__ partials, int B, int C, int H, int W,
                                  int Cout, int n_oslabs) {
  using T = WgradBf16Tile<TR>;
  constexpr int kOS = 32 * WM;
  constexpr size_t kStage = wgrad_bf16_stage_floats<WM, TR>();
  extern __shared__ __align__(16) float wb_smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the mma fragments' row group and thread in group
  const int wm = warp >> 2, wn = warp & 3;
  const int c0 = (blockIdx.x / n_oslabs) * kWbCS;
  const int o0 = (blockIdx.x % n_oslabs) * kOS;
  const int n_tiles = B * (W / kWbTW) * (H / TR);
  const int n_mine =
      blockIdx.y < n_tiles ? (n_tiles - blockIdx.y + gridDim.y - 1) / gridDim.y : 0;
  // A warp whose channels lie past C or Cout sums zeros: it skips the products.
  const bool active = c0 + wn * 8 < C && o0 + wm * 32 < Cout;

  for (int s = 0; s < kWbStages - 1; ++s) {
    if (s < n_mine)
      wgrad_bf16_issue_tile<WM, TR>(x, dpre, wb_smem + s * kStage, blockIdx.y + s * gridDim.y,
                                    C, H, W, Cout, c0, o0);
    cp_async_commit();
  }

  // acc: the block's sums; part: the last 4 k16 steps' (64 pixels').
  float acc[2][9][4], part[2][9][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = part[mt][t][e] = 0.f;

  for (int it = 0; it < n_mine; ++it) {
    cp_async_wait(kWbStages - 2);
    // Tile `it` has landed for every thread, and the stage of tile it - 1
    // has been read by every warp: it takes tile it + 2.
    __syncthreads();
    {
      const int nx = it + kWbStages - 1;
      if (nx < n_mine)
        wgrad_bf16_issue_tile<WM, TR>(x, dpre, wb_smem + (nx % kWbStages) * kStage,
                                      blockIdx.y + nx * gridDim.y, C, H, W, Cout, c0, o0);
      cp_async_commit();
    }
    if (!active) continue;
    const float* ds = wb_smem + (it % kWbStages) * kStage;
    const float* xs = ds + kOS * T::kDs;
    const float* pa = ds + (wm * 32 + g) * T::kDs + 2 * tig;
    const float* pb = xs + (wn * 8 + g) * T::kXs + 3 + 2 * tig;  // column x0 - 1 + 2 tig
#pragma unroll 1
    for (int s = 0; s < T::kKSteps; ++s) {
      const int r = s >> 1;
      const int col = (s & 1) * 16;
      // A (16 output channels x 16 pixels): a = {A[g][2t..], A[g+8][2t..],
      // A[g][2t+8..], A[g+8][2t+8..]}, two neighbouring pixels a register
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* p = pa + mt * 16 * T::kDs + r * kWbTW + col;
        const float2 v0 = *reinterpret_cast<const float2*>(p);
        const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * T::kDs);
        const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
        const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * T::kDs + 8);
        a[mt][0] = pack_bf16(v0.x, v0.y);
        a[mt][1] = pack_bf16(v1.x, v1.y);
        a[mt][2] = pack_bf16(v2.x, v2.y);
        a[mt][3] = pack_bf16(v3.x, v3.y);
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          // B (16 pixels x 8 input channels), x shifted by the tap:
          // b = {B[2t..][g], B[2t+8..][g]}
          const float* q = pb + (r + ky) * kWbXW + kx + col;
          const unsigned b0 = pack_bf16(q[0], q[1]);
          const unsigned b1 = pack_bf16(q[8], q[9]);
          mma_bf16(part[0][ky * 3 + kx], a[0], b0, b1);
          mma_bf16(part[1][ky * 3 + kx], a[1], b0, b1);
        }
      }
      if ((s & 3) == 3) {  // warp-uniform; kKSteps is a multiple of 4
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
__global__ void packed_conv_wgrad_bf16_reduce_kernel(const float* __restrict__ partials,
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
int launch_wgrad_bf16(const float* x, const float* dpre, float* partials, int B, int C, int H,
                      int W, int cout, int ksplit, cudaStream_t s) {
  const size_t smem = kWbStages * wgrad_bf16_stage_floats<WM, TR>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(packed_conv_wgrad_bf16_kernel<WM, TR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_oslabs = (cout + 32 * WM - 1) / (32 * WM);
  const dim3 grid(((C + kWbCS - 1) / kWbCS) * n_oslabs, ksplit);
  packed_conv_wgrad_bf16_kernel<WM, TR><<<grid, 128 * WM, smem, s>>>(x, dpre, partials, B, C,
                                                                      H, W, cout, n_oslabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], dpre [B][Cout][H][W], scratch partials [ksplit][9][C][Cout]
// -> dw [Cout][C][3][3], the operands rounded to bf16. Any C >= 1 and Cout >=
// 1 (channels past them staged as zeros and not written, as in
// packed_conv_wgrad.cu), H % 8 == 0, W % 32 == 0, x and dpre 16-byte
// aligned, 1 <= ksplit <=
// 65535. The caller picks the tiling (ops/packed.py:wgrad_tiling) and sizes
// ksplit for it: o_slab 64 with rows 4 (Cout % 64 == 0), or o_slab 32 with
// rows 2; any other pair is refused. Returns the cudaError_t of the launches
// (0 = both launched).
extern "C" int probgan_packed_conv_wgrad_bf16(const float* x, const float* dpre,
                                              float* partials, float* dw, int B, int C, int H,
                                              int W, int cout, int o_slab, int rows, int ksplit,
                                              void* stream) {
  using namespace probgan;
  const bool wide = o_slab == 64 && rows == 4 && cout % 64 == 0;
  const bool narrow = o_slab == 32 && rows == 2;
  if (B < 1 || C < 1 || cout < 1 || H < 8 || H % 8 || W < kWbTW ||
      W % kWbTW || ksplit < 1 || ksplit > 65535 || !(wide || narrow))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int err = wide ? launch_wgrad_bf16<2, 4>(x, dpre, partials, B, C, H, W, cout, ksplit, s)
                       : launch_wgrad_bf16<1, 2>(x, dpre, partials, B, C, H, W, cout, ksplit, s);
  if (err != 0) return err;
  const int n = 9 * C * cout;
  packed_conv_wgrad_bf16_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(partials, dw, C, cout,
                                                                         ksplit);
  return static_cast<int>(cudaGetLastError());
}
