// packed_conv: 3x3 SAME conv + bias -> epilogue, fp32 NCHW. The epilogue is
// LeakyReLU(0.2) -> PixelNorm ("lrelu_norm", the generator), LeakyReLU(0.2)
// alone ("lrelu", the discriminator's conv1) or nothing ("none", the training
// backward's input-gradient convs and its pre-activation recompute).
//
// Replaces probgan_tpu/ops/pallas_packed.py:382 `packed_conv`: the stage-7
// conv2 of the 1024^2 generator (64 -> 64 channels at 512^2, "lrelu_norm"),
// the conv1 of the discriminator's two first blocks (32 -> 32 at 1024^2,
// 64 -> 64 at 512^2, "lrelu") and, with "none", the 20 launches of a train
// step at batch 2: (C, Cout, H) = (32, 32, 1024) x4, (32, 64, 1024) x3,
// (64, 32, 1024) x3, (64, 64, 512) x4, (64, 128, 512) x3, (128, 64, 512) x3;
// in the narrow generator's step (fmap_base 2048 at 1024^2) also the input
// gradients at 16 and 8 output channels: (8, 8, 1024), (16, 8, 1024),
// (16, 16, 512), (32, 16, 512).
//
// Two kernels behind one entry.
//
// "lrelu_norm" and "lrelu": fp32 FMAs on the CUDA cores, one fp32
// accumulator a value fed by fmaf in the order (input channel, ky, kx): the
// bits of conv_tile.cuh's conv3x3_accumulate, which packed_convpool (B5,
// conv_ring.cuh ConvPoolRing) keeps too, so B2 "lrelu" pooled in B5's order
// equals B5 "lrelu"; the stage-fused kernels (fused_ring.cuh) keep these
// bits too, so B10/B11 equal the pair (chip_smoke.py holds both bit for
// bit). Bound on the H100: operations, 2 * 9 * C * Cout FLOP a pixel:
// 0.577 ms for the 38.7 GFLOP shapes at batch 2 (32 -> 32 at 1024^2,
// 64 -> 64 at 512^2), 1.154 ms for the 77.3 GFLOP ones (the recompute's
// 32 -> 64 at 1024^2, 64 -> 128 at 512^2) at 67 TFLOP/s, against 0.08-0.24
// ms of bytes. Without PixelNorm the walk takes slabs of 64, 32, 16 or 8
// output channels (the largest that divides Cout rounded up to a multiple
// of 8), so "lrelu" takes any Cout >= 1 and any C >= 1: the generators of
// fmap_base 512, 1024 and 3072 recompute 4 -> 4, 2 -> 2 and 12 -> 12 in
// their training backward, the last slab's weights and bias zero-padded by
// the wrapper and only the channels below Cout stored. "lrelu_norm" takes
// Cout 8, 16, 32 or 64 in one slab. At 16
// and 8 (the narrow generators' late stages, e.g. fmap_base 2048 at 1024²:
// 16 -> 16 at 512², 8 -> 8 at 1024²) a block is 128 or 64 threads on the
// 32-channel tile (conv_tile.cuh Tile), 8 input channels a ring stage, two
// blocks an SM. "lrelu_norm" also takes any Cout from 1 to 64 and any C >= 1
// (the generators of fmap_base 512, 1024 or 3072: 4 -> 4, 24 -> 24,
// 48 -> 48) on the tile just above Cout, the wrapper's weights and bias
// zero-padded to it; PixelNorm's mean and the stores take the true Cout.
//
// What held the old loop (conv3x3_accumulate, which this kernel ran
// before the ring) at 41-54% of that
// bound, measured by utils/conv_clock_split.py (a clock64 split of each
// block's cycles; NVIDIA H100 80GB HBM3, 700 W, PERF.md): its blocks spent
// 53-66% of their cycles staging and 32-45% in FMAs. Each step stages 8
// input channels with scalar, bounds-checked loads (a div/mod an element)
// into registers, then shared memory, between two barriers; nothing is in
// flight while the FMAs run, and two blocks an SM hide only part of that.
// The design here (conv_ring.cuh): a ring of 3 stages of 16 channels
// filled by cp.async, one barrier a stage, persistent blocks walking the
// tiles, one block an SM. Its blocks spend 80-85% of their cycles in FMAs,
// 10-12% at the stage barrier with the copies issued, 5-9% in epilogues:
// 59-66% of the bound. What is left: one block an SM has nothing to run
// beside its barriers and epilogues, and two warps a scheduler issue the
// FMAs at ~77% of the rate.
//
// "none": 3xTF32 on the tensor cores (tf32x3.cuh), fp32 by accuracy. Bound
// on the H100: operations, 3 x 77.3 GFLOP of TF32 over 495 TFLOP/s = 0.469
// ms for the 77.3 GFLOP shapes above (0.234 for the 38.7 GFLOP ones; as fp32
// FMAs on the CUDA cores 1.154 / 0.577 ms), against 0.12-0.24 ms of bytes.
// An implicit GEMM: M = the pixels of a tile of TR rows x 32 columns of one
// image, N = a slab of NS output channels, K = 9 x C; no im2col reaches
// device memory.
//  * Tilings, as the caller picks them (ops/packed.py:conv_tiling): NS = 64,
//    TR = 8 for Cout % 64 == 0, else NS = 32, 16 or 8 (the largest that
//    divides Cout), TR = 16. Always 8 warps, each owning 4 tile rows x 16
//    columns (one m16 tile a row) x 32 output channels (four n8 tiles; 64
//    fp32 sums a thread) at NS = 64 and 32, x the slab's 16 or 8 (two n8
//    tiles or one) below. A Cout that is no multiple of 8 (the input
//    gradients 4 -> 4, 2 -> 2 and 12 -> 12 of the generators of fmap_base
//    1024, 512 and 3072) takes the slabs of Cout rounded up to 8, the
//    wrapper's weights and bias zero-padded to them; the epilogue stores
//    only the channels below Cout. Any C >= 1: channels past C are
//    zero-filled by the copies in x and in the weights alike, so a partial
//    k8 group multiplies zeros by zeros (never by stale shared memory).
//    The narrow slabs keep the 16 x 32-pixel tile and its 256 threads
//    rather than fewer threads on fewer pixels: at 16 and 8
//    output channels the staged x patch, (TR + 2) x 40 floats a channel
//    against 9 x NS of weights, is most of a stage, and a tile's pixels are
//    what that staging buys. They are bound by bytes (e.g. 8 -> 8 at 1024^2,
//    batch 2: 134 MB, 0.040 ms at 3.35 TB/s, against 7.2 GFLOP of TF32,
//    0.015 ms). C = 8 stages one k8 group of data and one of zeros; the
//    block skips the second (the `break` below).
//  * A persistent block walks tiles blockIdx.x, + gridDim.x, ..., and each
//    tile's input channels 16 at a time, through one ring of 3 shared-memory
//    stages filled by cp.async (16 bytes, .cg): x [16][TR+2][40] (the halo
//    rows and 4 columns of margin each side, zero outside the image) and the
//    slab's weights [16][9][NS]. So the next tile's first loads overlap this
//    tile's last products, and the nine tap-shifted A operands come from the
//    one staged halo tile.
//  * Per 8 input channels and tap column kx, a warp loads the A fragments of
//    its 6 halo rows once and uses each for up to three taps ky (output row
//    r reads halo row r + ky); per tap it loads one weight fragment per n8
//    tile. Both split into hi and lo as they are loaded, so the ring holds
//    fp32 only. Three mma per (row, n8 tile, tap): lo*hi, hi*lo, hi*hi, each
//    term over all 16 of the warp's sums before the next.
//  * The tensor cores round each mma's sum toward zero: a part of one group
//    of 8 input channels (27 mma per sum) is added into the fp32 sums with a
//    rounded add, which bounds the bias by the part's size.
//  * Dynamic shared memory, 3 stages (ops/packed.py:none_ring_bytes passes
//    it, launch_none checks it): 190,464 B at NS = 64, 196,608 at 32,
//    168,960 at 16 and 153,600 at 8, one block an SM at every slab.
//  * Bank-conflict-free fragment loads: x channel planes are (TR+2)*40 + 8
//    floats apart and weight rows 9*NS + 8 (9*NS at NS = 8), 24 and 8 or 24
//    mod 32 words.
//  * The epilogue adds the bias and stores NCHW straight from the fragments:
//    each store of a warp fills four whole 32-byte sectors.
//  * Every output is summed in one fixed order (input channels ascending,
//    taps kx-major within a group of 8), with no split over K: equal inputs
//    give equal bits.
#include "async_copy.cuh"
#include "conv_ring.cuh"
#include "tf32x3.cuh"

namespace probgan {

enum Epilogue { kLreluNorm = 0, kLrelu = 1, kNone = 2 };

// ---------------------------------------------------------------------------
// "lrelu_norm" and "lrelu": fp32 on the CUDA cores (conv_ring.cuh)
// ---------------------------------------------------------------------------

template <int COUT, bool NORM>
__global__ void __launch_bounds__(Tile<COUT>::THREADS, 1)
    packed_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y, int C, int H,
                       int W, int n_slabs, int cout, int n_tiles) {
  extern __shared__ __align__(16) float ring_smem[];
  ConvRing<COUT, NORM> cv(x, w, bias, y, C, H, W, n_slabs, cout);
  NoClock clk;
  ring_walk(cv, ring_smem, n_tiles, clk);
}

template <int COUT>
int launch_ring(const float* x, const float* w, const float* bias, float* y, int B, int C, int H,
                int W, int cout, int epilogue, int n_blocks, int smem, cudaStream_t stream) {
  using Ring = ConvRing<COUT, true>;
  // "lrelu_norm": one slab of up to COUT channels; "lrelu": slabs of COUT,
  // the last one's channels past Cout zero-padded by the wrapper and not
  // stored
  const int n_slabs = epilogue == kLreluNorm ? 1 : (cout + COUT - 1) / COUT;
  const long long n_tiles = static_cast<long long>(B) * (H / Tile<COUT>::TH) *
                            (W / Tile<COUT>::TW) * n_slabs;
  if (H % Tile<COUT>::TH || n_tiles > 0x7fffffff || smem != Ring::kBytes ||
      (epilogue == kLreluNorm && cout > COUT))
    return cudaErrorInvalidValue;
  const auto kernel = epilogue == kLreluNorm ? packed_conv_kernel<COUT, true>
                                             : packed_conv_kernel<COUT, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, Tile<COUT>::THREADS, smem, stream>>>(x, w, bias, y, C, H, W, n_slabs, cout,
                                                          static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// "none": 3xTF32 implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kNoneThreads = 256;
constexpr int kNoneCS = 16;  // input channels per ring stage: two k8 groups
constexpr int kNoneTW = 32;  // tile columns
constexpr int kNoneXW = 40;  // staged x row: columns x0-4 .. x0+35, in 16-byte chunks
constexpr int kNoneStages = 3;

template <int NS>
struct NoneTile {
  static_assert(NS == 8 || NS == 16 || NS == 32 || NS == 64,
                "the none kernel is built for slabs of 8, 16, 32 or 64");
  static constexpr int WN = NS == 64 ? 2 : 1;          // warps across the slab's channels
  static constexpr int NT = (NS == 64 ? 32 : NS) / 8;  // n8 tiles a warp: 4, 4, 2, 1
  static constexpr int WR = 4 / WN;                    // warps down the tile's rows
  static constexpr int TR = 4 * WR;                    // tile rows: 8 at 64, else 16
  static constexpr int kXs = (TR + 2) * kNoneXW + 8;   // x channel stride, 24 mod 32
  // weight row stride, 8 or 24 mod 32 (9 * NS is 0, 16 or 8 mod 32)
  static constexpr int kWs = 9 * NS + ((9 * NS) % 32 == 8 ? 0 : 8);
  static constexpr int kStage = kNoneCS * (kXs + kWs);  // floats
};

struct NoneGeom {
  int tiles_x, tiles_y, n_slabs;
};

// Tile t of the grid walk: the slab fastest (the tiles that share one x
// tile run together), then columns, rows and images.
__device__ __forceinline__ void none_tile(int t, const NoneGeom& gm, int tr, int& b,
                                          int& y0, int& x0, int& slab) {
  slab = t % gm.n_slabs;
  t /= gm.n_slabs;
  x0 = (t % gm.tiles_x) * kNoneTW;
  t /= gm.tiles_x;
  y0 = (t % gm.tiles_y) * tr;
  b = t / gm.tiles_y;
}

// Start the copies of one stage: input channels c0 .. c0 + 15 of tile
// (b, y0, x0) with their halo, and the slab's weights for those channels.
// Channels past C, and halo outside the image, are zero-filled.
template <int NS>
__device__ __forceinline__ void none_issue(const float* __restrict__ x,
                                           const float* __restrict__ wk, float* stage, int b,
                                           int y0, int x0, int slab, int c0, int C, int H,
                                           int W) {
  using T = NoneTile<NS>;
  float* xs = stage;
  float* ws = stage + kNoneCS * T::kXs;
  constexpr int kXChunks = kNoneXW / 4;
  constexpr int kPlane = (T::TR + 2) * kXChunks;
  for (int idx = threadIdx.x; idx < kNoneCS * kPlane; idx += kNoneThreads) {
    const int c = idx / kPlane;
    const int rem = idx - c * kPlane;
    const int hr = rem / kXChunks;
    const int ch = rem - hr * kXChunks;
    const int gy = y0 - 1 + hr;
    const int gx = x0 - 4 + ch * 4;
    const bool valid = c0 + c < C && gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src =
        valid ? x + (static_cast<size_t>(b) * C + c0 + c) * H * W + static_cast<size_t>(gy) * W + gx
              : x;
    cp_async16(xs + c * T::kXs + hr * kNoneXW + ch * 4, src, valid);
  }
  constexpr int kWChunks = 9 * NS / 4;
  const float* wslab = wk + static_cast<size_t>(slab) * C * 9 * NS;
  for (int idx = threadIdx.x; idx < kNoneCS * kWChunks; idx += kNoneThreads) {
    const int c = idx / kWChunks;
    const int ch = idx - c * kWChunks;
    const bool valid = c0 + c < C;
    const float* src = valid ? wslab + static_cast<size_t>(c0 + c) * 9 * NS + ch * 4 : wk;
    cp_async16(ws + c * T::kWs + ch * 4, src, valid);
  }
}

template <int NS>
__global__ void __launch_bounds__(kNoneThreads, 1)
    packed_conv_none_kernel(const float* __restrict__ x, const float* __restrict__ wk,
                            const float* __restrict__ bias, float* __restrict__ y, int B, int C,
                            int H, int W, int cout) {
  using T = NoneTile<NS>;
  extern __shared__ __align__(16) float none_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // the mma fragments' row group and thread in group
  const int wc = warp & 1;                  // tile columns 16*wc .. +16
  const int wn = (warp >> 1) % T::WN;       // slab channels 32*wn .. +32
  const int wr = warp / (2 * T::WN);        // tile rows 4*wr .. +4
  const NoneGeom gm{W / kNoneTW, H / T::TR, (cout + NS - 1) / NS};
  const int n_tiles = B * gm.tiles_y * gm.tiles_x * gm.n_slabs;
  const int n_chunks = (C + kNoneCS - 1) / kNoneCS;
  const int my_tiles =
      static_cast<int>(blockIdx.x) < n_tiles ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                                             : 0;
  const int n_steps = my_tiles * n_chunks;

  // step s of the block's walk: chunk s % n_chunks of its tile s / n_chunks
  auto issue = [&](int s) {
    int b, y0, x0, slab;
    none_tile(blockIdx.x + (s / n_chunks) * gridDim.x, gm, T::TR, b, y0, x0, slab);
    none_issue<NS>(x, wk, none_smem + (s % kNoneStages) * T::kStage, b, y0, x0, slab,
                   (s % n_chunks) * kNoneCS, C, H, W);
  };
  for (int s = 0; s < kNoneStages - 1; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }

  // acc: the tile's sums; part: the last group of 8 input channels' (see
  // tf32x3.cuh: the tensor cores round each mma's sum toward zero).
  float acc[4][T::NT][4], part[4][T::NT][4];
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait(kNoneStages - 2);
    // Step `it` has landed for every thread, and the stage of step it - 1
    // has been read by every warp: it takes step it + 2.
    __syncthreads();
    if (it + kNoneStages - 1 < n_steps) issue(it + kNoneStages - 1);
    cp_async_commit();

    const int chunk = it % n_chunks;
    if (chunk == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][nt][e] = part[r][nt][e] = 0.f;
    }
    const float* xs = none_smem + (it % kNoneStages) * T::kStage;
    const float* ws = xs + kNoneCS * T::kXs;
    // A (16 pixels x 8 channels): pixel g is staged column 16*wc + kx + 3 + g
    // (input column x0 + 16*wc + g + kx - 1), channel tig; B (8 channels x 8
    // outputs): channel tig, slab channel 32*wn + 8*nt + g.
    const float* pa = xs + tig * T::kXs + 4 * wr * kNoneXW + 16 * wc + 3 + g;
    const float* pb = ws + tig * T::kWs + 32 * wn + g;
#pragma unroll 1
    for (int kg = 0; kg < kNoneCS / 8; ++kg) {
      if (chunk * kNoneCS + kg * 8 >= C) break;  // block-uniform: only zeros remain
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        unsigned ah[6][4], al[6][4];
#pragma unroll
        for (int hr = 0; hr < 6; ++hr) {
          const float* p = pa + kg * 8 * T::kXs + hr * kNoneXW + kx;
          split_tf32(p[0], ah[hr][0], al[hr][0]);
          split_tf32(p[8], ah[hr][1], al[hr][1]);
          split_tf32(p[4 * T::kXs], ah[hr][2], al[hr][2]);
          split_tf32(p[4 * T::kXs + 8], ah[hr][3], al[hr][3]);
        }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          unsigned bh[T::NT][2], bl[T::NT][2];
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt) {
            const float* q = pb + kg * 8 * T::kWs + (ky * 3 + kx) * NS + nt * 8;
            split_tf32(q[0], bh[nt][0], bl[nt][0]);
            split_tf32(q[4 * T::kWs], bh[nt][1], bl[nt][1]);
          }
          // the three terms, small first, each over the warp's 16 sums
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) mma_tf32(part[r][nt], al[r + ky], bh[nt][0], bh[nt][1]);
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) mma_tf32(part[r][nt], ah[r + ky], bl[nt][0], bl[nt][1]);
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) mma_tf32(part[r][nt], ah[r + ky], bh[nt][0], bh[nt][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[r][nt][e] += part[r][nt][e];
            part[r][nt][e] = 0.f;
          }
    }

    if (chunk == n_chunks - 1) {
      // d[0] (pixel g, channel 2*tig), d[1] (g, 2*tig + 1), d[2] (g + 8,
      // 2*tig), d[3] (g + 8, 2*tig + 1), + bias, into NCHW
      int b, y0, x0, slab;
      none_tile(blockIdx.x + (it / n_chunks) * gridDim.x, gm, T::TR, b, y0, x0, slab);
      const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) {
        const int o = slab * NS + 32 * wn + 8 * nt + 2 * tig;
        const float b0 = __ldg(bias + o), b1 = __ldg(bias + o + 1);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float* p = y + (static_cast<size_t>(b) * cout + o) * plane +
                     static_cast<size_t>(y0 + 4 * wr + r) * W + x0 + 16 * wc + g;
          if (o < cout) {  // the padded channels of a last slab are not stored
            p[0] = acc[r][nt][0] + b0;
            p[8] = acc[r][nt][2] + b0;
          }
          if (o + 1 < cout) {
            p[plane] = acc[r][nt][1] + b1;
            p[plane + 8] = acc[r][nt][3] + b1;
          }
        }
      }
    }
  }
  cp_async_wait(0);
}

template <int NS>
int launch_none(const float* x, const float* wk, const float* bias, float* y, int B, int C,
                int H, int W, int cout, int n_blocks, int smem_bytes, cudaStream_t stream) {
  using T = NoneTile<NS>;
  const size_t smem = kNoneStages * T::kStage * sizeof(float);
  if (H % T::TR || static_cast<size_t>(smem_bytes) != smem)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(packed_conv_none_kernel<NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  packed_conv_none_kernel<NS>
      <<<n_blocks, kNoneThreads, smem, stream>>>(x, wk, bias, y, B, C, H, W, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan

// x [B][C][H][W], w [Cout/CT][C][3][3][CT] (eq-LR scaled; CT the largest of
// 64, 32, 16 and 8 that divides Cout: for Cout 8, 16, 32 or 64 that is
// [C][3][3][Cout]), bias [Cout] -> y [B][Cout][H][W]; epilogue 0 =
// lrelu_norm (Cout 1 to 64 in one slab: CT the least of 8, 16, 32 and 64 at
// or above it, w [C][3][3][CT] and bias [CT] zero-padded past Cout), 1 =
// lrelu, 2 = none (any Cout >= 1: CT the largest of 64, 32, 16 and 8 that
// divides C8, Cout rounded up to a multiple of 8, w [C8/CT][C][3][3][CT] and
// bias [C8] zero-padded past Cout), every epilogue at any C >= 1; y holds
// the true Cout channels. Every epilogue takes the tiling the caller picked
// (ops/packed.py:conv_tiling): o_slab = CT with rows 8 at 64 and 16 below,
// and n_blocks persistent blocks, and the dynamic shared memory in bytes,
// checked against the kernel's: the ring's for "lrelu_norm" and "lrelu"
// (ops/packed.py:conv_ring_bytes), the "none" kernel's for "none"
// (ops/packed.py:none_ring_bytes); x and w 16-byte aligned. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int probgan_packed_conv(const float* x, const float* w, const float* bias, float* y,
                                   int B, int C, int H, int W, int cout, int epilogue,
                                   int o_slab, int rows, int n_blocks, int smem, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool norm = epilogue == probgan::kLreluNorm;
  if (cout < 1 || (norm && cout > 64)) return cudaErrorInvalidValue;
  const int c8 = (cout + 7) / 8 * 8;  // the padded Cout a sliced walk tiles
  const int slab = norm ? (cout <= 8 ? 8 : cout <= 16 ? 16 : cout <= 32 ? 32 : 64)
                        : c8 % 64 == 0 ? 64 : c8 % 32 == 0 ? 32 : c8 % 16 == 0 ? 16 : 8;
  if (B < 1 || C < 1 || W < probgan::kNoneTW || W % probgan::kNoneTW ||
      H < rows || n_blocks < 1 || o_slab != slab || rows != (slab == 64 ? 8 : 16))
    return cudaErrorInvalidValue;
  if (epilogue == probgan::kNone) {
#define PROBGAN_NONE(NS) \
  probgan::launch_none<NS>(x, w, bias, y, B, C, H, W, cout, n_blocks, smem, s)
    switch (slab) {
      case 64: return PROBGAN_NONE(64);
      case 32: return PROBGAN_NONE(32);
      case 16: return PROBGAN_NONE(16);
      default: return PROBGAN_NONE(8);
    }
#undef PROBGAN_NONE
  }
  if (epilogue != probgan::kLreluNorm && epilogue != probgan::kLrelu)
    return cudaErrorInvalidValue;
#define PROBGAN_RING(CT) \
  probgan::launch_ring<CT>(x, w, bias, y, B, C, H, W, cout, epilogue, n_blocks, smem, s)
  switch (slab) {
    case 64: return PROBGAN_RING(64);
    case 32: return PROBGAN_RING(32);
    case 16: return PROBGAN_RING(16);
    default: return PROBGAN_RING(8);
  }
#undef PROBGAN_RING
}
