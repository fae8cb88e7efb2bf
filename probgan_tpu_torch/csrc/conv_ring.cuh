// The pipelined fp32 main loop of packed_conv.cu's "lrelu" / "lrelu_norm"
// kernel (B2), of packed_conv_rgb.cu (B3, B2 "lrelu_norm" with the final
// stage's toRGB tail), of packed_convpool.cu (B5, B2's tiles with a 2 x 4
// pixel map and the 2x2 mean pool) and of packed_upconv.cu (B1): a
// persistent block walks output tiles, and its input channels stream through
// a ring of shared-memory stages filled by cp.async while the FMAs of an
// earlier stage run.
//
// What it keeps from conv_tile.cuh, so that every output has the bits of the
// loop it replaces (conv3x3_accumulate, its pool map for B5, and B1's own
// loop before it): the block of 256 threads owns a tile of output pixels and
// ALL output channels of its slab; a thread holds 8 pixels x 8 channels (Tile<COUT>, channel_of),
// the COUT/8 lanes of a pixel group are neighbours in one warp, and every
// value takes its products in one fp32 accumulator fed by fmaf in the order
// (input channel, ky, kx) (B1: input channel, dy, dx of its parity's
// pre-summed taps). The epilogues are conv_tile.cuh's bias_lrelu_norm /
// bias_act and store_rows, unchanged.
//
// What it changes, all around the FMAs:
//  * Each ring stage holds 16 input channels (the old loop: 8) of the
//    tile's halo patch and their weights, copied by cp.async in 16-byte
//    pieces only (.cg, L2 -> shared): a staged patch row spans the columns
//    x0-4 .. x0+35 (B1: j0-4 .. j0+19), whole aligned 16-byte chunks, so the
//    +-1 halo columns come inside the chunks at the patch's ends, which are
//    zero-filled (src-size 0) outside the image, as are rows above or below
//    it. The 6 extra floats a row cost nothing the L2 notices; every copy is
//    one instruction with one zero-fill rule.
//  * Each thread works out its copies' places in the patch once, at the
//    start (RingCopies); a step adds the tile's corner and tests a row.
//  * One __syncthreads per stage: the copies of steps s+1 and s+2 are in
//    flight while the FMAs of step s run (3 stages), and a block's walk
//    runs through its tiles without a break, so the next tile's first
//    copies overlap the current tile's last FMAs, its epilogue and stores.
//  * Persistent blocks, one an SM (the wrapper launches min(tiles, SMs)):
//    a ring of 3 stages of 16 channels is 195,072 B (B2, Cout 64) to
//    207,360 B (B2, Cout 32), too large for two blocks in an SM's 228 KB;
//    one block of 256 threads may then take up to 255 registers a thread
//    (the old loop: 128, with spills in B1).
//
// Shared memory a block (floats; rows padded so that the lanes of a warp hit
// distinct banks in the thread's aligned float4 read of the patch):
//   B2, B3, B5 Cout 64: x 16 ch x 10 rows x 44 + w 16 x 9 x 64  = 16,256 a stage
//   B2, B3, B5 Cout 32: x 16 ch x 18 rows x 44 + w 16 x 9 x 32  = 17,280 a stage
//   B1 Cout 64: x 16 ch x  9 rows x 24 + w 16 x 8 x 64  = 11,648 a stage
//   B1 Cout 32: x 16 ch x 17 rows x 48 + w 16 x 8 x 32  = 17,152 a stage
// times 3 stages x 4 B: 195,072 / 207,360 / 139,776 / 205,824 B, each under
// the 232,448 B a block may have; a second block (plus the 1 KB the card
// reserves for each) would not fit, so the design is one block an SM. At
// Cout 16 and 8 (blocks of 128 and 64 threads on the 32-channel tile, 8
// input channels a stage) a ring is 82,944 to 90,624 B and two blocks share
// an SM (ops/packed.py ring_blocks_per_sm).
//
// Any width up to 64 (B1, B2 "lrelu_norm", B3): a Cout between
// the tiles runs on the one above it (conv_tile.cuh), with the weights,
// bias and toRGB weights zero-padded by the wrapper and `cout` the true
// count: PixelNorm's mean and the stores take only it. Any Cout at all (B2
// "lrelu", B5): slabs of Cout rounded up to a multiple of 8, the last
// one's padded channels computed and not stored. Every value keeps its one
// accumulator and its order of FMAs whatever the tile or slab, so B2
// "lrelu" at a slab of 16 gives the pre-activations of B2 "lrelu_norm" on
// the tile of 64 bit for bit (the backward's recompute of Cout 48). Input channels past
// C (any C >= 1) are zero in the patch (the copies' zero-fill) and in the
// weights (ring_copy_weights copies only the chunk's C - c0 rows), so they
// add exact zeros; B1's toRGB reads no weight past C.
//
// The walk is generic over the tile (ring_walk takes the tile's copies,
// FMAs and epilogue from a struct): fused_ring.cuh's stage-fused tiles walk
// it in two phases.
#pragma once

#include "async_copy.cuh"
#include "conv_tile.cuh"

namespace probgan {

// One thread's share of a stage's patch copies: N 16-byte chunks of the
// [CC][SH][XW] patch, chunk idx = threadIdx.x + k * THREADS in
// (channel, row, chunk) order. meta packs the chunk's shared-memory offset
// (bits 0-15), its patch row (16-21), its chunk in the row (22-25) and its
// channel (26-30), worked out once; -1 marks no copy. A step adds the
// chunk's global offset, channel * H * W + row * W + 4 * chunk, to the
// patch's corner.
template <int CC, int N, int THREADS = kThreads>
struct RingCopies {
  int meta[N];

  template <int SH, int XW, int SW>
  __device__ __forceinline__ void init() {
    constexpr int kChunks = XW / 4;
    static_assert(CC * SH * SW <= 0x10000 && SH <= 64 && kChunks <= 16 && CC <= 32,
                  "the fields of meta");
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int idx = threadIdx.x + k * THREADS;
      const int ch = idx % kChunks;
      const int rc = idx / kChunks;
      const int r = rc % SH;
      const int c = rc / SH;
      meta[k] = idx >= CC * SH * kChunks
                    ? -1
                    : ((c * SH + r) * SW + 4 * ch) | r << 16 | ch << 22 | c << 26;
    }
  }

  // Start the copies of one stage: patch row 0, column 0 is element
  // `corner` of x (channel c0, input row `row`). Rows outside 0..H-1, the
  // first chunk of a row when first_ok is false, its last (chunk
  // kChunks - 1) when last_ok is false, and channels at or past
  // c0 + c_left are zero-filled.
  template <int kChunks>
  __device__ __forceinline__ void issue(float* xs, const float* __restrict__ x, long long corner,
                                        int row, int H, int W, bool first_ok, bool last_ok,
                                        int c_left) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int m = meta[k];
      if (m < 0) continue;
      const int r = (m >> 16) & 63;
      const int ch = (m >> 22) & 15;
      const int c = (m >> 26) & 31;
      const bool valid = c < c_left &&
                         static_cast<unsigned>(row + r) < static_cast<unsigned>(H) &&
                         (ch != 0 || first_ok) && (ch != kChunks - 1 || last_ok);
      const long long off = corner + (static_cast<long long>(c) * H + r) * W + 4 * ch;
      cp_async16(xs + (m & 0xFFFF), valid ? x + off : x, valid);
    }
  }
};

// 4 * N4 floats of weights, contiguous in global and in shared memory, 16
// bytes a copy; the first `valid_n` floats are copied, the rest zeroed.
template <int N4, int THREADS = kThreads>
__device__ __forceinline__ void ring_copy_weights(float* ws, const float* __restrict__ src,
                                                  const float* __restrict__ any, int valid_n) {
#pragma unroll
  for (int k = 0; k < (N4 + THREADS - 1) / THREADS; ++k) {
    const int e = threadIdx.x + k * THREADS;
    if (e < N4) {
      const bool valid = 4 * e < valid_n;
      cp_async16(ws + 4 * e, valid ? src + 4 * e : any, valid);
    }
  }
}

// The walk of a persistent block: tiles blockIdx.x, + gridDim.x, ... of
// n_tiles, each in cv.n_chunks steps of Conv::kCC input channels, through
// a ring of Conv::kStages stages. Conv provides kStage (floats a stage),
// kAcc (accumulator rows a thread), kPhases, n_chunks, issue(stage, tile,
// chunk), compute(stage, tile, chunk, acc) and finish(tile, acc). With
// kPhases == 2 a tile's steps are two phases, chunks [0, cv.n_chunks1) and
// the rest (fused_ring.cuh: conv1, then conv2 over conv1's map in shared
// memory): acc is zeroed at the start of each, and cv.finish1(tile, acc)
// runs after the first phase's last step.
template <class Conv, class Clock>
__device__ __forceinline__ void ring_walk(Conv& cv, float* smem, int n_tiles, Clock& clk) {
  const int n_chunks = cv.n_chunks;
  const int my_tiles = static_cast<int>(blockIdx.x) < n_tiles
                           ? (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x
                           : 0;
  const int n_steps = my_tiles * n_chunks;
  int next_tile = blockIdx.x, next_chunk = 0;  // the next step to issue
  auto issue_next = [&](int stage) {
    cv.issue(smem + stage * Conv::kStage, next_tile, next_chunk);
    if (++next_chunk == n_chunks) {
      next_chunk = 0;
      next_tile += gridDim.x;
    }
  };
  constexpr int kStages = Conv::kStages;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue_next(s);
    cp_async_commit();
  }

  constexpr bool kTwo = Conv::kPhases == 2;
  int n1 = n_chunks;  // the first phase's steps
  if constexpr (kTwo) n1 = cv.n_chunks1;
  float acc[Conv::kAcc][kTN];
  int tile = blockIdx.x, chunk = 0;
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait(kStages - 2);
    // Step `it` has landed for every thread, and every warp is done with the
    // stage of step it - 1: it takes step it + kStages - 1.
    __syncthreads();
    if (it + kStages - 1 < n_steps) issue_next((it + kStages - 1) % kStages);
    cp_async_commit();
    clk.lap(kLapWait);
    const bool second = chunk >= n1;
    if (chunk == 0 || chunk == n1) {
#pragma unroll
      for (int m = 0; m < Conv::kAcc; ++m)
#pragma unroll
        for (int n = 0; n < kTN; ++n) acc[m][n] = 0.f;
    }
    cv.compute(smem + (it % kStages) * Conv::kStage, tile, chunk, acc);
    clk.lap(second ? kLapFma2 : kLapFma);
    if constexpr (kTwo) {
      if (chunk == n1 - 1) {
        cv.finish1(tile, acc);
        clk.lap(kLapEpilogue);
      }
    }
    if (++chunk == n_chunks) {
      cv.finish(tile, acc);
      chunk = 0;
      tile += gridDim.x;
      clk.lap(kLapEpilogue);
    }
  }
  cp_async_wait(0);
}

// ---------------------------------------------------------------------------
// B2: 3x3 SAME conv + bias -> "lrelu_norm" / "lrelu", over slabs of COUT
// ---------------------------------------------------------------------------

// The tile: TH x 32 output pixels (Tile<COUT>) x one slab of COUT output
// channels. A thread's pixels are row y0 + pg/4, columns x0 + 8*(pg%4) + 0..7
// (conv3x3_accumulate's row map). Patch column q holds input column x0-4+q,
// so the thread's 10 input columns sit at 8*(pg%4) + 3 .. + 12: one scalar,
// two aligned float4 and one scalar read. Rows 44 floats apart (12 mod 32):
// at Cout 32 a warp spans two rows, whose float4 reads then fall on disjoint
// banks. A stage holds 16 input channels at 32 and 64 output channels and 8
// at 16 and 8 (ring_cc in ops/packed.py), whose blocks of 128 and 64
// threads keep the 32-channel patch: 89,856 and 82,944 B, two blocks an SM.
template <int COUT, bool NORM>
struct ConvRing {
  using T = Tile<COUT>;
  static constexpr int SH = T::TH + 2;
  static constexpr int XW = T::TW + 8;
  static constexpr int SW = 44;
  static constexpr int XC = SH * SW;          // floats of one channel's patch
  static constexpr int kCC = COUT >= 32 ? 16 : 8;  // input channels a stage
  static constexpr int kStages = 3;
  static constexpr int kAcc = kTM, kPhases = 1;
  static constexpr int kX = kCC * XC;
  static constexpr int kWc = 9 * COUT;        // weights of one input channel
  static constexpr int kStage = kX + kCC * kWc;
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * kStages * kStage;
  static constexpr int kXPer = (kCC * SH * (XW / 4) + T::THREADS - 1) / T::THREADS;
  static_assert(kX % 4 == 0 && kStage % 4 == 0, "16-byte aligned stage parts");

  const float* x;
  const float* w;
  const float* bias;
  float* y;
  // cout: the output channels, stored (at NORM up to COUT on one slab; else
  // up to n_slabs x COUT, the last slab's channels past it padded)
  int C, H, W, n_slabs, cout, tiles_x, tiles_y, n_chunks, cg, pg;
  float inv_cout;  // PixelNorm's 1 / cout
  RingCopies<kCC, kXPer, T::THREADS> copies;

  __device__ __forceinline__ ConvRing(const float* x_, const float* w_, const float* b_,
                                      float* y_, int C_, int H_, int W_, int n_slabs_,
                                      int cout_ = -1)
      : x(x_), w(w_), bias(b_), y(y_), C(C_), H(H_), W(W_), n_slabs(n_slabs_),
        cout(cout_ < 0 ? n_slabs_ * COUT : cout_), tiles_x(W_ / T::TW), tiles_y(H_ / T::TH),
        n_chunks((C_ + kCC - 1) / kCC), cg(threadIdx.x % T::NCG), pg(threadIdx.x / T::NCG),
        inv_cout(1.0f / static_cast<float>(cout)) {
    copies.template init<SH, XW, SW>();
  }

  // Tile t of the walk: the slab fastest (the tiles that share one patch run
  // together), then columns, rows and images (ops/packed.py conv_tile_origin).
  __device__ __forceinline__ void tile_of(int t, int& b, int& y0, int& x0, int& slab) const {
    slab = t % n_slabs;
    t /= n_slabs;
    x0 = (t % tiles_x) * T::TW;
    t /= tiles_x;
    y0 = (t % tiles_y) * T::TH;
    b = t / tiles_y;
  }

  __device__ __forceinline__ void issue(float* stage, int t, int chunk) const {
    int b, y0, x0, slab;
    tile_of(t, b, y0, x0, slab);
    const int c0 = chunk * kCC;
    const long long corner =
        (static_cast<long long>(b) * C + c0) * H * W + static_cast<long long>(y0 - 1) * W + x0 - 4;
    copies.template issue<XW / 4>(stage, x, corner, y0 - 1, H, W, x0 > 0, x0 + T::TW < W,
                                 C - c0);
    ring_copy_weights<kCC * kWc / 4, T::THREADS>(
        stage + kX, w + (static_cast<size_t>(slab) * C + c0) * kWc, w, (C - c0) * kWc);
  }

  // Channels [c_begin, c_begin + 8) of the stage, in conv3x3_rows' order.
  __device__ __forceinline__ void channels8(const float* __restrict__ xs,
                                            const float* __restrict__ ws, int c_begin,
                                            float (&acc)[kTM][kTN]) const {
    const int pgx = pg % 4;
    const int ty = pg / 4;
#pragma unroll 2
    for (int c = c_begin; c < c_begin + 8; ++c) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        const float* src = xs + c * XC + (ty + ky) * SW + pgx * kTM + 3;
        const float4 a = *reinterpret_cast<const float4*>(src + 1);
        const float4 b = *reinterpret_cast<const float4*>(src + 5);
        const float xin[kTM + 2] = {src[0], a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, src[9]};
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wrow = ws + (c * 9 + ky * 3 + kx) * COUT;
          const float4 w0 = reinterpret_cast<const float4*>(wrow)[cg];
          const float4 w1 = reinterpret_cast<const float4*>(wrow)[T::NCG + cg];
#pragma unroll
          for (int m = 0; m < kTM; ++m) fma8(acc[m], xin[m + kx], w0, w1);
        }
      }
    }
  }

  __device__ __forceinline__ void compute(const float* stage, int, int chunk,
                                          float (&acc)[kTM][kTN]) const {
#pragma unroll
    for (int g = 0; g < kCC; g += 8)  // block-uniform: channels past C are zero
      if (g == 0 || C - chunk * kCC > g) channels8(stage, stage + kX, g, acc);
  }

  __device__ __forceinline__ void finish(int t, float (&acc)[kTM][kTN]) const {
    int b, y0, x0, slab;
    tile_of(t, b, y0, x0, slab);
    if constexpr (NORM)
      bias_lrelu_norm<COUT>(acc, bias, cg, inv_cout);
    else
      bias_act<COUT, true>(acc, bias + slab * COUT, cg);
    const size_t plane = static_cast<size_t>(H) * W;
    store_rows<COUT>(y + (static_cast<size_t>(b) * cout + slab * COUT) * plane +
                         static_cast<size_t>(y0 + pg / 4) * W + x0 + (pg % 4) * kTM,
                     acc, cg, plane, cout - slab * COUT);
  }
};

// ---------------------------------------------------------------------------
// B5: 3x3 SAME conv + bias -> "lrelu" / "none" -> 2x2 mean pool, over slabs
// of COUT
// ---------------------------------------------------------------------------

// ConvRing<COUT, false>'s tiles, walk, copies, stages and bytes (every slab
// width); what differs is the thread's pixels and the epilogue. A thread's 8
// pixels are a 2 x 4 patch, two whole pooling windows: rows y0 + py + r,
// columns x0 + px + j (acc[4 * r + j]), py = 2 * (pg / 8), px = 4 * (pg % 8).
// Its input rows are patch rows py .. py + 3, its 6 input columns patch
// columns px + 3 .. px + 8: one scalar, one aligned float4 and one scalar
// read a row. In a warp the float4 reads of one patch row are contiguous
// (4, 8, 16 or 32 pixel groups of a row side by side), and the warp's rows at
// Cout 16 and 8 (2 and 4 of them, 2 patch rows = 88 words = 24 mod 32
// apart) each take a 128-byte span: as few wavefronts as the bytes need.
// The scalar reads of those rows fall on the same 8 banks (px + 3 is 3 mod
// 4, rows 0 mod 8 words apart): 2- and 4-way at Cout 16 and 8, none at 32
// and 64. Every value takes its products in one accumulator in the order
// (input channel, ky, kx), ConvRing::channels8's and the old loop's, so B5
// keeps its bits, and B2 "lrelu" pooled in the order below equals B5
// "lrelu". The epilogue: bias_act, then 0.5 * (0.5 * (a00 + a10) + 0.5 *
// (a01 + a11)) in registers, one float2 (the thread's two windows) a
// channel, for the channels below the true Cout (a last slab padded past a
// Cout that is no multiple of 8 stores only those).
template <int COUT, bool ACT>
struct ConvPoolRing : ConvRing<COUT, false> {
  using Base = ConvRing<COUT, false>;
  using Base::Base;

  __device__ __forceinline__ void pool8(const float* __restrict__ xs,
                                        const float* __restrict__ ws, int c_begin,
                                        float (&acc)[kTM][kTN]) const {
    constexpr int NCG = Tile<COUT>::NCG, XC = Base::XC, SW = Base::SW;
    const int px = (this->pg % 8) * 4;
    const int py = (this->pg / 8) * 2;
    const int cg = this->cg;
#pragma unroll 2
    for (int c = c_begin; c < c_begin + 8; ++c) {
      float xin[4][6];  // input rows py-1 .. py+2 of the tile, columns px-1 .. px+4
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* src = xs + c * XC + (py + r) * SW + px + 3;
        const float4 a = *reinterpret_cast<const float4*>(src + 1);
        xin[r][0] = src[0], xin[r][1] = a.x, xin[r][2] = a.y, xin[r][3] = a.z;
        xin[r][4] = a.w, xin[r][5] = src[5];
      }
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float* wrow = ws + (c * 9 + ky * 3 + kx) * COUT;
          const float4 w0 = reinterpret_cast<const float4*>(wrow)[cg];
          const float4 w1 = reinterpret_cast<const float4*>(wrow)[NCG + cg];
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j) fma8(acc[4 * r + j], xin[r + ky][j + kx], w0, w1);
        }
      }
    }
  }

  __device__ __forceinline__ void compute(const float* stage, int, int chunk,
                                          float (&acc)[kTM][kTN]) const {
#pragma unroll
    for (int g = 0; g < Base::kCC; g += 8)  // block-uniform: channels past C are zero
      if (g == 0 || this->C - chunk * Base::kCC > g) pool8(stage, stage + Base::kX, g, acc);
  }

  __device__ __forceinline__ void finish(int t, float (&acc)[kTM][kTN]) const {
    int b, y0, x0, slab;
    this->tile_of(t, b, y0, x0, slab);
    bias_act<COUT, ACT>(acc, this->bias + slab * COUT, this->cg);
    // pooled pixel (y0/2 + pg/8, x0/2 + 2*(pg%8) + j), j = 0, 1
    const int pg = this->pg, Hp = this->H / 2, Wp = this->W / 2;
    const size_t plane = static_cast<size_t>(Hp) * Wp;
    float* out = this->y + (static_cast<size_t>(b) * this->cout + slab * COUT) * plane +
                 static_cast<size_t>(y0 / 2 + pg / 8) * Wp + x0 / 2 + 2 * (pg % 8);
    const int c_left = this->cout - slab * COUT;  // the slab's channels to store
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      if (channel_of<COUT>(this->cg, n) >= c_left) continue;
      float2 v;
      v.x = 0.5f * (0.5f * (acc[0][n] + acc[4][n]) + 0.5f * (acc[1][n] + acc[5][n]));
      v.y = 0.5f * (0.5f * (acc[2][n] + acc[6][n]) + 0.5f * (acc[3][n] + acc[7][n]));
      *reinterpret_cast<float2*>(out + static_cast<size_t>(channel_of<COUT>(this->cg, n)) *
                                           plane) = v;
    }
  }
};

// ---------------------------------------------------------------------------
// B3: B2 "lrelu_norm" -> toRGB -> blend with the upsampled previous RGB
// (-> uint8), NHWC
// ---------------------------------------------------------------------------

// ConvRing<COUT, true>'s tiles, copies and FMAs (one slab of all Cout);
// only the epilogue differs: bias_lrelu_norm, then conv_tile.cuh's
// rgb_blend_store, which reduces the toRGB dot across the lanes of a pixel
// group by shuffles and writes 3 values a pixel. `prev` [B][3][H/2][W/2] is
// read through the read-only cache, one value a pixel and channel.
template <int COUT, bool U8>
struct ConvRgbRing : ConvRing<COUT, true> {
  using Base = ConvRing<COUT, true>;
  const float* rgb_w;
  const float* rgb_b;
  const float* prev;
  float alpha;
  void* out;

  __device__ __forceinline__ ConvRgbRing(const float* x_, const float* w_, const float* b_,
                                         const float* rgb_w_, const float* rgb_b_,
                                         const float* prev_, float alpha_, void* out_, int C_,
                                         int H_, int W_, int cout_)
      : Base(x_, w_, b_, nullptr, C_, H_, W_, 1, cout_), rgb_w(rgb_w_), rgb_b(rgb_b_),
        prev(prev_), alpha(alpha_), out(out_) {}

  __device__ __forceinline__ void finish(int t, float (&acc)[kTM][kTN]) const {
    int b, y0, x0, slab;
    this->tile_of(t, b, y0, x0, slab);
    bias_lrelu_norm<COUT>(acc, this->bias, this->cg, this->inv_cout);
    const int H = this->H, W = this->W, Hp = H / 2, Wp = W / 2;
    const float* pv = prev + static_cast<size_t>(b) * 3 * Hp * Wp;
    rgb_blend_store<COUT, U8>(acc, rgb_w, rgb_b, alpha, out, this->cg, b, y0 + this->pg / 4,
                              x0 + (this->pg % 4) * kTM, H, W, [&](int k, int gy, int gx) {
                                return __ldg(pv + (static_cast<size_t>(k) * Hp + gy / 2) * Wp +
                                             gx / 2);
                              });
  }
};

// ---------------------------------------------------------------------------
// B1: nearest-2x upsample -> 3x3 SAME conv + bias -> "lrelu_norm" / "lrelu",
// from the pre-summed parity taps, optionally with the toRGB of the input
// ---------------------------------------------------------------------------

// The tile: output rows of ONE parity py under TH input rows, 16 input
// columns (32 output columns), all COUT channels. A thread's pixels: input
// row i0 + pg/4, input columns j0 + 4*(pg%4) + 0..3, both column parities:
// output columns 2*j0 + 8*(pg%4) + 0..7 (acc[2q + px]). Staged rows i0+py-1
// .. i0+py+TH-1; patch column q holds input column j0-4+q, so the thread's 6
// input columns sit at 4*(pg%4) + 3 .. + 8: one scalar, one aligned float4
// and one scalar read. Rows 24 floats apart at Cout 64, 48 at Cout 32 and
// below (16 mod 32: the warp's two rows on disjoint banks). At Cout 16 and 8
// a stage holds 8 input channels (90,624 and 84,480 B, two blocks an SM), and
// a thread of their 128- and 64-thread blocks takes the toRGB of 2 and 4
// input pixels.
//
// A 128-bit weight read from shared memory feeds 32 FMAs here (B2: 64), and
// such a read keeps the shared-memory pipe 4 cycles a warp: per channel and
// input row a warp's 8 weight and 3 input reads take ~38 cycles of that pipe
// against 32 of FMA issue, which is why B1 stays further from its bound
// than B2. Two input rows a thread (64 FMAs a weight read) needed more than
// 255 registers, spilled, and ran slower at Cout 32 (PERF.md).
template <int COUT, bool NORM>
struct UpconvRing {
  using T = Tile<COUT>;
  static constexpr int TH = T::TH;        // input rows a tile
  static constexpr int TJ = T::TW / 2;    // input columns a tile: 16
  static constexpr int SH = TH + 1;
  static constexpr int XW = TJ + 8;
  static constexpr int SW = COUT == 64 ? 24 : 48;
  static constexpr int XC = SH * SW;
  static constexpr int kCC = COUT >= 32 ? 16 : 8;  // input channels a stage
  static constexpr int kStages = 3;
  static constexpr int kAcc = kTM, kPhases = 1;
  static constexpr int kX = kCC * XC;
  static constexpr int kWc = 8 * COUT;    // one parity's pre-summed taps of a channel
  static constexpr int kStage = kX + kCC * kWc;
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * kStages * kStage;
  static constexpr int kXPer = (kCC * SH * (XW / 4) + T::THREADS - 1) / T::THREADS;
  // input pixels of a tile's toRGB a thread takes: 1, or all of them in
  // turn at 16 and 8 channels (2 and 4)
  static constexpr int kRgbPer = (TH * TJ + T::THREADS - 1) / T::THREADS;
  static_assert(kRgbPer == 1 || kRgbPer * T::THREADS == TH * TJ, "whole toRGB pixels a thread");
  static_assert(kX % 4 == 0 && kStage % 4 == 0, "16-byte aligned stage parts");

  const float* x;
  const float* wk;
  const float* bias;
  const float* rgb_w;
  const float* rgb_b;
  float* y;
  float* rgb;
  int C, H, W, cout, tiles_x, tiles_y, n_chunks, cg, pg;  // cout: up to COUT
  float inv_cout;  // PixelNorm's 1 / cout
  float racc[kRgbPer][3];
  RingCopies<kCC, kXPer, T::THREADS> copies;

  __device__ __forceinline__ UpconvRing(const float* x_, const float* wk_, const float* b_,
                                        const float* rgb_w_, const float* rgb_b_, float* y_,
                                        float* rgb_, int C_, int H_, int W_, int cout_)
      : x(x_), wk(wk_), bias(b_), rgb_w(rgb_w_), rgb_b(rgb_b_), y(y_), rgb(rgb_), C(C_), H(H_),
        W(W_), cout(cout_), tiles_x(W_ / TJ), tiles_y(H_ / TH), n_chunks((C_ + kCC - 1) / kCC),
        cg(threadIdx.x % T::NCG), pg(threadIdx.x / T::NCG),
        inv_cout(1.0f / static_cast<float>(cout_)) {
    copies.template init<SH, XW, SW>();
  }

  // Tile t of the walk: the parity fastest (both parities read one patch),
  // then columns, rows and images (ops/packed.py upconv_tile_origin).
  __device__ __forceinline__ void tile_of(int t, int& b, int& i0, int& j0, int& py) const {
    py = t & 1;
    t >>= 1;
    j0 = (t % tiles_x) * TJ;
    t /= tiles_x;
    i0 = (t % tiles_y) * TH;
    b = t / tiles_y;
  }

  // toRGB of the input: the py = 0 tiles own input rows i0..i0+TH-1 (staged
  // rows 1..TH), one input pixel per thread (threads past TH * TJ none), or
  // kRgbPer: pixel p = threadIdx.x + q * THREADS, row p / TJ, column p % TJ.
  __device__ __forceinline__ bool rgb_lane(int py) const {
    return rgb_w != nullptr && py == 0 && static_cast<int>(threadIdx.x) < TH * TJ;
  }

  __device__ __forceinline__ void issue(float* stage, int t, int chunk) const {
    int b, i0, j0, py;
    tile_of(t, b, i0, j0, py);
    const int c0 = chunk * kCC;
    const int row = i0 + py - 1;
    const long long corner =
        (static_cast<long long>(b) * C + c0) * H * W + static_cast<long long>(row) * W + j0 - 4;
    copies.template issue<XW / 4>(stage, x, corner, row, H, W, j0 > 0, j0 + TJ < W, C - c0);
    ring_copy_weights<kCC * kWc / 4, T::THREADS>(
        stage + kX, wk + (static_cast<size_t>(py) * C + c0) * kWc, wk, (C - c0) * kWc);
  }

  // Channels [c_begin, c_begin + 8) of the stage, in packed_upconv's order:
  // per channel the toRGB product (channels below C: rgb_w is [3][C]), then
  // (dy, px, dx, q).
  __device__ __forceinline__ void channels8(const float* __restrict__ xs,
                                            const float* __restrict__ ws, int c_begin, int c0,
                                            bool with_rgb, float (&acc)[kTM][kTN]) {
    const int pgx = pg % 4;
    const int r = pg / 4;
#pragma unroll 2
    for (int c = c_begin; c < c_begin + 8; ++c) {
      if (with_rgb && c0 + c < C) {
#pragma unroll
        for (int q = 0; q < kRgbPer; ++q) {
          const int p = threadIdx.x + q * T::THREADS;
          const float v = xs[c * XC + (p / TJ + 1) * SW + p % TJ + 4];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            racc[q][k] = fmaf(v, __ldg(rgb_w + k * C + c0 + c), racc[q][k]);
        }
      }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float* src = xs + c * XC + (r + dy) * SW + 4 * pgx + 3;
        const float4 a = *reinterpret_cast<const float4*>(src + 1);
        const float xin[6] = {src[0], a.x, a.y, a.z, a.w, src[5]};
#pragma unroll
        for (int px = 0; px < 2; ++px) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float* wrow = ws + (((c * 2 + px) * 2 + dy) * 2 + dx) * COUT;
            const float4 w0 = reinterpret_cast<const float4*>(wrow)[cg];
            const float4 w1 = reinterpret_cast<const float4*>(wrow)[T::NCG + cg];
            // input column j0 + 4*pgx + q feeds output column 2*(4*pgx + q) + px
#pragma unroll
            for (int q = 0; q < 4; ++q) fma8(acc[2 * q + px], xin[q + px + dx], w0, w1);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void compute(const float* stage, int t, int chunk,
                                          float (&acc)[kTM][kTN]) {
    if (chunk == 0) {
#pragma unroll
      for (int q = 0; q < kRgbPer; ++q) racc[q][0] = racc[q][1] = racc[q][2] = 0.f;
    }
    const bool with_rgb = rgb_lane(t & 1);
    const int c0 = chunk * kCC;
#pragma unroll
    for (int g = 0; g < kCC; g += 8)  // block-uniform: channels past C are zero
      if (g == 0 || C - c0 > g) channels8(stage, stage + kX, g, c0, with_rgb, acc);
  }

  __device__ __forceinline__ void finish(int t, float (&acc)[kTM][kTN]) {
    int b, i0, j0, py;
    tile_of(t, b, i0, j0, py);
    if (rgb_lane(py)) {
#pragma unroll
      for (int q = 0; q < kRgbPer; ++q) {
        const int p = threadIdx.x + q * T::THREADS;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          rgb[((static_cast<size_t>(b) * 3 + k) * H + i0 + p / TJ) * W + j0 + p % TJ] =
              racc[q][k] + __ldg(rgb_b + k);
      }
    }
    if constexpr (NORM)
      bias_lrelu_norm<COUT>(acc, bias, cg, inv_cout);
    else
      bias_act<COUT, true>(acc, bias, cg);
    const int Wo = 2 * W;
    const size_t plane = static_cast<size_t>(2 * H) * Wo;
    store_rows<COUT>(y + static_cast<size_t>(b) * cout * plane +
                         static_cast<size_t>(2 * (i0 + pg / 4) + py) * Wo + 2 * j0 + (pg % 4) * kTM,
                     acc, cg, plane, cout);
  }
};

}  // namespace probgan
