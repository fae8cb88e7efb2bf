// One whole generator stage in one kernel: nearest-2x upsample -> conv1 3x3 +
// bias -> LeakyReLU(0.2) -> PixelNorm -> conv2 3x3 + bias -> LeakyReLU ->
// PixelNorm, and for the final stage toRGB and the blend with the previous
// stage's RGB (conv_tile.cuh rgb_blend_store). Shared by packed_upconv_conv.cu
// (a non-final stage, features out) and packed_upconv_conv_rgb.cu (the final
// stage, RGB out). conv1's feature map never reaches device memory.
//
// Bit-equal to the two-kernel path (packed_upconv.cu, then packed_conv.cu or
// packed_conv_rgb.cu): every value takes its products in the same order
// (conv1: input channel, then dy, then dx of its parity's pre-summed taps;
// conv2: channel, ky, kx), both epilogues reduce PixelNorm's sum over the
// same lane -> channel map (Tile<COUT>, channel_of, group_sum), and the
// previous stage's RGB sums its input channels in ascending order, then adds
// prev_b. Only the thread layout differs.
//
// Bound on the H100: operations (fp32 on the CUDA cores, ~380 FLOP a byte at
// stage 7). What held the synchronous kernel this replaces at 33-39% of that
// bound, 1.37-1.45x slower than the pair (PERF.md): it staged 4 input
// channels a step with scalar, bounds-checked loads between two barriers,
// nothing in flight during the FMAs; each block recomputed conv1 on the
// (TH+2)-row halo of its tile (+33% of conv1's pixels at 64 channels, +20%
// at 32); and a grid of blocks started cold, one tile each.
//
// The design:
//  * Persistent blocks (one an SM at 32 and 64 channels) walk conv2 tiles
//    of TH x 32 outputs, all COUT channels (Tile<COUT>: TH = 8 at 64
//    channels, 16 at 32, 16 and 8; blocks of 256 threads at 32 and 64, of
//    128 and 64 at 16 and 8, two and three blocks an SM), through
//    conv_ring.cuh's ring_walk in two phases a tile: conv1 into "mid"
//    ((TH+2) x 34 conv1 pixels, all channels, conv3x3's patch layout), then
//    conv2 over mid.
//  * A block's tiles are a contiguous range of the walk's order: images,
//    then 32-column strips, then tile rows down the strip. ops/packed.py
//    fused_split decides the ranges (per_block tiles, one more for the
//    first `extra` blocks); the C entries check them against the shape and
//    the blocks, and tile_of walks them (fused_tile_origin, its Python
//    mirror). A run is the part of a range inside one strip of
//    one image. Only a run's first tile computes conv1 on all TH+2 rows;
//    each later tile moves mid rows TH, TH+1 (conv1 rows y0+TH-1, y0+TH,
//    the rows it shares with the tile below) to rows 0, 1 and computes TH
//    new rows. conv1 pixels per conv2 output: 34/32 x (1 + 2/(TH x run)),
//    1.07-1.08 on the path's shapes (ops/packed.py fused_conv1_per_output;
//    conv_clock_split.cu's FusedTally counts what the walk stores).
//  * Rows of mid outside the image hold zero, not conv1's epilogue of zero:
//    conv2's SAME padding.
//  * Both phases stream through one ring of cp.async stages (one barrier a
//    stage): phase 1 stages kC1 = 8 input channels of the input rows under
//    the tile (y0/2-1 .. y0/2+TH/2, 24 columns in whole 16-byte chunks,
//    zero-filled outside the image, RingCopies) and both row parities'
//    pre-summed taps; phase 2 stages kC2 = 16 channels of conv2's weights
//    (8 at Cout 8; its input, mid, is already in shared memory). The ring issues steps
//    kStages - 1 ahead whatever their phase, so the next tile's first
//    phase-1 copies are in flight while this tile's conv2 and epilogue run.
//
// Phase 1's work split. conv1 pixel (y0-1+r, x0-1+q) of mid is parity class
// (py, px) = ((r+1)%2, (q+1)%2), class row a = r/2 (r = 2a + 1 - py) and
// class column bq = q/2 (q = 2bq + 1 - px); it reads the staged input at
// patch row a + dy, column bq + 3 + dx for every class. Two warps hold one
// class (its taps are read once a warp and broadcast), G = TH pixel groups
// (Tile<COUT>'s NCG lanes a group, 8 channels a lane, so that PixelNorm
// reduces as the pair's). A group owns a half row of its class: row
// a = 1 + g % (TH/2), columns 0..8 in one warp, 9..16 in the other: 9 or 8
// pixels, warp-uniform, no slot wasted; warps w and w + 4, which share a
// scheduler, hold one half row of each length. A lane reads one staged row
// segment a dy (a scalar, two aligned float4 and a scalar) for both dx,
// 16 shared-memory reads a channel for 288 FMAs; the segments of a warp's
// groups lie in rows SW = 28 floats apart, on distinct banks. A run's first
// tile adds class row 0, 17 pixels, spread over the groups (the 8-pixel half
// rows first): both warps then hold PMAX = 11 (64 channels) or 10 (32)
// pixels, which fit the 255 registers of one block an SM without spills.
//
// At 16 and 8 channels (a narrow generator's stages, e.g. fmap_base 2048 at
// 1024²) the block keeps the 32-channel tile, 64 pixel groups, on NCG = 2 or
// 1 lanes a group: a class's 16 groups are 32 or 16 lanes, one warp or half
// of one. So that a warp's groups still hold half rows of one length, warp
// w takes half w % 2 of the class rows of 2 (NCG 2) or all 4 (NCG 1)
// classes; a quarter warp, which a 128-bit shared-memory read serves at
// once, stays inside one class (one tap row, broadcast) and reads its input
// segments from 8 distinct rows (SW = 28 apart: distinct banks). A value's
// products keep their order (input channel, dy, dx), and PixelNorm reduces
// over the NCG lanes of a group (group_sum) as in B1 at these widths. The
// previous RGB's 128 input pixels take 1 or 2 a thread.
//
// Tried on the card and not kept (utils/bench_kernels.py; PERF.md): one
// scalar read a pixel and tap (36 a channel) with both warps of a scheduler
// on half rows of one length, 1-4% slower at batch 8; the channel loop
// unrolled by 2, 9-10% slower at 64 channels; 5 stages at 32 channels
// instead of 4, no faster. At 64 channels 3 stages of 8 channels is the
// only ring that fits beside mid.
//
// Shared memory a block (floats): mid COUT x (TH+2) x 36, the previous RGB
// 3 x TH/2 x 16 (B11), and kStages stages of max(phase 1: 8 x (TH/2+2) x 28
// input + 2 x 8 x 8 x COUT taps, phase 2: kC2 x 9 x COUT):
//   Cout 64, 3 stages: 23,040 + 192 + 3 x 9,536 = 51,840 floats, 207,360 B
//   Cout 32, 4 stages: 20,736 + 384 + 4 x 6,336 = 46,464 floats, 185,856 B
//   Cout 16, 4 stages: 10,368 + 384 + 4 x 4,288 = 27,904 floats, 111,616 B
//   Cout 8,  4 stages:  5,184 + 384 + 4 x 3,264 = 18,624 floats,  74,496 B
// (B10 the same less the previous RGB: 206,592 / 184,320 / 110,080 /
// 72,960 B), under the 232,448 B a block may have; one block an SM at 64
// and 32 channels, two at 16 and three at 8 (ops/packed.py fused_ring_bytes,
// fused_split). 16 channels a phase-1 step at 64 channels would leave room
// for one stage only.
#pragma once

#include "conv_ring.cuh"

namespace probgan {

enum StageTail { kFeatures = 0, kRgbF32 = 1, kRgbU8 = 2 };

// What a walk reports of itself: nothing in the kernels; the clock-split
// probe (conv_clock_split.cu FusedTally) records each tile's origin and
// counts the conv1 pixels stored into mid.
struct NoTally {
  __device__ __forceinline__ void tile(int, int, int, int, bool) {}
  __device__ __forceinline__ void pixel() {}
};

template <int COUT, int TAIL, class Tally = NoTally>
struct FusedRing {
  using T = Tile<COUT>;
  static constexpr bool RGB = TAIL != kFeatures;
  static constexpr int TH = T::TH, TW = T::TW;  // conv2 tile: TH x 32
  static constexpr int NCG = T::NCG;
  static constexpr int THREADS = T::THREADS;    // 256, or 128 and 64 at 16 and 8
  static constexpr int MH = Patch<COUT>::SH;    // mid rows: conv1 rows y0-1 .. y0+TH
  static constexpr int MW = Patch<COUT>::SW;    // mid row stride, column 0 = x0-1
  static constexpr int MID = COUT * MH * MW;
  static constexpr int R = TH / 2;              // class rows a carried tile computes
  static constexpr int CC = TW / 2 + 1;         // class columns: 17
  static constexpr int G = T::NPG / 4;          // pixel groups a class (= TH)
  static constexpr int NMAIN = (CC + 1) / 2;    // the longer half row: 9
  static constexpr int E0 = CC / G;             // row-0 pixels of a first tile, a group
  static constexpr int E1 = (CC + G - 1) / G;   // ... of the groups that take one more
  static constexpr int PMAX = NMAIN + E0;       // pixels a lane holds: 11 or 10
  static_assert(G == 2 * R && (CC - NMAIN) + E1 == PMAX, "both warps of a class hold PMAX");
  static constexpr int kC1 = 8;                 // input channels a phase-1 step
  static constexpr int kC2 = COUT < 16 ? COUT : 16;  // conv2 input channels a phase-2 step
  static constexpr int IH = R + 2;              // staged input rows: y0/2-1 .. y0/2+R
  static constexpr int XW = TW / 2 + 8;         // staged columns j0-4 .. j0+19
  static constexpr int SW = 28;                 // their row stride
  static constexpr int XC = IH * SW;
  static constexpr int kX = kC1 * XC;
  static constexpr int kW1 = kC1 * 8 * COUT;    // one row parity's taps of kC1 channels
  static constexpr int kW2 = kC2 * 9 * COUT;
  static constexpr int kStage = kX + 2 * kW1 > kW2 ? kX + 2 * kW1 : kW2;
  static constexpr int kStages = COUT == 64 ? 3 : 4;
  static constexpr int PREV = RGB ? 3 * R * (TW / 2) : 0;
  static constexpr int kBytes = static_cast<int>(sizeof(float)) * (kStages * kStage + MID + PREV);
  static constexpr int kAcc = PMAX, kPhases = 2;
  static constexpr int kXPer = (kC1 * IH * (XW / 4) + THREADS - 1) / THREADS;
  // input pixels of the tile's previous RGB a thread takes: 1, or 2 at 8 channels
  static constexpr int kPrevPer = (R * (TW / 2) + THREADS - 1) / THREADS;
  static_assert(kX % 4 == 0 && kStage % 4 == 0 && MID % 4 == 0, "16-byte aligned parts");
  static_assert(kPrevPer == 1 || kPrevPer * THREADS == R * (TW / 2),
                "whole previous-RGB pixels a thread");

  const float* x;
  const float* wk1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* rgb_w;
  const float* rgb_b;
  const float* prev_w;
  const float* prev_b;
  float alpha;
  void* y;
  float* mid;
  float* prev_s;
  int C, H, W, tiles_y, tiles_x, per_block, extra_blocks, n_chunks, n_chunks1, cg, pg;
  int py, px, n_main, n_row0;  // the lane's class, its half row's and row 0's pixels
  int seg;        // the staged input under its half row: patch row a, column bq0 + 3
  int row0[E1];   // and under its row-0 pixels: column bq + 3 of patch row 0
  bool prev_lane;
  float racc[kPrevPer][3];
  RingCopies<kC1, kXPer, THREADS> copies;
  Tally& tally;

  // x [B][C][H][W]; wk1 [2 py][C][2 px][2 dy][2 dx][COUT] (packed_upconv.cu's
  // pre-summed taps), b1 [COUT]; w2 [COUT][3][3][COUT] (packed_conv.cu's
  // layout), b2 [COUT]; kRgb*: rgb_w [3][COUT], rgb_b [3], prev_w [3][C],
  // prev_b [3]. `smem` is past the ring's stages.
  __device__ __forceinline__ FusedRing(const float* x_, const float* wk1_, const float* b1_,
                                       const float* w2_, const float* b2_, const float* rgb_w_,
                                       const float* rgb_b_, const float* prev_w_,
                                       const float* prev_b_, float alpha_, void* y_, float* smem,
                                       int C_, int H_, int W_, int per_block_, int extra_,
                                       Tally& tally_)
      : x(x_), wk1(wk1_), b1(b1_), w2(w2_), b2(b2_), rgb_w(rgb_w_), rgb_b(rgb_b_),
        prev_w(prev_w_), prev_b(prev_b_), alpha(alpha_), y(y_), mid(smem), prev_s(smem + MID),
        C(C_), H(H_), W(W_), tiles_y(2 * H_ / TH), tiles_x(2 * W_ / TW),
        per_block(per_block_), extra_blocks(extra_), n_chunks(C_ / kC1 + COUT / kC2),
        n_chunks1(C_ / kC1), cg(threadIdx.x % NCG), pg(threadIdx.x / NCG), tally(tally_) {
    copies.template init<IH, XW, SW>();
    int cls, g;
    if constexpr (NCG >= 4) {
      // Warps w and w + 4 share a scheduler: the upper four take the other
      // half rows of their classes, so that each scheduler issues 9 + 8 pixels.
      cls = pg / G;
      g = (pg % G) ^ (cls >= 2 ? R : 0);
    } else {
      // A warp's 32 / NCG groups: half w % 2 of the class rows of 32 / NCG / R
      // classes, R groups (class rows 1 .. R) a class.
      constexpr int kGroupsPerWarp = 32 / NCG;
      const int w = pg / kGroupsPerWarp, within = pg % kGroupsPerWarp;
      cls = (w >> 1) * (kGroupsPerWarp / R) + within / R;
      g = (w & 1) * R + within % R;
    }
    py = cls >> 1;
    px = cls & 1;
    const int half = g / R;
    n_main = half ? CC - NMAIN : NMAIN;
    const int a = 1 + g % R, bq0 = half ? NMAIN : 0;
    // Row 0 (a run's first tile): columns gx, gx + G, ... with the shorter
    // half rows' groups first; a slot past the row's end repeats its last
    // column and is not stored.
    const int gx = (g + R) % G;
    n_row0 = (CC - gx + G - 1) / G;
    seg = a * SW + bq0 + 3;
#pragma unroll
    for (int e = 0; e < E1; ++e) row0[e] = min(gx + G * e, CC - 1) + 3;
    prev_lane = RGB && static_cast<int>(threadIdx.x) < R * (TW / 2);  // all at 16 and 8
  }

  // Tile t of ring_walk (blockIdx.x + k * gridDim.x) is the block's k-th
  // tile; the blocks' ranges split the walk's order (images, strips, rows)
  // into per_block tiles each, one more for the first extra_blocks blocks
  // (ops/packed.py fused_split, fused_tile_origin). `first`: the tile starts
  // a run (the block's first tile, or the top of a strip).
  __device__ __forceinline__ void tile_of(int t, int& b, int& y0, int& x0, bool& first) const {
    const int blk = t % static_cast<int>(gridDim.x), k = t / static_cast<int>(gridDim.x);
    int g = blk * per_block + min(blk, extra_blocks) + k;
    const int row = g % tiles_y;
    g /= tiles_y;
    x0 = (g % tiles_x) * TW;
    b = g / tiles_x;
    y0 = row * TH;
    first = k == 0 || row == 0;
  }

  __device__ __forceinline__ void issue(float* stage, int t, int chunk) const {
    if (chunk >= n_chunks1) {  // phase 2: conv2's taps
      const int c0 = (chunk - n_chunks1) * kC2;
      ring_copy_weights<kW2 / 4, THREADS>(stage, w2 + static_cast<size_t>(c0) * 9 * COUT, w2,
                                          kW2);
      return;
    }
    int b, y0, x0;
    bool first;
    tile_of(t, b, y0, x0, first);
    const int c0 = chunk * kC1;
    const int row = y0 / 2 - 1, j0 = x0 / 2;
    const long long corner =
        (static_cast<long long>(b) * C + c0) * H * W + static_cast<long long>(row) * W + j0 - 4;
    copies.template issue<XW / 4>(stage, x, corner, row, H, W, j0 > 0, j0 + TW / 2 < W, C - c0);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      ring_copy_weights<kW1 / 4, THREADS>(
          stage + kX + p * kW1, wk1 + (static_cast<size_t>(p) * C + c0) * 8 * COUT, wk1, kW1);
  }

  // conv1's FMAs of one staged step, in packed_upconv's order: per channel
  // the previous RGB's product, then (dy, dx). The NM pixels of the lane's
  // half row read one staged row segment a dy, NM + 1 values from column
  // bq0 + 3 (bq0 = 0: a scalar, two aligned float4 and a scalar; bq0 = 9: two
  // float4 and a scalar), used for both dx; its NE row-0 pixels (a run's
  // first tile) read theirs one by one.
  template <int NM, int NE>
  __device__ __forceinline__ void conv1_step(const float* __restrict__ xs,
                                             const float* __restrict__ ws, int c0,
                                             float (&acc)[PMAX][kTN]) {
    static_assert((NM == NMAIN || NM == CC - NMAIN) && NM + NE <= PMAX, "a half row");
#pragma unroll 1
    for (int c = 0; c < kC1; ++c) {
      const float* xc = xs + c * XC;
      if (prev_lane) {
#pragma unroll
        for (int q = 0; q < kPrevPer; ++q) {
          const int p = threadIdx.x + q * THREADS;
          const float v = xc[(p / (TW / 2) + 1) * SW + p % (TW / 2) + 4];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            racc[q][k] = fmaf(v, __ldg(prev_w + k * C + c0 + c), racc[q][k]);
        }
      }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float* src = xc + seg + dy * SW;
        float xin[NM + 1];
        if constexpr (NM == NMAIN) {  // columns 3 .. 12
          const float4 u = *reinterpret_cast<const float4*>(src + 1);
          const float4 v = *reinterpret_cast<const float4*>(src + 5);
          const float t[NM + 1] = {src[0], u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, src[9]};
#pragma unroll
          for (int i = 0; i <= NM; ++i) xin[i] = t[i];
        } else {  // columns 12 .. 20
          const float4 u = *reinterpret_cast<const float4*>(src);
          const float4 v = *reinterpret_cast<const float4*>(src + 4);
          const float t[NM + 1] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w, src[8]};
#pragma unroll
          for (int i = 0; i <= NM; ++i) xin[i] = t[i];
        }
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const float* wrow = ws + ((((py * kC1 + c) * 2 + px) * 2 + dy) * 2 + dx) * COUT;
          const float4 w0 = reinterpret_cast<const float4*>(wrow)[cg];
          const float4 w1 = reinterpret_cast<const float4*>(wrow)[NCG + cg];
#pragma unroll
          for (int m = 0; m < NM; ++m) fma8(acc[m], xin[m + dx], w0, w1);
#pragma unroll
          for (int e = 0; e < NE; ++e)
            fma8(acc[NM + e], xc[row0[e] + dy * SW + dx], w0, w1);
        }
      }
    }
  }

  __device__ __forceinline__ void compute(const float* stage, int t, int chunk,
                                          float (&acc)[PMAX][kTN]) {
    if (chunk >= n_chunks1) {  // phase 2: conv2 over mid, 8 channels a call
      const int c0 = (chunk - n_chunks1) * kC2;
#pragma unroll
      for (int g = 0; g < kC2; g += 8)
        conv3x3_rows<COUT>(reinterpret_cast<const float(*)[MH][MW]>(mid + (c0 + g) * MH * MW),
                           reinterpret_cast<const float(*)[9][COUT]>(stage + g * 9 * COUT), cg,
                           pg, acc);
      return;
    }
    int b, y0, x0;
    bool first;
    tile_of(t, b, y0, x0, first);
    if (chunk == 0) {
#pragma unroll
      for (int q = 0; q < kPrevPer; ++q) racc[q][0] = racc[q][1] = racc[q][2] = 0.f;
    }
    const float* ws = stage + kX;
    const int c0 = chunk * kC1;
    if (n_main == NMAIN) {  // warp-uniform pixel counts
      if (first)
        conv1_step<NMAIN, E0>(stage, ws, c0, acc);
      else
        conv1_step<NMAIN, 0>(stage, ws, c0, acc);
    } else {
      if (first)
        conv1_step<CC - NMAIN, E1>(stage, ws, c0, acc);
      else
        conv1_step<CC - NMAIN, 0>(stage, ws, c0, acc);
    }
  }

  // conv1's epilogue into mid, after every warp's last read of mid for the
  // previous tile's conv2 (the ring's barriers lie between).
  __device__ __forceinline__ void finish1(int t, float (&acc)[PMAX][kTN]) {
    int b, y0, x0;
    bool first;
    tile_of(t, b, y0, x0, first);
    tally.tile(t, b, y0, x0, first);
    bias_lrelu_norm<COUT, PMAX>(acc, b1, cg);
    if (!first) {  // carry conv1 rows y0-1, y0 down from the tile above
      for (int e = threadIdx.x; e < COUT * 2 * MW; e += THREADS) {
        const int q = e % MW, rc = e / MW;
        float* plane = mid + (rc / 2) * MH * MW;
        plane[(rc % 2) * MW + q] = plane[(TH + rc % 2) * MW + q];
      }
      __syncthreads();  // rows TH, TH+1 are read before they are written again
    }
    if (n_main == NMAIN)  // compile-time indices keep the arrays in registers
      store_mid<NMAIN>(acc, y0, x0, first);
    else
      store_mid<CC - NMAIN>(acc, y0, x0, first);
    if (prev_lane) {
#pragma unroll
      for (int q = 0; q < kPrevPer; ++q) {
        const int p = threadIdx.x + q * THREADS;  // row p / 16, column p % 16 of the tile's
#pragma unroll
        for (int k = 0; k < 3; ++k) prev_s[k * R * (TW / 2) + p] = racc[q][k] + __ldg(prev_b + k);
      }
    }
  }

  // The lane's conv1 pixels into mid: its NM half-row pixels, and with
  // `first` its row-0 pixels after them.
  template <int NM>
  __device__ __forceinline__ void store_mid(const float (&acc)[PMAX][kTN], int y0, int x0,
                                            bool first) {
    const int Ho = 2 * H, Wo = 2 * W;
#pragma unroll
    for (int m = 0; m < PMAX; ++m) {
      const int e = m - NM;  // a row-0 pixel when e >= 0
      if (e < 0 || (first && e < n_row0)) {
        if (cg == 0) tally.pixel();
        const int at = e < 0 ? seg + m : row0[e < 0 ? 0 : e];
        const int r = 2 * (at / SW) + 1 - py, q = 2 * (at % SW - 3) + 1 - px;
        const int oy = y0 - 1 + r, ox = x0 - 1 + q;
        const bool inside = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
#pragma unroll
        for (int k = 0; k < kTN; ++k)
          mid[(channel_of<COUT>(cg, k) * MH + r) * MW + q] = inside ? acc[m][k] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void finish(int t, float (&acc)[PMAX][kTN]) {
    int b, y0, x0;
    bool first;
    tile_of(t, b, y0, x0, first);
    bias_lrelu_norm<COUT, PMAX, kTM>(acc, b2, cg);
    const int gy = y0 + pg / 4, gx0 = x0 + (pg % 4) * kTM;
    const int Ho = 2 * H, Wo = 2 * W;
    if constexpr (RGB) {
      rgb_blend_store<COUT, TAIL == kRgbU8>(
          acc, rgb_w, rgb_b, alpha, y, cg, b, gy, gx0, Ho, Wo, [&](int k, int oy, int ox) {
            return prev_s[(k * R + (oy - y0) / 2) * (TW / 2) + (ox - x0) / 2];
          });
    } else {
      const size_t plane = static_cast<size_t>(Ho) * Wo;
      store_rows<COUT>(static_cast<float*>(y) + static_cast<size_t>(b) * COUT * plane +
                           static_cast<size_t>(gy) * Wo + gx0,
                       acc, cg, plane);
    }
  }
};

template <int COUT, int TAIL, class Clock, class Tally>
__device__ __forceinline__ void fused_walk(const float* x, const float* wk1, const float* b1,
                                           const float* w2, const float* b2,
                                           const float* rgb_w, const float* rgb_b,
                                           const float* prev_w, const float* prev_b,
                                           float alpha, void* y, int C, int H, int W,
                                           int n_tiles, int per_block, int extra, Clock& clk,
                                           Tally& tally) {
  using F = FusedRing<COUT, TAIL, Tally>;
  extern __shared__ __align__(16) float fused_smem[];
  F cv(x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha, y,
       fused_smem + F::kStages * F::kStage, C, H, W, per_block, extra, tally);
  ring_walk(cv, fused_smem, n_tiles, clk);
}

template <int COUT, int TAIL>
__global__ void __launch_bounds__(Tile<COUT>::THREADS, 1)
    fused_kernel(const float* __restrict__ x, const float* __restrict__ wk1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ rgb_w,
                 const float* __restrict__ rgb_b, const float* __restrict__ prev_w,
                 const float* __restrict__ prev_b, float alpha, void* __restrict__ y, int C,
                 int H, int W, int n_tiles, int per_block, int extra) {
  NoClock clk;
  NoTally tally;
  fused_walk<COUT, TAIL>(x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha, y, C, H, W,
                         n_tiles, per_block, extra, clk, tally);
}

// The walk's tiles over the batch, or -1 when the kernel does not take the
// shape: C % 8 == 0, output rows a multiple of TH, columns of 32.
template <int COUT>
long long fused_tiles(int B, int C, int H, int W) {
  using T = Tile<COUT>;
  if (B < 1 || C < 8 || C % 8 || H < 1 || W < 1 || (2 * H) % T::TH || (2 * W) % T::TW)
    return -1;
  const long long n = static_cast<long long>(B) * (2 * H / T::TH) * (2 * W / T::TW);
  return n > 0x7fffffff ? -1 : n;
}

// The walk's tiles when the split and the bytes a caller passes are the
// ones the kernel walks, else -1: 1 <= n_blocks <= tiles, per_block and
// extra the quotient and remainder of tiles / n_blocks, `smem` the bytes of
// FusedRing::kBytes (ops/packed.py fused_split, fused_ring_bytes).
template <int COUT, int TAIL>
long long fused_checked_tiles(int B, int C, int H, int W, int n_blocks, int per_block,
                              int extra, int smem) {
  const long long n_tiles = fused_tiles<COUT>(B, C, H, W);
  if (n_tiles < 1 || n_blocks < 1 || n_blocks > n_tiles || per_block != n_tiles / n_blocks ||
      extra != n_tiles % n_blocks || smem != FusedRing<COUT, TAIL>::kBytes)
    return -1;
  return n_tiles;
}

// Launch n_blocks persistent blocks over their ranges of per_block tiles
// (one more for the first `extra`) with `smem` bytes of dynamic shared
// memory, all checked (fused_checked_tiles). Returns the cudaError_t of the
// launch (0 = launched).
template <int COUT, int TAIL>
int launch_fused(const float* x, const float* wk1, const float* b1, const float* w2,
                 const float* b2, const float* rgb_w, const float* rgb_b, const float* prev_w,
                 const float* prev_b, float alpha, void* y, int B, int C, int H, int W,
                 int n_blocks, int per_block, int extra, int smem, cudaStream_t stream) {
  const long long n_tiles =
      fused_checked_tiles<COUT, TAIL>(B, C, H, W, n_blocks, per_block, extra, smem);
  if (n_tiles < 1) return cudaErrorInvalidValue;
  const auto kernel = fused_kernel<COUT, TAIL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks, Tile<COUT>::THREADS, smem, stream>>>(
      x, wk1, b1, w2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha, y, C, H, W,
      static_cast<int>(n_tiles), per_block, extra);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probgan
