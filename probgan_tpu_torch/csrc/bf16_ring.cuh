// The pipelined main loop of the bf16 kernel modes of packed_conv (B2,
// packed_conv_bf16.cu), packed_convpool (B5, packed_convpool_bf16.cu: B2's
// ring with the pool's m16 layout and epilogue), packed_conv_rgb (B3,
// packed_conv_rgb_bf16.cu: B2's ring at one slab of all Cout with the toRGB
// tail as its epilogue) and packed_upconv (B1, packed_upconv_bf16.cu):
// "default" (one bf16 pass) and "mid" (the 2-term split). A persistent block
// walks output tiles, and each tile's input channels stream through a ring
// of shared-memory stages, one chunk of 32 channels a stage, filled by
// cp.async while the tensor cores run an earlier stage's products.
//
// The order of sums, the rule every kernel on this ring keeps so that its
// outputs stay bit-equal from one commit to the next (and B3's features
// equal B2 "lrelu_norm"'s, B5's pool B2 "lrelu"'s pooled): the tile (BfTile:
// TH x 32 outputs of one slab; B1: TH input rows x 16 input columns of one
// output-row parity, both column parities),
// the warps' m16 (B5's kPool2x8) and n8 tiles, the wrapper's pre-rounded
// weight layouts, and the order of the mma.sync.m16n8k16 steps onto each
// accumulator: chunks of 32 input channels ascending, then taps (B1: its
// parity's 4 pre-summed taps), then the chunk's two k16 halves, then the
// terms (x_hi, then x_lo), with channel 16 * half + k of the chunk at K
// position k. A chunk is the unit whose taps run in sequence, so a stage
// holds a whole one. Each activation is rounded from the same fp32 value by
// the same instruction: x_hi = bf16(x) (cvt.rn.bf16x2.f32), x_lo = bf16(x -
// x_hi), exact differences. The epilogues are bias_lrelu_norm_frag and
// bias_act_frag on the fragments; B1's toRGB sums the chunk's rounded
// (split) channels in ascending order, B3's each lane's rounded (split)
// features over its n8 tiles, then the quad by two xor shuffles.
//
// Around that order, free to change:
//  * A stage holds the tile's halo patch of one chunk in fp32, laid out as
//    device memory holds it: [channel][row][column], copied in 16-byte
//    cp.async pieces of 4 columns (a patch row spans whole pieces, x0 - 4 ..
//    x0 + 35 for B2 and j0 - 4 .. j0 + 19 for B1, so the +-1 halo columns
//    come inside the end pieces), zero-filled outside the image and past C;
//    beside it the chunk's bf16 weights as the wrapper laid them out. The
//    rounding (at "mid" the split) happens as an A fragment is loaded: a
//    register is two 32-bit loads, neighbouring channels of one pixel, and
//    one cvt. A channel takes SR rows of XW floats plus 4, 4 or 12 words mod
//    16, so the 8 pixels x 4 channel pairs of a fragment load fall on 32
//    distinct banks.
//  * B fragments load by ldmatrix.x4 (two n8 tiles a load); B1 loads each
//    distinct A fragment of a chunk once (taps that read the same pixels
//    share it), which moves no product: an accumulator's order stays.
//  * Persistent blocks, one an SM (ops/packed.py persistent_blocks): block k
//    walks tiles k, k + blocks, ... in the fp32 ring's order (B2, B5: slab
//    fastest, B3: one slab, B1: parity fastest), and the ring runs through
//    its tiles without a break: chunk k + 1's copies are in flight while
//    chunk k's products run, and the next tile's first chunk is copied
//    during the last chunk's products and the epilogue and stores. One
//    __syncthreads a stage.
//
// Why fp32 in the ring and not a bf16 patch converted in shared memory (read
// then by ldmatrix): that needs a double-buffered bf16 plane once a term
// beside the fp32 landing ring and the weights. At B2's slab of 64 at "mid"
// the planes alone are 2 x 2 x 10 x 40 x 80 B = 128,000 B, and with two
// stages of weights (92,160 B) nothing is left of a block's 232,448 for the
// fp32 pieces; at a slab of 32 the "mid" planes are 230,400 B. Staged in
// fp32, a stage is the same at both term counts and the split costs
// registers only; the price is twice the shared-memory bytes an A fragment
// reads. Those bytes, with the B fragments that every warp reads, bound the
// products (measured: PERF.md §6), as the copies' L2 bytes bound the
// ring; the two overlap only in part in one block of 8 warps.
//
// Shared memory a block (32-bit words; rows of 40 floats for B2, B3, B5, 24
// for B1):
//   B2, B5 slab 64: x 32 ch x (10 x 40 + 4) + w 9 x 64 x 20 = 24,448 a stage
//   B2, B5 slab 32: x 32 ch x (18 x 40 + 4) + w 9 x 32 x 20 = 28,928 a stage
//   B2, B5 slab 16, 8: x 32 ch x 724 + w 9 x 16 (8) x 20 = 26,048, 24,608
//   B1 Cout 64: x 32 ch x (9 x 24 + 4) + w 8 x 64 x 20 = 17,280 a stage
//   B1 Cout 32, 16, 8: x 32 ch x (17 x 24 + 4) + w 8 x Cout x 20 = 18,304,
//   15,744, 14,464
// B2, B5 and B3 (one slab of all Cout: B2's bytes at that slab) in 2 stages:
// 195,584 / 231,424 / 208,384 / 196,864 B at 64 / 32 / 16 / 8; B1 in 3
// stages: 207,360 / 219,648 / 188,928 / 173,568 B (ops/packed.py bf16_ring_bytes,
// bf16_upconv_ring_bytes; the kernels refuse another figure). Each is under
// a block's 232,448 and too large for a second block in an SM's 233,472 (1 KB
// reserved a block), so one block of 8 warps an SM, which may take up to 255
// registers a thread. A stage of B2 at a slab of 64 is 97,792 B: a third
// stage would not fit.
//
// Any width up to 64 (B1, B2 "lrelu_norm", B3, bf16_conv.cuh):
// the ring of the tile just above Cout, its bytes and order of sums; `cout`
// bounds PixelNorm's mean and the stores, and B1's toRGB reads rgb_w in
// rows of C rounded up to 4 (the wrapper's zeros past C), so that its float4
// reads stay aligned and inside the row at any C. Any Cout at all (B2
// "lrelu" and "none", B5): the slabs of Cout rounded up to a multiple of 8,
// the last one's padded channels not stored. The order of sums above is
// each accumulator's whatever the slab or tile, so B2 "lrelu" at a slab of
// 16 gives B2 "lrelu_norm"'s pre-activations on the tile of 64 bit for bit
// (the training backward's recompute at Cout 48).
#pragma once

#include "bf16_conv.cuh"

namespace probgan {

// The copies of one chunk's halo patch into a stage: channels 0 .. kCK - 1
// of `xc` (the chunk's first channel plane of the image), rows row0 .. row0
// + SR - 1 and columns col0 .. col0 + XW - 1, into xs [channel][row][column]
// at CS words a channel, in 16-byte pieces of 4 columns. Warp w copies
// channels w, w + 8, w + 16, w + 24, lane l the pieces l, l + 32, ... of
// each (a row's pieces side by side: whole sectors); which (row, piece) a
// lane copies is worked out once (init) and serves every channel and step.
// Only the channels that the chunk's k16 halves read (16 where c_left <=
// 16) are copied; those at or past c_left, rows outside the image and
// pieces outside its columns are zero-filled (W % 4 == 0 and col0 % 4 == 0:
// a piece lies inside or outside whole).
template <int SR, int XW, int CS>
struct PatchCopies {
  static constexpr int kP = XW / 4;                // pieces a row
  static constexpr int kM = (SR * kP + 31) / 32;   // pieces a lane a channel
  static_assert(kThreads == 256 && kCK == 32, "8 warps x 4 channels");
  int rq[kM];  // row << 8 | piece, -1 past the patch

  __device__ __forceinline__ void init() {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int idx = lane + 32 * m;
      rq[m] = idx < SR * kP ? (idx / kP) << 8 | idx % kP : -1;
    }
  }

  __device__ __forceinline__ void issue(float* xs, const float* __restrict__ xc, int c_left,
                                        int H, int W, int row0, int col0) const {
    const int warp = threadIdx.x >> 5;
    const int n_groups = c_left > kCK / 2 ? 4 : 2;  // j < n_groups: the channels the mma reads
    const size_t plane = static_cast<size_t>(H) * W;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      if (rq[m] < 0) continue;
      const int r = rq[m] >> 8, q = rq[m] & 0xff;
      const int gy = row0 + r, gx = col0 + 4 * q;
      const bool inside = static_cast<unsigned>(gy) < static_cast<unsigned>(H) &&
                          static_cast<unsigned>(gx) < static_cast<unsigned>(W);
      const float* src = inside ? xc + static_cast<size_t>(gy) * W + gx : xc;
      float* dst = xs + r * XW + 4 * q;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= n_groups) break;
        const int c = warp + 8 * j;
        const bool valid = inside && c < c_left;
        cp_async16(dst + c * CS, valid ? src + c * plane : xc, valid);
      }
    }
  }
};

// B fragments of all NT n8 tiles for one (tap, k16 half) by ldmatrix: `pb`
// is the tap's [COUT][kPadK] weights at the half's first channel. Matrix i
// of an x4 load is n8 tile nt + i / 2, channels 8 * (i % 2) .. + 7 of the
// half, rows of 8 output channels: thread l gets output channel 8 * nt +
// l / 4, channels 2 * (l % 4), + 1: bf16_conv.cuh load_b's fragments.
// (volatile: not moved across the step's __syncthreads.)
template <int NT>
__device__ __forceinline__ void ldmatrix_b(unsigned (&b)[NT][2], const unsigned* pb) {
  const int lane = threadIdx.x & 31;
  const int i = lane >> 3, j = lane & 7;
  if constexpr (NT == 1) {
    const unsigned a = static_cast<unsigned>(
        __cvta_generic_to_shared(pb + j * kRowWords + 4 * (i & 1)));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(b[0][0]), "=r"(b[0][1])
                 : "r"(a));
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(
          pb + (8 * (nt + (i >> 1)) + j) * kRowWords + 4 * (i & 1)));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(b[nt][0]), "=r"(b[nt][1]), "=r"(b[nt + 1][0]), "=r"(b[nt + 1][1])
                   : "r"(a));
    }
  }
}

// One m16 tile's A fragment for one k16 half, from a stage's fp32 patch:
// `p` is pixel g's word of the half's channel 2t, pixel g + 8 lies `half`
// words on and channel c + 1 CS words on. Each register takes two
// neighbouring channels of one pixel, rounded to bf16 (x_hi) and at "mid"
// also x_lo = bf16(x - x_hi): a[term] = {pixel g ch 2t, 2t+1; pixel g + 8
// the same; pixel g ch 2t+8, 2t+9; pixel g + 8 the same}, mma_bf16's A.
template <int NTERM, int CS>
__device__ __forceinline__ void frag_a(unsigned (&a)[NTERM][4], const float* p, int half) {
  static_assert(NTERM == 1 || NTERM == 2, "one bf16 pass or the 2-term split");
  const float v[8] = {p[0],      p[CS],      p[half],          p[half + CS],
                      p[8 * CS], p[9 * CS], p[8 * CS + half], p[9 * CS + half]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[0][r] = pack_bf16(v[2 * r], v[2 * r + 1]);
    if constexpr (NTERM == 2)  // v - bf16(v) is exact in fp32
      a[1][r] = pack_bf16(v[2 * r] - __uint_as_float(a[0][r] << 16),
                          v[2 * r + 1] - __uint_as_float(a[0][r] & 0xffff0000u));
  }
}

// The x_hi products of one A fragment onto every n8 tile, then the x_lo ones.
template <int NT, int NTERM>
__device__ __forceinline__ void mma_frag(float (&acc)[NT][4], const unsigned (&a)[NTERM][4],
                                         const unsigned (&b)[NT][2]) {
#pragma unroll
  for (int term = 0; term < NTERM; ++term)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a[term], b[nt][0], b[nt][1]);
}

// The walk of a persistent block: tiles blockIdx.x, + gridDim.x, ... of
// n_tiles, each in cv.n_chunks steps of one chunk, through a ring of
// Conv::kStages stages of Conv::kStage words. Conv provides MT, NT,
// n_chunks, issue(stage, tile, chunk), compute(stage, tile, chunk, acc) and
// finish(tile, acc); acc is zeroed at each tile's first chunk.
template <class Conv>
__device__ __forceinline__ void bf16_ring_walk(Conv& cv, float* smem, int n_tiles) {
  constexpr int kStages = Conv::kStages;
  const int n_chunks = cv.n_chunks;
  const int first = blockIdx.x, stride = gridDim.x;
  const int my_tiles = first < n_tiles ? (n_tiles - first + stride - 1) / stride : 0;
  const int n_steps = my_tiles * n_chunks;
  int next_tile = first, next_chunk = 0;  // the next step to issue
  auto issue_next = [&](int stage) {
    cv.issue(smem + stage * Conv::kStage, next_tile, next_chunk);
    if (++next_chunk == n_chunks) {
      next_chunk = 0;
      next_tile += stride;
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) issue_next(s);
    cp_async_commit();
  }
  float acc[Conv::MT][Conv::NT][4];
  int tile = first, chunk = 0;
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait(kStages - 2);
    // Step `it` has landed for every thread, and every warp is done with the
    // stage of step it - 1: it takes step it + kStages - 1.
    __syncthreads();
    if (it + kStages - 1 < n_steps) issue_next((it + kStages - 1) % kStages);
    cp_async_commit();
    if (chunk == 0) {
#pragma unroll
      for (int m = 0; m < Conv::MT; ++m)
#pragma unroll
        for (int n = 0; n < Conv::NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    }
    cv.compute(smem + (it % kStages) * Conv::kStage, tile, chunk, acc);
    if (++chunk == n_chunks) {
      cv.finish(tile, acc);
      chunk = 0;
      tile += stride;
    }
  }
  cp_async_wait(0);
}

// The geometry a ring kernel was compiled with, for the C entries
// probgan_<name>_bf16_geometry: {stages, bytes a block, blocks an SM at those
// bytes}.
template <class Ring, class Kernel>
int ring_geometry(Kernel kernel, int* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, kernel, kThreads, Ring::kBytes);
  out[0] = Ring::kStages;
  out[1] = Ring::kBytes;
  return static_cast<int>(err);
}

// ---------------------------------------------------------------------------
// B2: 3x3 SAME conv + bias -> "lrelu_norm" / "lrelu" / "none", over slabs
// ---------------------------------------------------------------------------

// The tile: TH x 32 output pixels x one slab of COUT channels; warp w's m16
// tile mt is row y0 + w * RW + mt / 2, columns x0 + 16 * (mt % 2) + 0..15
// (bf16_conv.cuh kRow16). Patch row r is input row y0 - 1 + r, column q input
// column x0 - 4 + q.
template <int COUT, int NTERM, int EPI>
struct ConvBf16Ring {
  using T = BfTile<COUT>;
  static constexpr int MT = T::MT, NT = T::NT;
  static constexpr int SR = T::TH + 2;  // patch rows
  static constexpr int XW = 40;         // patch columns
  static constexpr int CS = SR * XW + 4;
  static constexpr int kX = kCK * CS;
  static constexpr int kW = 9 * COUT * kRowWords;  // one chunk's weights
  static constexpr int kStage = kX + kW;
  static constexpr int kStages = 2;
  static constexpr int kBytes = 4 * kStages * kStage;
  static_assert(CS % 16 == 4 || CS % 16 == 12, "a fragment load on 32 banks");
  static_assert(kX % 4 == 0 && kStage % 4 == 0, "16-byte aligned stage parts");

  const float* x;
  const unsigned* wk;
  const float* bias;
  float* y;
  // cout: the output channels, stored (at kLreluNorm up to COUT on one slab;
  // else up to n_slabs x COUT, the last slab's channels past it padded)
  int C, H, W, n_slabs, cout, tiles_x, tiles_y, n_chunks;
  float inv_cout;  // PixelNorm's 1 / cout
  PatchCopies<SR, XW, CS> copies;

  __device__ __forceinline__ ConvBf16Ring(const float* x_, const unsigned* wk_, const float* b_,
                                          float* y_, int C_, int H_, int W_, int n_slabs_,
                                          int cout_ = -1)
      : x(x_), wk(wk_), bias(b_), y(y_), C(C_), H(H_), W(W_), n_slabs(n_slabs_),
        cout(cout_ < 0 ? n_slabs_ * COUT : cout_), tiles_x(W_ / 32), tiles_y(H_ / T::TH),
        n_chunks(bf16_chunks(C_)), inv_cout(1.0f / static_cast<float>(cout)) {
    copies.init();
  }

  // Tile t: the slab fastest, then columns, rows and images (ops/packed.py
  // conv_tile_origin, conv_ring.cuh ConvRing::tile_of).
  __device__ __forceinline__ void tile_of(int t, int& b, int& y0, int& x0, int& slab) const {
    slab = t % n_slabs;
    t /= n_slabs;
    x0 = (t % tiles_x) * 32;
    t /= tiles_x;
    y0 = (t % tiles_y) * T::TH;
    b = t / tiles_y;
  }

  __device__ __forceinline__ void issue(float* stage, int t, int chunk) const {
    int b, y0, x0, slab;
    tile_of(t, b, y0, x0, slab);
    const int c0 = chunk * kCK;
    copies.issue(stage, x + (static_cast<size_t>(b) * C + c0) * H * W, C - c0, H, W, y0 - 1,
                 x0 - 4);
    stage_w(reinterpret_cast<unsigned*>(stage + kX),
            wk + (static_cast<size_t>(slab) * n_chunks + chunk) * kW, kW);
  }

  __device__ __forceinline__ void compute(const float* stage, int, int chunk,
                                          float (&acc)[MT][NT][4]) const {
    const unsigned* ws = reinterpret_cast<const unsigned*>(stage + kX);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int halves = C - chunk * kCK > kCK / 2 ? 2 : 1;  // block-uniform
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // channels 16 * kk .. + 15 of the chunk
        if (kk >= halves) break;
        unsigned bf[NT][2];
        ldmatrix_b<NT>(bf, ws + tap * COUT * kRowWords + 8 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // output row r, column c of the tile reads patch row r + ky, patch
          // column c + kx + 3
          const int row = warp * T::RW + mt / 2 + ky;
          const int col = 16 * (mt % 2) + kx + 3 + g;
          unsigned a[NTERM][4];
          frag_a<NTERM, CS>(a, stage + (16 * kk + 2 * t) * CS + row * XW + col, 8);
          mma_frag<NT, NTERM>(acc[mt], a, bf);
        }
      }
    }
  }

  __device__ __forceinline__ void finish(int tile, float (&acc)[MT][NT][4]) const {
    int b, y0, x0, slab;
    tile_of(tile, b, y0, x0, slab);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const size_t plane = static_cast<size_t>(H) * W;
    const float* bs = bias + slab * COUT;
    const int c_left = cout - slab * COUT;  // the slab's channels to store
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (EPI == kLreluNorm)
        bias_lrelu_norm_frag<NT>(acc[mt], bs, inv_cout);
      else
        bias_act_frag<NT, EPI>(acc[mt], bs);
      float* row = y + (static_cast<size_t>(b) * cout + slab * COUT) * plane +
                   static_cast<size_t>(y0 + warp * T::RW + mt / 2) * W + x0 + 16 * (mt % 2) + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int o = 8 * nt + 2 * tq;
        float* p = row + static_cast<size_t>(o) * plane;
        if (o < c_left) {
          p[0] = acc[mt][nt][0];
          p[8] = acc[mt][nt][2];
        }
        if (o + 1 < c_left) {
          p[plane] = acc[mt][nt][1];
          p[plane + 8] = acc[mt][nt][3];
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// B5: 3x3 SAME conv + bias -> "lrelu" / "none" -> 2x2 mean pool, over slabs
// ---------------------------------------------------------------------------

// ConvBf16Ring's tiles, walk, copies, stages, bytes, fragments and order of
// mma steps; only the m16 layout and the epilogue differ. Warp w's m16 tile
// mt, q = w * MT + mt, is two rows of 8 columns (bf16_conv.cuh kPool2x8):
// pixel g at row y0 + 2 * (q / 4), column x0 + 8 * (q % 4) + g, pixel g + 8
// one row below it, XW words on in the patch (frag_a's `half`). The 32 lanes' words of a
// fragment load are still 2t * CS + g apart, on 32 banks. So the lane
// holding pixel g holds the pixel below it in d[2], d[3]: a 2x2 window's
// vertical mean is one add in a thread and its horizontal mean one xor
// shuffle of 4 lanes (pixel g ^ 1). The mean is taken rows first, then
// columns, 0.5 * (0.5 * (a00 + a10) + 0.5 * (a01 + a11)), after the
// activation, as in packed_convpool.cu; the layout moves no sum, so
// packed_conv "lrelu" at the same mode pooled in this order gives these
// bits (convpool_lrelu's mask recompute relies on it). compute is B2's with
// the layout's rows, columns and `half`: one compute for both layouts
// (mtile_row / mtile_col in B2's too) ran B2 at a slab of 8 at "mid" 12-16%
// slower, with the same bits (measured: PERF.md §6). A last slab padded
// past a Cout that is no multiple of 8 stores only the channels below Cout
// (after the shuffles, which every lane takes part in).
template <int COUT, int NTERM, int EPI>
struct ConvPoolBf16Ring : ConvBf16Ring<COUT, NTERM, EPI> {
  static_assert(EPI == kLrelu || EPI == kNone, "B5's epilogues");
  using Base = ConvBf16Ring<COUT, NTERM, EPI>;
  static constexpr int MT = Base::MT, NT = Base::NT, XW = Base::XW, CS = Base::CS;
  using Base::Base;

  __device__ __forceinline__ void compute(const float* stage, int, int chunk,
                                          float (&acc)[MT][NT][4]) const {
    const unsigned* ws = reinterpret_cast<const unsigned*>(stage + Base::kX);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int halves = this->C - chunk * kCK > kCK / 2 ? 2 : 1;  // block-uniform
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // channels 16 * kk .. + 15 of the chunk
        if (kk >= halves) break;
        unsigned bf[NT][2];
        ldmatrix_b<NT>(bf, ws + tap * COUT * kRowWords + 8 * kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // output row r, column c of the tile reads patch row r + ky, patch
          // column c + kx + 3
          const int q = warp * MT + mt;
          const int row = mtile_row<kPool2x8>(q) + ky;
          const int col = mtile_col<kPool2x8>(q) + kx + 3 + g;
          unsigned a[NTERM][4];
          frag_a<NTERM, CS>(a, stage + (16 * kk + 2 * t) * CS + row * XW + col, XW);
          mma_frag<NT, NTERM>(acc[mt], a, bf);
        }
      }
    }
  }

  __device__ __forceinline__ void finish(int tile, float (&acc)[MT][NT][4]) const {
    int b, y0, x0, slab;  // pooled: rows y0 / 2 .. + TH / 2, columns x0 / 2 .. + 15
    this->tile_of(tile, b, y0, x0, slab);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int Hp = this->H / 2, Wp = this->W / 2;
    const size_t plane = static_cast<size_t>(Hp) * Wp;
    const int odd = g & 1;  // even lanes store channel 2 tq, odd ones 2 tq + 1
    const int c_left = this->cout - slab * COUT;  // the slab's channels to store
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      bias_act_frag<NT, EPI>(acc[mt], this->bias + slab * COUT);
      // rows y0 + 2 (q / 4), + 1 and columns x0 + 8 (q % 4) + g pool into
      // row y0 / 2 + q / 4, column x0 / 2 + 4 (q % 4) + g / 2
      const int q = warp * MT + mt;
      float* row = this->y + (static_cast<size_t>(b) * this->cout + slab * COUT) * plane +
                   static_cast<size_t>(y0 / 2 + q / 4) * Wp + x0 / 2 + 4 * (q % 4) + g / 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // channels 8 nt + 2 tq (+ 1): the column's two rows, then the column g ^ 1
        // of the same window (a + b == b + a: both lanes get the same bits)
        const float v0 = 0.5f * (acc[mt][nt][0] + acc[mt][nt][2]);
        const float v1 = 0.5f * (acc[mt][nt][1] + acc[mt][nt][3]);
        const float p0 = 0.5f * (v0 + __shfl_xor_sync(0xffffffffu, v0, 4));
        const float p1 = 0.5f * (v1 + __shfl_xor_sync(0xffffffffu, v1, 4));
        if (8 * nt + 2 * tq + odd < c_left)
          row[static_cast<size_t>(8 * nt + 2 * tq + odd) * plane] = odd ? p1 : p0;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// B3: 3x3 SAME conv + bias -> LeakyReLU -> PixelNorm -> toRGB -> the blend
// with the nearest-2x of the previous RGB (-> tanh -> uint8), NHWC out
// ---------------------------------------------------------------------------

// ConvBf16Ring<COUT, NTERM, kLreluNorm> at one slab of all COUT channels:
// its tiles, walk, copies, stages, bytes, fragments and compute, so each
// feature has B2 "lrelu_norm"'s bits; only the epilogue differs, and the
// features never leave the registers. finish: bias_lrelu_norm_frag, then
// each lane's toRGB products of its channels 8 nt + 2 tq (+ 1) for its two
// pixels, each feature rounded (at "mid" split) in the lane, summed over nt,
// then e; the quad's sum by xor shuffles of 1, then 2; lane tq = 0 writes
// pixel g and lane 1 pixel g + 8: prev + alpha * ((rgb + rgb_b) - prev), prev
// the nearest-2x of the previous RGB, then at U8 tanh -> rint((t + 1) *
// 127.5) -> clip [0, 255] -> uint8 (conv_tile.cuh rgb_blend_store's
// arithmetic). It runs while the next tile's first chunk is in flight, with
// no other work beside it in the SM, so its latencies add up: the lane's
// prev values of all m16 tiles are loaded first, and every tile's RGB is
// summed before the first store (a load after a store waits for it: the
// members carry no __restrict__).
template <int COUT, int NTERM, bool U8>
struct ConvRgbBf16Ring : ConvBf16Ring<COUT, NTERM, kLreluNorm> {
  using Base = ConvBf16Ring<COUT, NTERM, kLreluNorm>;
  using T = typename Base::T;
  static constexpr int MT = Base::MT, NT = Base::NT;

  const float* rgb_w;  // [3][COUT]: bf16 values (the wrapper's) in fp32, zeros past cout
  const float* rgb_b;  // [3]
  const float* prev;   // [B][3][H/2][W/2]
  float alpha;
  void* out;           // [B][H][W][3], uint8 at U8, else fp32

  __device__ __forceinline__ ConvRgbBf16Ring(const float* x_, const unsigned* wk_,
                                             const float* b_, const float* rgb_w_,
                                             const float* rgb_b_, const float* prev_,
                                             float alpha_, void* out_, int C_, int H_, int W_,
                                             int cout_)
      : Base(x_, wk_, b_, nullptr, C_, H_, W_, 1, cout_), rgb_w(rgb_w_), rgb_b(rgb_b_),
        prev(prev_), alpha(alpha_), out(out_) {}

  __device__ __forceinline__ void finish(int tile, float (&acc)[MT][NT][4]) const {
    int b, y0, x0, slab;  // slab 0: all COUT channels
    this->tile_of(tile, b, y0, x0, slab);
    const int H = this->H, W = this->W;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int Hp = H / 2, Wp = W / 2;
    const float* pv = prev + static_cast<size_t>(b) * 3 * Hp * Wp;
    // m16 tile mt's pixel of lane tq < 2: pixel g (tq 0) or g + 8 (tq 1)
    auto gy = [&](int mt) { return y0 + warp * T::RW + mt / 2; };
    auto gx = [&](int mt) { return x0 + 16 * (mt % 2) + g + 8 * tq; };
    float pk[MT][3];
    if (tq < 2) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          pk[mt][k] = __ldg(pv + (static_cast<size_t>(k) * Hp + gy(mt) / 2) * Wp + gx(mt) / 2);
    }
    float rgb[MT][3];  // the lane's pixel's (tq < 2)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      bias_lrelu_norm_frag<NT>(acc[mt], this->bias, this->inv_cout);
#pragma unroll
      for (int h = 0; h < 2; ++h)  // pixel g, pixel g + 8
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float p = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              p = fmaf(NTERM == 1 ? round_bf16(acc[mt][nt][2 * h + e])
                                  : split2(acc[mt][nt][2 * h + e]),
                       __ldg(rgb_w + k * COUT + 8 * nt + 2 * tq + e), p);
          p += __shfl_xor_sync(0xffffffffu, p, 1);
          p += __shfl_xor_sync(0xffffffffu, p, 2);
          if (h == 0 || tq == 1) rgb[mt][k] = p;
        }
    }
    if (tq >= 2) return;
    const float rb[3] = {__ldg(rgb_b), __ldg(rgb_b + 1), __ldg(rgb_b + 2)};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const size_t o = ((static_cast<size_t>(b) * H + gy(mt)) * W + gx(mt)) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = pk[mt][k] + alpha * ((rgb[mt][k] + rb[k]) - pk[mt][k]);
        if constexpr (U8) {
          const float th = tanhf(v);
          const float q = fminf(fmaxf(rintf((th + 1.0f) * 127.5f), 0.f), 255.f);
          static_cast<unsigned char*>(out)[o + k] = static_cast<unsigned char>(q);
        } else {
          static_cast<float*>(out)[o + k] = v;
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// B1: nearest-2x upsample -> 3x3 SAME conv + bias -> "lrelu_norm" / "lrelu"
// from the pre-summed parity taps, optionally with the toRGB of the input
// ---------------------------------------------------------------------------

// The tile: the output rows of ONE parity py under TH input rows and 16
// input columns, both column parities, all COUT channels; warp w's m16 tile
// 2 * rr + px is input row i0 + w * RW + rr, input columns j0 + 0..15 at
// output column parity px. Patch row r is input row i0 + py - 1 + r, column
// q input column j0 - 4 + q. The toRGB of the input runs in the py = 0
// tiles, one input pixel a thread (threads past TH x 16 none).
template <int COUT, int NTERM, int EPI>
struct UpconvBf16Ring {
  using T = BfTile<COUT>;
  static constexpr int MT = T::MT, NT = T::NT;
  static constexpr int SR = T::TH + 1;  // patch rows
  static constexpr int XW = 24;         // patch columns
  static constexpr int CS = SR * XW + 4;
  static constexpr int kX = kCK * CS;
  static constexpr int kW = 8 * COUT * kRowWords;  // [2 px][4 taps][COUT][40] bf16
  static constexpr int kStage = kX + kW;
  static constexpr int kStages = 3;
  static constexpr int kBytes = 4 * kStages * kStage;
  static_assert(CS % 16 == 4 || CS % 16 == 12, "a fragment load on 32 banks");
  static_assert(kX % 4 == 0 && kStage % 4 == 0, "16-byte aligned stage parts");

  const float* x;
  const unsigned* wk;
  const float* bias;
  const float* rgb_w;
  const float* rgb_b;
  float* y;
  float* rgb;
  int C, H, W, cout, tiles_x, tiles_y, n_chunks;  // cout: up to COUT
  float inv_cout;  // PixelNorm's 1 / cout
  float racc[3];
  PatchCopies<SR, XW, CS> copies;

  __device__ __forceinline__ UpconvBf16Ring(const float* x_, const unsigned* wk_,
                                            const float* b_, const float* rgb_w_,
                                            const float* rgb_b_, float* y_, float* rgb_, int C_,
                                            int H_, int W_, int cout_)
      : x(x_), wk(wk_), bias(b_), rgb_w(rgb_w_), rgb_b(rgb_b_), y(y_), rgb(rgb_), C(C_), H(H_),
        W(W_), cout(cout_), tiles_x(W_ / 16), tiles_y(H_ / T::TH), n_chunks(bf16_chunks(C_)),
        inv_cout(1.0f / static_cast<float>(cout_)) {
    copies.init();
  }

  // Tile t: the parity fastest, then columns, rows and images (ops/packed.py
  // upconv_tile_origin, conv_ring.cuh UpconvRing::tile_of).
  __device__ __forceinline__ void tile_of(int t, int& b, int& i0, int& j0, int& py) const {
    py = t & 1;
    t >>= 1;
    j0 = (t % tiles_x) * 16;
    t /= tiles_x;
    i0 = (t % tiles_y) * T::TH;
    b = t / tiles_y;
  }

  __device__ __forceinline__ bool rgb_lane(int py) const {
    return rgb_w != nullptr && py == 0 && static_cast<int>(threadIdx.x) < T::TH * 16;
  }

  __device__ __forceinline__ void issue(float* stage, int t, int chunk) const {
    int b, i0, j0, py;
    tile_of(t, b, i0, j0, py);
    const int c0 = chunk * kCK;
    copies.issue(stage, x + (static_cast<size_t>(b) * C + c0) * H * W, C - c0, H, W,
                 i0 + py - 1, j0 - 4);
    stage_w(reinterpret_cast<unsigned*>(stage + kX),
            wk + (static_cast<size_t>(py) * n_chunks + chunk) * kW, kW);
  }

  __device__ __forceinline__ void compute(const float* stage, int tile, int chunk,
                                          float (&acc)[MT][NT][4]) {
    const unsigned* ws = reinterpret_cast<const unsigned*>(stage + kX);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int c0 = chunk * kCK;
    const int c_n = min(kCK, C - c0);          // the chunk's channels
    const int halves = c_n > kCK / 2 ? 2 : 1;  // block-uniform
    if (chunk == 0) racc[0] = racc[1] = racc[2] = 0.f;
    if (rgb_lane(tile & 1)) {
      // input row i0 + pr is patch row pr + 1, column j0 + pc patch column pc + 4
      const float* px = stage + (threadIdx.x / 16 + 1) * XW + threadIdx.x % 16 + 4;
      const int row = (C + 3) & ~3;  // rgb_w's row: C rounded up to 4, zeros past C
#pragma unroll 2
      for (int c = 0; c < c_n; c += 4) {  // rgb_w 16-byte aligned rows; zeros past C
        float w4[3][4];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          *reinterpret_cast<float4*>(w4[k]) =
              __ldg(reinterpret_cast<const float4*>(rgb_w + k * row + c0 + c));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // the value the mma reads: x_hi, or x_hi + x_lo (exact) at "mid"
          const float v = NTERM == 1 ? round_bf16(px[(c + i) * CS]) : split2(px[(c + i) * CS]);
#pragma unroll
          for (int k = 0; k < 3; ++k) racc[k] = fmaf(v, w4[k][i], racc[k]);
        }
      }
    }
    // The A fragment of (tap (dy, dx), half kk, parity pxp, row rr) is
    // fa[rr + dy][pxp + dx][kk]: input row i0 + warp * RW + rr reads patch
    // row warp * RW + rr + dy; output column 2 * (j0 + g) + pxp reads input
    // column j0 + g + pxp + dx - 1, patch column g + pxp + dx + 3. Each
    // distinct fragment is loaded once a chunk: dy = 1 loads only row RW and
    // reuses rows 1 .. RW - 1 of dy = 0. Each accumulator takes its products
    // in the order (dy, dx), kk.
    unsigned fa[T::RW + 1][3][2][NTERM][4];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int r = dy == 0 ? 0 : T::RW; r < T::RW + dy; ++r)
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          if (kk >= halves) break;
#pragma unroll
          for (int o = 0; o < 3; ++o)
            frag_a<NTERM, CS>(fa[r][o][kk],
                              stage + (16 * kk + 2 * t) * CS + (warp * T::RW + r) * XW + o + 3 + g,
                              8);
        }
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int tap = 2 * dy + dx;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {  // channels 16 * kk .. + 15 of the chunk
          if (kk >= halves) break;
#pragma unroll
          for (int pxp = 0; pxp < 2; ++pxp) {
            unsigned bf[NT][2];
            ldmatrix_b<NT>(bf, ws + (pxp * 4 + tap) * COUT * kRowWords + 8 * kk);
#pragma unroll
            for (int rr = 0; rr < T::RW; ++rr)
              mma_frag<NT, NTERM>(acc[2 * rr + pxp], fa[rr + dy][pxp + dx][kk], bf);
          }
        }
      }
    }
  }

  __device__ __forceinline__ void finish(int tile, float (&acc)[MT][NT][4]) const {
    int b, i0, j0, py;
    tile_of(tile, b, i0, j0, py);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    if (rgb_lane(py)) {
      const int pr = threadIdx.x / 16, pc = threadIdx.x % 16;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rgb[((static_cast<size_t>(b) * 3 + k) * H + i0 + pr) * W + j0 + pc] =
            racc[k] + __ldg(rgb_b + k);
    }
    const int Wo = 2 * W;
    const size_t plane = static_cast<size_t>(2 * H) * Wo;
#pragma unroll
    for (int rr = 0; rr < T::RW; ++rr) {
      if constexpr (EPI == kLreluNorm) {
        bias_lrelu_norm_frag<NT>(acc[2 * rr], bias, inv_cout);
        bias_lrelu_norm_frag<NT>(acc[2 * rr + 1], bias, inv_cout);
      } else {
        bias_act_frag<NT, EPI>(acc[2 * rr], bias);
        bias_act_frag<NT, EPI>(acc[2 * rr + 1], bias);
      }
      float* row = y + static_cast<size_t>(b) * cout * plane +
                   static_cast<size_t>(2 * (i0 + warp * T::RW + rr) + py) * Wo + 2 * (j0 + g);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // channel 8 * nt + 2 * tq + e % 2; pixel g (e < 2) or g + 8
          const int o = 8 * nt + 2 * tq + (e & 1);
          if (o >= cout) continue;
          float* p = row + static_cast<size_t>(o) * plane + (e >> 1) * 16;
          *reinterpret_cast<float2*>(p) = make_float2(acc[2 * rr][nt][e], acc[2 * rr + 1][nt][e]);
        }
    }
  }
};

}  // namespace probgan
