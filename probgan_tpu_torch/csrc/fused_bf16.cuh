// One whole generator stage in one kernel at the bf16 kernel modes: "default"
// (one bf16 pass) and "mid" (the 2-term split) of the stage-fused pair.
//   nearest-2x upsample -> conv1 3x3 + bias -> LeakyReLU(0.2) -> PixelNorm
//   -> conv2 3x3 + bias -> LeakyReLU -> PixelNorm (-> toRGB -> blend)
// Shared by packed_upconv_conv_bf16.cu (a non-final stage, features out) and
// packed_upconv_conv_rgb_bf16.cu (the final stage, RGB out). conv1's feature
// map never reaches device memory: it lives in shared memory already rounded
// (at "mid": split) as conv2 reads it.
//
// Bit-equal, per mode, to the bf16 pair it replaces (packed_upconv_bf16.cu,
// then packed_conv_bf16.cu or packed_conv_rgb_bf16.cu). Each value keeps
// the pair's K order and mma grouping (bf16_conv.cuh): chunks of kCK = 32
// input channels ascending, then taps, then the two channel halves of a
// chunk, then terms, one mma.sync.m16n8k16 a (chunk, tap, half, term) with
// channel 16 * half + k of the chunk at K position k. Which pixel sits in
// which m16 row moves no sum, so conv1's m16 tiles may hold any pixels of
// one parity class (its taps are the B operand). conv1's epilogue is
// bias_lrelu_norm_frag on the fragments, as in B1; its output is rounded to
// bf16 (at "mid" split in x_hi and x_lo) exactly as B2's staging rounds the
// fp32 map it reads from device memory; the previous stage's RGB sums the
// rounded (split) input as B1's toRGB does, and conv2's epilogues are B2's
// and B3's, the same expressions.
//
// Bound on the H100: operations (bf16 tensor cores). Per image at stage 7
// conv1 does 2*4*128*64*512^2 = 17.2 GFLOP and conv2 2*9*64*64*512^2 = 19.3
// GFLOP over 34 MB in and 67 MB out: 0.074 ms at batch 2 at 989 TFLOP/s
// ("mid" runs twice the products, 0.148 ms), above the 0.060 ms of bytes.
//
// The design, simple first: one block a conv2 tile of TH x 32 outputs and
// all COUT channels (BfTile: TH = 8 at 64 channels, 16 at 32, 16 and 8), no
// carry between tiles.
//  * conv1 computes the tile's whole halo: conv1 rows y0-1 .. y0+TH and
//    columns x0-1 .. x0+32, a "map" of (TH+2) x 34 pixels. By output parity
//    class (py, px) that is TH/2 + 1 class rows of 17 class columns each:
//    class row a is conv1 row y0 + 2a - py, class column b conv1 column
//    x0 + 2b - px, which reads the staged input at patch row a + dy, column
//    b + 3 + dx for its four pre-summed taps (dy, dx). Columns 0..15 of a
//    class row are one m16 tile (as in B1); column 16 of all class rows is
//    one more tile (rows a of pixel g, a + 8 of pixel g + 8). Warps 2k and
//    2k + 1 hold class k, (TH/2 + 2)/2 tiles each: 3 at TH 8, 5 at 16, so a
//    warp loads a (tap, half)'s B fragments once for all its tiles. conv1
//    pixels a conv2 output: (TH+2) x 34 / (TH x 32), 1.33 at TH 8 and 1.20
//    at 16 (m16 rows: 1.50 and 1.25); the utilities count them from the
//    kernel (the `tally` argument), not from this tiling.
//  * Map rows and columns outside the image hold zero in both planes:
//    conv2's SAME padding, not conv1's epilogue of a zero input.
//  * Shared memory a block (32-bit words): the stage, the larger of conv1's
//    (its input patch, TH/2 + 2 rows x 24 columns x 20 words, once a term,
//    and both row parities' taps of a chunk, 2 x 8 x COUT x 20) and one
//    chunk of conv2's weights (9 x COUT x 20), which share one region; the
//    map, NTERM x ceil(COUT/32) x (TH+2) x 34 x 20, in bf16_conv.cuh's [row]
//    [column][channel] layout, so that conv2's A fragments load as B2's do;
//    B11's previous RGB, 3 x TH/2 x 16 floats. In bytes (B10 the same less
//    the RGB): Cout 64 148,608 ("default") and 214,528 ("mid"); Cout 32
//    110,656 and 178,816; Cout 16 90,176 and 158,336; Cout 8
//    79,936 and 148,096 (ops/packed.py fused_bf16_bytes). One block an SM
//    at 64 and 32 channels ("mid"), up to two below.
//  * Narrow stages (16 and 8 channels, a narrow generator's: C 32 -> 16,
//    C 16 -> 8): the block keeps its 8 warps and the 16-row tile with NT = 2
//    or 1 n8 tiles, as B1/B2/B3 do at these widths. The map is one partial
//    chunk of 32 channels, of which conv2 reads the first k16 half only, as
//    B2 reads a 16- or 8-channel input; at 8 channels the half's channels
//    8..15 are zero words, written once. conv1's input C is any multiple of
//    8: its last chunk of C % 32 channels is staged with zeros past C
//    (stage_chunk, weights zero there too) and at 16 or fewer runs one k16
//    half, and the previous RGB sums the chunk's C - c0 channels: B1's K
//    order and mma grouping at every width.
//  * Staging is synchronous, as in the pair: cp.async of the weights beside
//    the input's rounding stores, one barrier, the products, one barrier.
//    conv2's first chunk of weights is copied under conv1's epilogue.
#pragma once

#include "bf16_conv.cuh"

namespace probgan {

enum FusedBf16Tail { kBfFeatures = 0, kBfRgbF32 = 1, kBfRgbU8 = 2 };

template <int COUT, int NTERM, int TAIL>
struct FusedBf16 {
  using T = BfTile<COUT>;
  static constexpr int TH = T::TH;            // conv2 tile: TH x 32
  static constexpr int NCH = (COUT + kCK - 1) / kCK;  // chunks of the map's channels
  static constexpr int HALVES2 = COUT > kCK / 2 ? 2 : 1;  // k16 halves conv2 reads a chunk
  static constexpr int MR = TH + 2;           // map rows: conv1 rows y0-1 .. y0+TH
  static constexpr int MW = 34;               // map columns: conv1 columns x0-1 .. x0+32
  static constexpr int kMapChunk = MR * MW * kRowWords;
  static constexpr int kMapTerm = NCH * kMapChunk;
  static constexpr int kMap = NTERM * kMapTerm;
  static constexpr int CR = TH / 2 + 1;       // class rows of a parity class
  static constexpr int NPW = (CR + 1) / 2;    // conv1 m16 tiles a warp
  static_assert(2 * NPW == CR + 1, "two warps hold a class's CR row tiles and its column tile");
  static constexpr int SR = TH / 2 + 2;       // staged input rows y0/2-1 .. y0/2+TH/2
  static constexpr int NG = 3;                // staged input columns x0/2-4 .. x0/2+19
  static constexpr int PW = 8 * NG;           // their row stride in pixels
  static constexpr int kXWords = SR * PW * kRowWords;   // one term's input plane
  static constexpr int kW1Words = 8 * COUT * kRowWords;  // one row parity's taps of a chunk
  static constexpr int kConv1 = NTERM * kXWords + 2 * kW1Words;
  static constexpr int kConv2 = 9 * COUT * kRowWords;    // one chunk of conv2's weights
  static constexpr int kStage = kConv1 > kConv2 ? kConv1 : kConv2;
  static constexpr int PREV = TAIL != kBfFeatures ? 3 * (TH / 2) * 16 : 0;  // floats
  static constexpr int kBytes = 4 * (kStage + kMap + PREV);
  static_assert((NTERM * kXWords) % 4 == 0 && kStage % 4 == 0, "16-byte aligned parts");
};

// mma_row with the two pixels of each lane anywhere in the staged plane: `pg`
// is pixel g's word (tap, channel half and pair already added), `ph` pixel
// g + 8's; the same K order, term by term.
template <int NT, int NTERM>
__device__ __forceinline__ void mma_pixels(float (&acc)[NT][4], const unsigned* pg,
                                           const unsigned* ph, int plane,
                                           const unsigned (&b)[NT][2]) {
#pragma unroll
  for (int term = 0; term < NTERM; ++term) {
    const unsigned a[4] = {pg[term * plane], ph[term * plane], pg[term * plane + 4],
                           ph[term * plane + 4]};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[nt], a, b[nt][0], b[nt][1]);
  }
}

template <int COUT, int NTERM, int TAIL>
__global__ void __launch_bounds__(kThreads, 1)
    fused_bf16_kernel(const float* __restrict__ x, const unsigned* __restrict__ wk1,
                      const float* __restrict__ b1, const unsigned* __restrict__ wk2,
                      const float* __restrict__ b2, const float* __restrict__ rgb_w,
                      const float* __restrict__ rgb_b, const float* __restrict__ prev_w,
                      const float* __restrict__ prev_b, float alpha, void* __restrict__ y,
                      unsigned long long* __restrict__ tally, int C, int H, int W) {
  using K = FusedBf16<COUT, NTERM, TAIL>;
  using T = BfTile<COUT>;
  constexpr int TH = K::TH, NT = T::NT, CR = K::CR, NPW = K::NPW;
  constexpr bool RGB = TAIL != kBfFeatures;
  extern __shared__ __align__(16) unsigned fused_bf16_smem[];
  unsigned* xs = fused_bf16_smem;                 // conv1: input planes, then taps
  unsigned* ws1 = fused_bf16_smem + NTERM * K::kXWords;
  unsigned* ws2 = fused_bf16_smem;                // conv2: one chunk of weights
  unsigned* map = fused_bf16_smem + K::kStage;
  float* prev_s = reinterpret_cast<float*>(map + K::kMap);
  const int Ho = 2 * H, Wo = 2 * W;
  const int tiles_x = Wo / 32, tiles_y = Ho / TH;
  int t = blockIdx.x;
  const int x0 = (t % tiles_x) * 32;
  t /= tiles_x;
  const int y0 = (t % tiles_y) * TH;
  const int b = t / tiles_y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  // conv1's parity class and, for each of the warp's tiles, the words of the
  // lane's pixels g and g + 8 at tap (0, 0), channel pair tq: tile v of the
  // class is class row v (columns 0..15) for v < CR, else column 16
  const int cls = warp >> 1, py = cls >> 1, px = cls & 1;
  int off_g[NPW], off_h[NPW];
#pragma unroll
  for (int u = 0; u < NPW; ++u) {
    const int v = (warp & 1) * NPW + u;
    if (v < CR) {
      off_g[u] = (v * K::PW + g + 3) * kRowWords + tq;
      off_h[u] = off_g[u] + 8 * kRowWords;
    } else {  // rows past the class's last repeat it and are not stored
      off_g[u] = (min(g, CR - 1) * K::PW + 19) * kRowWords + tq;
      off_h[u] = (min(g + 8, CR - 1) * K::PW + 19) * kRowWords + tq;
    }
  }
  // the previous stage's RGB: one input pixel a thread under the tile,
  // rows y0/2 .. y0/2 + TH/2 - 1, columns x0/2 .. x0/2 + 15
  const bool rgb_lane = RGB && threadIdx.x < (TH / 2) * 16;
  const int pr = threadIdx.x / 16, pc = threadIdx.x % 16;
  float racc[3] = {0.f, 0.f, 0.f};

  if constexpr (COUT == 8) {
    // channels 8..15 of the map's k16 half, which conv2 reads: zero (its
    // weights there are zero too), in every pixel and term, never written again
    for (int e = threadIdx.x; e < NTERM * K::MR * K::MW; e += kThreads)
      *reinterpret_cast<uint4*>(map + e * kRowWords + 4) = make_uint4(0u, 0u, 0u, 0u);
  }

  float acc1[NPW][NT][4];
#pragma unroll
  for (int u = 0; u < NPW; ++u)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[u][nt][e] = 0.f;
  const float* xb = x + static_cast<size_t>(b) * C * H * W;
  const int n_chunks = bf16_chunks(C);
  for (int c0 = 0; c0 < C; c0 += kCK) {
    const int k = c0 / kCK;
    stage_w(ws1, wk1 + static_cast<size_t>(k) * K::kW1Words, K::kW1Words);  // py = 0
    stage_w(ws1 + K::kW1Words, wk1 + static_cast<size_t>(n_chunks + k) * K::kW1Words,
            K::kW1Words);  // py = 1
    cp_async_commit();
    stage_chunk<K::SR, K::NG, NTERM>(xs, xb, c0, C, H, W, y0 / 2 - 1, x0 / 2 - 4);
    cp_async_wait(0);
    __syncthreads();
    const int c_n = min(kCK, C - c0);          // the chunk's channels
    const int halves = c_n > kCK / 2 ? 2 : 1;  // block-uniform
    if (rgb_lane) {
      const auto* pv = reinterpret_cast<const __nv_bfloat16*>(xs) +
                       ((pr + 1) * K::PW + pc + 4) * kPadK;
#pragma unroll 4
      for (int c = 0; c < c_n; ++c) {
        // x_hi, + x_lo from the next plane at "mid": the sum is exact
        const float v = NTERM == 1 ? __bfloat162float(pv[c])
                                   : __bfloat162float(pv[c]) +
                                         __bfloat162float(pv[c + 2 * K::kXWords]);
#pragma unroll
        for (int j = 0; j < 3; ++j) racc[j] = fmaf(v, __ldg(prev_w + j * C + c0 + c), racc[j]);
      }
    }
    const unsigned* wcls = ws1 + py * K::kW1Words + px * 4 * COUT * kRowWords;
#pragma unroll 1
    for (int tap = 0; tap < 4; ++tap) {
      const int shift = ((tap >> 1) * K::PW + (tap & 1)) * kRowWords;  // (dy, dx)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // channels 16 * kk .. + 15 of the chunk
        if (kk >= halves) break;
        unsigned bf[NT][2];
        load_b<NT>(bf, wcls + tap * COUT * kRowWords + 8 * kk);
#pragma unroll
        for (int u = 0; u < NPW; ++u)
          mma_pixels<NT, NTERM>(acc1[u], xs + off_g[u] + shift + 8 * kk,
                                xs + off_h[u] + shift + 8 * kk, K::kXWords, bf);
      }
    }
    __syncthreads();  // every warp is done with the chunk before it is replaced
  }

  // The stage is free: conv2's first chunk of weights comes in under conv1's
  // epilogue.
  stage_w(ws2, wk2, K::kConv2);
  cp_async_commit();
  if (rgb_lane) {
#pragma unroll
    for (int j = 0; j < 3; ++j) prev_s[(j * (TH / 2) + pr) * 16 + pc] = racc[j] + __ldg(prev_b + j);
  }
  unsigned long long stored = 0;
#pragma unroll
  for (int u = 0; u < NPW; ++u) {
    bias_lrelu_norm_frag<NT>(acc1[u], b1);
    const int v = (warp & 1) * NPW + u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // pixel g (e = 0, 1), pixel g + 8 (e = 2, 3)
      const int a = v < CR ? v : g + 8 * h;
      const int bc = v < CR ? g + 8 * h : 16;
      if (a >= CR) continue;
      const int r = 2 * a + 1 - py, q = 2 * bc + 1 - px;  // map row and column
      const int oy = y0 - 1 + r, ox = x0 - 1 + q;
      const bool inside = oy >= 0 && oy < Ho && ox >= 0 && ox < Wo;
      if (tq == 0) ++stored;
      unsigned* dst = map + (r * K::MW + q) * kRowWords + tq;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // channels 8 * nt + 2 * tq, + 1: chunk nt / 4, word 4 * (nt % 4) + tq
        const float v0 = inside ? acc1[u][nt][2 * h] : 0.f;
        const float v1 = inside ? acc1[u][nt][2 * h + 1] : 0.f;
        unsigned* p = dst + (nt / 4) * K::kMapChunk + 4 * (nt % 4);
        if constexpr (NTERM == 1) {
          p[0] = pack_bf16(v0, v1);
        } else {  // v - bf16(v) is exact in fp32
          const float h0 = round_bf16(v0), h1 = round_bf16(v1);
          p[0] = pack_bf16(h0, h1);
          p[K::kMapTerm] = pack_bf16(v0 - h0, v1 - h1);
        }
      }
    }
  }
  if (tally != nullptr && stored) atomicAdd(tally, stored);
  cp_async_wait(0);
  __syncthreads();

  // conv2 over the map: B2's loop, the patch replaced by the map
  float acc[T::MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int k = 0; k < K::NCH; ++k) {
    if (k > 0) {
      stage_w(ws2, wk2 + static_cast<size_t>(k) * K::kConv2, K::kConv2);
      cp_async_commit();
      cp_async_wait(0);
      __syncthreads();
    }
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < K::HALVES2; ++kk) {
        unsigned bf[NT][2];
        load_b<NT>(bf, ws2 + tap * COUT * kRowWords + 8 * kk);
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          // output row r, column c of the tile reads map row r + ky, column c + kx
          const int q = warp * T::MT + mt;
          const int row = mtile_row<kRow16>(q) + ky;
          const int col = mtile_col<kRow16>(q) + kx;
          mma_row<NT, NTERM>(acc[mt],
                             map + k * K::kMapChunk + (row * K::MW + col) * kRowWords + 8 * kk,
                             8 * kRowWords, K::kMapTerm, bf);
        }
      }
    }
    __syncthreads();  // every warp is done with the weights before they are replaced
  }

  const size_t plane = static_cast<size_t>(Ho) * Wo;
  float rb[3] = {0.f, 0.f, 0.f};
  if constexpr (RGB) {
#pragma unroll
    for (int j = 0; j < 3; ++j) rb[j] = __ldg(rgb_b + j);
  }
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
    bias_lrelu_norm_frag<NT>(acc[mt], b2);
    const int gy = y0 + warp * T::RW + mt / 2;
    if constexpr (!RGB) {  // packed_conv_bf16.cu's stores
      float* row = static_cast<float*>(y) + static_cast<size_t>(b) * COUT * plane +
                   static_cast<size_t>(gy) * Wo + x0 + 16 * (mt % 2) + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* p = row + static_cast<size_t>(8 * nt + 2 * tq) * plane;
        p[0] = acc[mt][nt][0];
        p[plane] = acc[mt][nt][1];
        p[8] = acc[mt][nt][2];
        p[plane + 8] = acc[mt][nt][3];
      }
    } else {  // packed_conv_rgb_bf16.cu's toRGB, blend and denorm
      float rgb[2][3];  // pixel g, pixel g + 8
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float p = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e)  // rgb_w [3][COUT]: bf16 values (the wrapper's) in fp32
              p = fmaf(NTERM == 1 ? round_bf16(acc[mt][nt][2 * h + e])
                                  : split2(acc[mt][nt][2 * h + e]),
                       __ldg(rgb_w + j * COUT + 8 * nt + 2 * tq + e), p);
          p += __shfl_xor_sync(0xffffffffu, p, 1);
          p += __shfl_xor_sync(0xffffffffu, p, 2);
          rgb[h][j] = p;
        }
      if (tq < 2) {
        const int gx = x0 + 16 * (mt % 2) + g + 8 * tq;
        const size_t o = ((static_cast<size_t>(b) * Ho + gy) * Wo + gx) * 3;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float pk = prev_s[(j * (TH / 2) + (gy - y0) / 2) * 16 + (gx - x0) / 2];
          const float v = pk + alpha * ((rgb[tq][j] + rb[j]) - pk);
          if constexpr (TAIL == kBfRgbU8) {
            const float th = tanhf(v);
            const float qv = fminf(fmaxf(rintf((th + 1.0f) * 127.5f), 0.f), 255.f);
            static_cast<unsigned char*>(y)[o + j] = static_cast<unsigned char>(qv);
          } else {
            static_cast<float*>(y)[o + j] = v;
          }
        }
      }
    }
  }
}

// Launch one block a conv2 tile with `smem` bytes of dynamic shared memory
// (checked against FusedBf16::kBytes, ops/packed.py fused_bf16_bytes).
// Returns the cudaError_t of the launch (0 = launched).
template <int COUT, int NTERM, int TAIL>
int launch_fused_bf16(const float* x, const unsigned* wk1, const float* b1, const unsigned* wk2,
                      const float* b2, const float* rgb_w, const float* rgb_b,
                      const float* prev_w, const float* prev_b, float alpha, void* y,
                      unsigned long long* tally, int B, int C, int H, int W, int smem,
                      cudaStream_t stream) {
  using K = FusedBf16<COUT, NTERM, TAIL>;
  const long long n_tiles = static_cast<long long>(B) * (2LL * H / K::TH) * (2LL * W / 32);
  if (B < 1 || C < 8 || C % 8 || H < 1 || (2 * H) % K::TH || W < 16 || W % 16 ||
      n_tiles > 0x7fffffff || smem != K::kBytes ||
      (TAIL != kBfFeatures && (rgb_w == nullptr || prev_w == nullptr)))
    return cudaErrorInvalidValue;
  const auto kernel = fused_bf16_kernel<COUT, NTERM, TAIL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(n_tiles), kThreads, smem, stream>>>(
      x, wk1, b1, wk2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha, y, tally, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for a (Cout, terms) pair: Cout 8, 16, 32 or 64, terms 1 or 2.
template <int TAIL>
int launch_fused_bf16_any(const float* x, const unsigned* wk1, const float* b1,
                          const unsigned* wk2, const float* b2, const float* rgb_w,
                          const float* rgb_b, const float* prev_w, const float* prev_b,
                          float alpha, void* y, unsigned long long* tally, int B, int C, int H,
                          int W, int cout, int terms, int smem, cudaStream_t s) {
#define PROBGAN_FUSED_BF16(CO, NT)                                                            \
  launch_fused_bf16<CO, NT, TAIL>(x, wk1, b1, wk2, b2, rgb_w, rgb_b, prev_w, prev_b, alpha, y, \
                                  tally, B, C, H, W, smem, s)
  if (cout == 64 && terms == 1) return PROBGAN_FUSED_BF16(64, 1);
  if (cout == 64 && terms == 2) return PROBGAN_FUSED_BF16(64, 2);
  if (cout == 32 && terms == 1) return PROBGAN_FUSED_BF16(32, 1);
  if (cout == 32 && terms == 2) return PROBGAN_FUSED_BF16(32, 2);
  if (cout == 16 && terms == 1) return PROBGAN_FUSED_BF16(16, 1);
  if (cout == 16 && terms == 2) return PROBGAN_FUSED_BF16(16, 2);
  if (cout == 8 && terms == 1) return PROBGAN_FUSED_BF16(8, 1);
  if (cout == 8 && terms == 2) return PROBGAN_FUSED_BF16(8, 2);
#undef PROBGAN_FUSED_BF16
  return cudaErrorInvalidValue;
}

}  // namespace probgan
