// The 3xTF32 grade on the tensor cores, shared by the kernels that use it
// (packed_conv_wgrad.cu, packed_conv.cu's "none" epilogue, and through
// rank_ring.cuh rank_scores.cu and rank_topk.cu).
//
// Each fp32 operand v is split into hi = tf32(v) and lo = v - hi, and every
// product is taken as lo*hi + hi*lo + hi*hi with mma.sync.m16n8k8 TF32: what
// is dropped (lo*lo and the truncation of lo) is about 2^-21 of a product, so
// the sum is fp32-accurate. The tensor cores round each mma's sum toward
// zero, a bias of up to an ulp of the accumulator per instruction: a kernel
// adds a part of a few k steps into its fp32 sums with a rounded fp32 add, so
// the bias stays within the part's own size.
#pragma once

#include <cuda_runtime.h>

namespace probgan {

// hi = v rounded to TF32 (to nearest, ties away from zero: what
// cvt.rna.tf32.f32 gives, in integer ops on the full-rate pipes), lo = v - hi,
// exact in fp32; the tensor cores read lo's top 19 bits (they ignore the low
// 13 bits of a TF32 operand, so lo enters truncated).
__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// D (16x8, fp32) += A (16x8, tf32, row-major) * B (8x8, tf32, column-major).
// Fragments (g = lane / 4, t = lane % 4): a = {A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace probgan
