// to_uint8_fused: tanh -> (t + 1) * 127.5 -> round half to even -> clamp to
// [0, 255] -> uint8, elementwise over any contiguous fp32 tensor.
//
// Replaces probgan_tpu/ops/pallas_image.py:53 `_denorm_flat` (kernel
// `_denorm_kernel`), reached through `to_uint8_fused`: the opt-in denorm of
// the image engine (`use_pallas`), at [8, 1024, 1024, 3] on the 1024^2 path.
//
// Bound on the H100: bytes. 5 bytes move per element (4 in, 1 out) for one
// tanh and a handful of operations: 126 MB at 3.35 TB/s = 0.038 ms for the
// main path's 25.2 M elements. The design is therefore only about the memory
// system: each thread loads 16 bytes (float4) and stores 4 (uchar4), so a warp
// reads 512 contiguous bytes and writes 128 contiguous bytes per step; a
// grid-stride loop keeps a few waves of blocks in flight; the last n % 4
// elements, and a tensor whose storage is not 16-byte aligned, take a scalar
// path. No fast-math: tanhf and rintf are the IEEE-grade library functions,
// because one ulp of tanh can move a pixel across a rounding boundary.
#include <cuda_runtime.h>

namespace probgan {

__device__ __forceinline__ unsigned char denorm(float v) {
  const float t = rintf((tanhf(v) + 1.0f) * 127.5f);  // rintf: half to even
  return static_cast<unsigned char>(fminf(fmaxf(t, 0.0f), 255.0f));
}

__global__ void __launch_bounds__(256)
    denorm_uint8_kernel(const float* __restrict__ x, unsigned char* __restrict__ y, long long n,
                        int vec) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    uchar4* y4 = reinterpret_cast<uchar4*>(y);
    for (long long i = tid; i < n4; i += stride) {
      const float4 v = __ldg(x4 + i);
      y4[i] = make_uchar4(denorm(v.x), denorm(v.y), denorm(v.z), denorm(v.w));
    }
    done = n4 << 2;
  }
  for (long long i = done + tid; i < n; i += stride) y[i] = denorm(x[i]);
}

}  // namespace probgan

// x [n] fp32 -> y [n] uint8. `vec` = 1 when x is 16-byte and y 4-byte aligned
// (float4 loads, uchar4 stores), else 0 (scalar). Returns the cudaError_t of
// the launch (0 = launched).
extern "C" int probgan_denorm_uint8(const float* x, unsigned char* y, long long n, int vec,
                                    void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long per_block = 256LL * 4 * 8;  // 8 vector steps per thread
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  probgan::denorm_uint8_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                                 static_cast<cudaStream_t>(stream)>>>(x, y, n, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probgan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
