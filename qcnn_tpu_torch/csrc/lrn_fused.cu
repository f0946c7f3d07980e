// lrn_fused: across-channel local response normalization in one pass over
// memory, for Hopper (sm_90a).
//
// Replaces qcnn_tpu/ops/pallas/lrn_fused.py `lrn_fused` (the pallas_calls
// at :127 `_kernel_shift`, :145 `_kernel_roll` and :165 `_kernel`, the
// "dot" window). The three compute one function and differ only in the
// order of their float32 sums; this one kernel serves all three names.
//
// Computes, over the last axis of a contiguous (M, C) tensor:
//   sq[c]  = x[c] * x[c], rounded to x's dtype (bf16 or f32)
//   sum[c] = sum_{|c' - c| <= r, 0 <= c' < C} float(sq[c'])   (f32, c' in order)
//   y[c]   = float(x[c]) * (k + alpha/size * sum[c]) ** (-beta), in x's dtype
// with r = (size - 1) / 2, and the negative power composed as
// ops/misc._neg_pow composes it (rsqrt for beta 0.5, rsqrt * sqrt(rsqrt)
// for 0.75, a reciprocal for 1, powf otherwise). Every multiply and add is
// rounded on its own (no fused multiply-add), as PyTorch's separate
// elementwise kernels round them.
//
// Bound: bytes, one read and one write of x: AlexNet's LRN1 at B=256 is
// 297 MB (0.089 ms at 3.35 TB/s) and LRN2 191 MB (0.057 ms).
//
// Design: a block of 256 threads owns a run of 256 x 16 bytes of the
// flattened tensor; each thread loads its 16 bytes in one load, writes
// their squares (as floats) to shared memory beside an r-element halo on
// either side, and after one barrier sums each element's window from shared
// memory, masking the neighbours that lie across a channel edge, and
// stores its 16 bytes of output in one store. Shared memory is indexed with
// one word of skew every 32 (slot(i) = i + i / 32): without it the lanes of
// a warp, 4 or 8 words apart, would meet in a few banks (up to 8-way
// conflicts).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

__device__ __forceinline__ float square(__nv_bfloat16 v) {
  return __bfloat162float(__hmul(v, v));  // rounded to bf16
}
__device__ __forceinline__ float square(float v) { return __fmul_rn(v, v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 narrow(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float narrow(float v) {
  return v;
}

// scale ** (-beta); mode 0: beta 0.75, 1: 0.5, 2: 1.0, 3: any other
__device__ __forceinline__ float neg_pow(float scale, float beta, int mode) {
  switch (mode) {
    case 0: {
      const float r = rsqrtf(scale);
      return __fmul_rn(r, sqrtf(r));
    }
    case 1:
      return rsqrtf(scale);
    case 2:
      return __fdiv_rn(1.0f, scale);
    default:
      return powf(scale, -beta);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lrn_fused_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                 int c, int radius, float alpha_over_n, float k, float beta,
                 int mode) {
  constexpr int V = 16 / sizeof(T);  // elements a thread
  constexpr int E = kThreads * V;    // elements a block
  extern __shared__ float sq[];      // radius + E + radius, skewed

  const long long e0 = (long long)blockIdx.x * E;
  const int tid = threadIdx.x;
  const long long e = e0 + (long long)tid * V;

  alignas(16) T xv[V];
  if (e + V <= n) {
    *reinterpret_cast<uint4*>(xv) = __ldg(reinterpret_cast<const uint4*>(x + e));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) xv[v] = e + v < n ? x[e + v] : narrow<T>(0.f);
  }
#pragma unroll
  for (int v = 0; v < V; ++v) sq[slot(radius + tid * V + v)] = square(xv[v]);
  for (int i = tid; i < 2 * radius; i += kThreads) {
    const long long g = i < radius ? e0 - radius + i : e0 + E + (i - radius);
    const int at = i < radius ? i : radius + E + (i - radius);
    sq[slot(at)] = (g >= 0 && g < n) ? square(x[g]) : 0.f;
  }
  __syncthreads();
  if (e >= n) return;

  alignas(16) T yv[V];
  int ch = (int)(e % c);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int at = radius + tid * V + v;
    float sum = 0.f;
    for (int off = -radius; off <= radius; ++off) {
      const int cc = ch + off;
      if (cc >= 0 && cc < c) sum = __fadd_rn(sum, sq[slot(at + off)]);
    }
    const float scale = __fadd_rn(k, __fmul_rn(alpha_over_n, sum));
    yv[v] = narrow<T>(__fmul_rn(widen(xv[v]), neg_pow(scale, beta, mode)));
    ch = ch + 1 == c ? 0 : ch + 1;
  }
  if (e + V <= n) {
    *reinterpret_cast<uint4*>(out + e) = *reinterpret_cast<const uint4*>(yv);
  } else {
    for (int v = 0; v < V && e + v < n; ++v) out[e + v] = yv[v];
  }
}

template <typename T>
int launch(const void* x, void* out, long long n, int c, int radius,
           float alpha_over_n, float k, float beta, int mode,
           cudaStream_t stream) {
  constexpr int E = kThreads * (16 / sizeof(T));
  const int n_slots = E + 2 * radius;
  const size_t smem = (size_t)(n_slots + n_slots / 32 + 1) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + E - 1) / E;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  lrn_fused_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, c, radius,
      alpha_over_n, k, beta, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x and out must be 16-byte aligned.
extern "C" int lrn_fused_launch(const void* x, void* out, long long n, int c,
                                int radius, float alpha_over_n, float k,
                                float beta, int mode, int dtype,
                                cudaStream_t stream) {
  if (n == 0) return 0;
  if (c <= 0 || radius < 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 0)
    return launch<float>(x, out, n, c, radius, alpha_over_n, k, beta, mode,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, out, n, c, radius, alpha_over_n, k, beta,
                                 mode, stream);
  return (int)cudaErrorInvalidValue;
}
