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
// 297 MB (0.089 ms at 3.35 TB/s) and LRN2 191 MB (0.057 ms). The work a
// byte is what a design has to keep down: at 4 warp instructions a clock an
// SM and 1.75 GHz the card executes about 35 instructions for an element
// of bf16 in the time it moves it.
//
// Design (the register kernel, window radius 1 to 3, rows that are whole
// 16-byte vectors):
// - the window stays in registers. A warp owns 4 consecutive runs of 32
//   vectors (512 bytes each); a lane loads its 4 vectors up front (4
//   independent 16-byte loads, `ld.global.nc.L1::no_allocate`), squares
//   them in x's dtype (bf16 two to a register) and takes the radius
//   neighbours on either side from the adjacent lanes' registers by
//   shuffle; lane 0 and lane 31 take them from lane 31 and lane 0 of the
//   warp's neighbouring run. Only the two ends of a warp's span read their
//   neighbour from global memory, and only where it lies in the same row;
// - a vector never crosses a channel edge (C is a multiple of its 8 or 4
//   elements), so masking the edge is two selects a vector: the halo of a
//   row's first and last vector is zero. The window sum is then
//   (((sq[c-r] + ...) + sq[c]) + ...) + sq[c+r] with `__fadd_rn`, the same
//   adds in the same order as the general kernel and the plain version;
// - the radius and the power's composition are template parameters: the
//   window unrolls and the power is straight-line code;
// - no shared memory, no barrier, 32-bit indices, `st.global.cs` stores.
// The general kernel (any other radius, rows that are no whole vectors,
// 2^31 elements or more) is the first design: a block of 256 threads owns a
// run of 256 x 16 bytes of the flattened tensor; each thread loads its 16
// bytes, writes their squares (as floats) to shared memory beside an
// r-element halo on either side, and after one barrier sums each element's
// window from shared memory, masking the neighbours that lie across a
// channel edge. Shared memory is indexed with one word of skew every 32
// (slot(i) = i + i / 32) against bank conflicts.
// Which kernel runs comes from ops/cuda/_plan.py `plan_lrn`; each has a
// launcher of its own, which only validates.

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

// ---- the register kernel ---------------------------------------------------

constexpr int kVectors = 4;  // 16-byte vectors a thread

template <int MODE>
__device__ __forceinline__ float neg_pow_t(float scale, float beta) {
  if constexpr (MODE == 0) {
    const float r = rsqrtf(scale);
    return __fmul_rn(r, sqrtf(r));
  } else if constexpr (MODE == 1) {
    return rsqrtf(scale);
  } else if constexpr (MODE == 2) {
    return __fdiv_rn(1.0f, scale);
  } else {
    return powf(scale, -beta);
  }
}

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// A 16-byte vector as 4 words: 2 bf16 or 1 float to a word.
template <typename T>
struct Words;
template <>
struct Words<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  // x * x of both halves, each rounded to bf16
  static __device__ __forceinline__ uint32_t square(uint32_t w) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
    const __nv_bfloat162 q = __hmul2(v, v);
    return *reinterpret_cast<const uint32_t*>(&q);
  }
  // element e of the words at w, widened
  static __device__ __forceinline__ float at(const uint32_t* w, int e) {
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  }
  static __device__ __forceinline__ void put(uint32_t* w, int e, float lo,
                                             float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    w[e >> 1] = *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <>
struct Words<float> {
  static constexpr int kPerWord = 1;
  static __device__ __forceinline__ uint32_t square(uint32_t w) {
    const float v = __uint_as_float(w);
    return __float_as_uint(__fmul_rn(v, v));
  }
  static __device__ __forceinline__ float at(const uint32_t* w, int e) {
    return __uint_as_float(w[e]);
  }
  static __device__ __forceinline__ void put(uint32_t* w, int e, float lo,
                                             float hi) {
    w[e] = __float_as_uint(lo);
    w[e + 1] = __float_as_uint(hi);
  }
};

// nv vectors in rows of cv vectors; step = 32 % cv
template <typename T, int RADIUS, int MODE>
__global__ void __launch_bounds__(kThreads)
lrn_window_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                  unsigned nv, unsigned cv, unsigned step, float alpha_over_n,
                  float k, float beta) {
  using W = Words<T>;
  constexpr int V = 4 * W::kPerWord;                        // elements
  constexpr int HW = (RADIUS + W::kPerWord - 1) / W::kPerWord;  // halo words
  constexpr unsigned kFull = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31;
  const unsigned g0 =
      (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * (kVectors * 32) +
      lane;

  uint32_t xw[kVectors][4];
  unsigned pos[kVectors];  // the vector's place in its row
#pragma unroll
  for (int j = 0; j < kVectors; ++j) {
    const unsigned g = g0 + 32 * j;
    const uint4 v = g < nv ? ld_stream(x + g) : make_uint4(0, 0, 0, 0);
    xw[j][0] = v.x, xw[j][1] = v.y, xw[j][2] = v.z, xw[j][3] = v.w;
  }
  pos[0] = g0 % cv;
#pragma unroll
  for (int j = 1; j < kVectors; ++j) {
    pos[j] = pos[j - 1] + step;
    if (pos[j] >= cv) pos[j] -= cv;
  }
  // the neighbours of the warp's span, where they lie in the same row
  uint32_t ql[HW], qr[HW];
#pragma unroll
  for (int i = 0; i < HW; ++i) ql[i] = qr[i] = 0;
  if (lane == 0 && pos[0] != 0 && g0 < nv) {
    const uint4 v = ld_stream(x + g0 - 1);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < HW; ++i) ql[i] = W::square(w[4 - HW + i]);
  }
  if (lane == 31 && pos[kVectors - 1] != cv - 1 &&
      g0 + 32 * (kVectors - 1) + 1 < nv) {
    const uint4 v = ld_stream(x + g0 + 32 * (kVectors - 1) + 1);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < HW; ++i) qr[i] = W::square(w[i]);
  }
  uint32_t q[kVectors][4];
#pragma unroll
  for (int j = 0; j < kVectors; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) q[j][i] = W::square(xw[j][i]);

#pragma unroll
  for (int j = 0; j < kVectors; ++j) {
    // squares of the window: [RADIUS left | V own | RADIUS right]
    uint32_t hl[HW], hr[HW];
#pragma unroll
    for (int i = 0; i < HW; ++i) {
      const uint32_t up = __shfl_up_sync(kFull, q[j][4 - HW + i], 1);
      const uint32_t down = __shfl_down_sync(kFull, q[j][i], 1);
      const uint32_t before =
          j > 0 ? __shfl_sync(kFull, q[j > 0 ? j - 1 : 0][4 - HW + i], 31)
                : ql[i];
      const uint32_t after =
          j < kVectors - 1
              ? __shfl_sync(kFull, q[j < kVectors - 1 ? j + 1 : j][i], 0)
              : qr[i];
      hl[i] = pos[j] == 0 ? 0u : lane == 0 ? before : up;
      hr[i] = pos[j] == cv - 1 ? 0u : lane == 31 ? after : down;
    }
    float ext[V + 2 * RADIUS];
#pragma unroll
    for (int i = 0; i < RADIUS; ++i) {
      // element V - RADIUS + i of the vector before, of which hl holds the
      // last HW words; element i of the vector after
      ext[i] = W::at(hl, V - RADIUS + i - (4 - HW) * W::kPerWord);
      ext[RADIUS + V + i] = W::at(hr, i);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) ext[RADIUS + v] = W::at(q[j], v);

    uint32_t yw[4];
    float y[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float sum = ext[v];
#pragma unroll
      for (int t = 1; t <= 2 * RADIUS; ++t) sum = __fadd_rn(sum, ext[v + t]);
      const float scale = __fadd_rn(k, __fmul_rn(alpha_over_n, sum));
      y[v] = __fmul_rn(W::at(xw[j], v), neg_pow_t<MODE>(scale, beta));
    }
#pragma unroll
    for (int v = 0; v < V; v += 2) W::put(yw, v, y[v], y[v + 1]);
    const unsigned g = g0 + 32 * j;
    if (g < nv) __stcs(out + g, make_uint4(yw[0], yw[1], yw[2], yw[3]));
  }
}

template <typename T, int RADIUS>
int launch_window_mode(const void* x, void* out, long long n, int c,
                       float alpha_over_n, float k, float beta, int mode,
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (c % V != 0 || n % V != 0 || n >= 0x80000000LL)
    return (int)cudaErrorInvalidValue;
  const unsigned nv = (unsigned)(n / V), cv = (unsigned)(c / V);
  const unsigned per_block = kThreads * kVectors;
  const dim3 grid((nv + per_block - 1) / per_block);
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* ov = static_cast<uint4*>(out);
  switch (mode) {
    case 0:
      lrn_window_kernel<T, RADIUS, 0><<<grid, kThreads, 0, stream>>>(
          xv, ov, nv, cv, 32 % cv, alpha_over_n, k, beta);
      break;
    case 1:
      lrn_window_kernel<T, RADIUS, 1><<<grid, kThreads, 0, stream>>>(
          xv, ov, nv, cv, 32 % cv, alpha_over_n, k, beta);
      break;
    case 2:
      lrn_window_kernel<T, RADIUS, 2><<<grid, kThreads, 0, stream>>>(
          xv, ov, nv, cv, 32 % cv, alpha_over_n, k, beta);
      break;
    default:
      lrn_window_kernel<T, RADIUS, 3><<<grid, kThreads, 0, stream>>>(
          xv, ov, nv, cv, 32 % cv, alpha_over_n, k, beta);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window(const void* x, void* out, long long n, int c, int radius,
                  float alpha_over_n, float k, float beta, int mode,
                  cudaStream_t stream) {
  switch (radius) {
    case 1:
      return launch_window_mode<T, 1>(x, out, n, c, alpha_over_n, k, beta,
                                      mode, stream);
    case 2:
      return launch_window_mode<T, 2>(x, out, n, c, alpha_over_n, k, beta,
                                      mode, stream);
    case 3:
      return launch_window_mode<T, 3>(x, out, n, c, alpha_over_n, k, beta,
                                      mode, stream);
    default:
      return (int)cudaErrorInvalidValue;
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

int check(const void* x, const void* out, int c, int radius, int dtype) {
  if (c <= 0 || radius < 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x and out must be 16-byte aligned. Which of
// the two launchers runs comes from the wrapper's plan; each kernel is
// counted under its own.

// The register kernel: radius 1 to 3, c a multiple of the 4 or 8 elements of
// a vector, n under 2^31.
extern "C" int lrn_fused_launch(const void* x, void* out, long long n, int c,
                                int radius, float alpha_over_n, float k,
                                float beta, int mode, int dtype,
                                cudaStream_t stream) {
  if (n == 0) return 0;
  if (const int e = check(x, out, c, radius, dtype)) return e;
  return dtype == 0 ? launch_window<float>(x, out, n, c, radius, alpha_over_n,
                                           k, beta, mode, stream)
                    : launch_window<__nv_bfloat16>(x, out, n, c, radius,
                                                   alpha_over_n, k, beta,
                                                   mode, stream);
}

// The general kernel: any radius whose window fits 48 KB of shared memory,
// any c and n.
extern "C" int lrn_fused_general_launch(const void* x, void* out, long long n,
                                        int c, int radius, float alpha_over_n,
                                        float k, float beta, int mode,
                                        int dtype, cudaStream_t stream) {
  if (n == 0) return 0;
  if (const int e = check(x, out, c, radius, dtype)) return e;
  return dtype == 0 ? launch<float>(x, out, n, c, radius, alpha_over_n, k,
                                    beta, mode, stream)
                    : launch<__nv_bfloat16>(x, out, n, c, radius,
                                            alpha_over_n, k, beta, mode,
                                            stream);
}
