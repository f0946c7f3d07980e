// epilogue_fused: the pointwise tail after a conv or FC product in one pass
// over memory, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the bias add, the
// activation and the residual add after each product to XLA. In the port
// they were torch's separate passes (ops/fc.emit's plain chain): the cast
// of a float32 product, the bias add (a broadcast operand, which torch's
// non-vectorized elementwise kernel takes), the residual add and the ReLU
// or GELU, each a read and a write of the activation.
//
// Computes, over a contiguous (M, C) product y, bf16 or float32:
//   t = bf16(y)                                   (exact for a bf16 y)
//   t = bf16(t + bf16(bias[c]))                   where a bias is given
//   t = bf16(t + residual)                        where a residual is given
//   t = isnan(t) ? t : fmaxf(t, 0)                for "relu"
//   t = bf16(t * 0.5f * (1 + erff(t * M_SQRT1_2))) for "gelu"
//   t = bf16(0.5f * t * (1 + tanhf(kBeta * (t + kKappa * t^3))))
//                                                 for "gelu_tanh"
// and writes t, bf16. Each step widens to float32 and rounds to nearest
// even, as torch's bf16 cast, add, clamp_min and exact or tanh gelu do, in
// their order: the output is the bits of the plain chain. Both GELUs are
// written as torch's own CUDA kernel writes them, so the compiler contracts
// them alike; nothing here is built with fast math.
//
// Bound: bytes. ResNet-50's stage-1 conv3 at B=256 (802,816 rows of 256,
// bf16 product, residual and output) moves 1.233 GB, 0.368 ms at 3.35
// TB/s; ViT-L/16's mlp1 at B=128 (73,856 rows of 4,096, bf16 product and
// output) 1.210 GB, 0.361 ms.
//
// Design:
// - a vector is 8 elements: 16 bytes of bf16 (one load), 32 of float32
//   (two); C is a multiple of 8, so a vector never crosses a row and its
//   8 bias values are contiguous;
// - a thread keeps 4 vectors in flight: it loads the products (and the
//   residuals) of all 4 before it computes any, with
//   `ld.global.nc.L1::no_allocate` (each byte is read once);
// - the bias goes through the read-only path (`__ldg`): C floats that
//   every row reads again stay in L1;
// - a grid-stride loop over a grid sized to the card's SMs (8 blocks of
//   256 threads an SM), 32-bit indices; the launcher splits a tensor of
//   2^30 vectors or more into whole rows of launches below it.
// The activation, the bias, the residual and the product's type are
// template parameters, so each form is straight-line code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // vectors a thread
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 8;       // elements a vector
constexpr unsigned kMaxVectors = 1u << 30;

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kGeluTanh = 3 };

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// the 8 elements of vector i, rounded to bf16 and widened
template <typename In>
struct Product;
template <>
struct Product<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const void* y, unsigned i) {
    w = ld_stream(static_cast<const uint4*>(y) + i);
  }
  __device__ __forceinline__ void widen(float* v) const {
    const uint32_t a[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[2 * e] = __uint_as_float(a[e] << 16);
      v[2 * e + 1] = __uint_as_float(a[e] & 0xffff0000u);
    }
  }
};
template <>
struct Product<float> {
  uint4 lo, hi;
  __device__ __forceinline__ void load(const void* y, unsigned i) {
    const uint4* p = static_cast<const uint4*>(y) + 2 * (size_t)i;
    lo = ld_stream(p);
    hi = ld_stream(p + 1);
  }
  __device__ __forceinline__ void widen(float* v) const {
    const uint32_t a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[e] = __bfloat162float(__float2bfloat16_rn(__uint_as_float(a[e])));
  }
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int ACT>
__device__ __forceinline__ float activate(float t) {
  if constexpr (ACT == kRelu) {
    return isnan(t) ? t : fmaxf(t, 0.0f);
  } else if constexpr (ACT == kGelu) {
    constexpr float kAlpha = 0.70710678118654752440;  // M_SQRT1_2
    return t * 0.5f * (1.0f + erff(t * kAlpha));
  } else if constexpr (ACT == kGeluTanh) {
    // torch's constants: M_SQRT2 * M_2_SQRTPI * 0.5 in double, to float
    constexpr float kBeta =
        1.41421356237309504880 * 1.12837916709551257390 * 0.5;
    constexpr float kKappa = 0.044715;
    const float cube = t * t * t;
    const float inner = kBeta * (t + kKappa * cube);
    return 0.5f * t * (1.0f + tanhf(inner));
  } else {
    return t;
  }
}

template <typename In, int ACT, bool BIAS, bool RES>
__global__ void __launch_bounds__(kThreads)
epilogue_fused_kernel(const void* __restrict__ y,
                      const float* __restrict__ bias,
                      const uint4* __restrict__ res, uint4* __restrict__ out,
                      unsigned nv, unsigned cv) {
  const unsigned stride = gridDim.x * kThreads * kInFlight;
  for (unsigned base = blockIdx.x * kThreads * kInFlight + threadIdx.x;
       base < nv; base += stride) {
    Product<In> p[kInFlight];
    uint4 r[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const unsigned i = base + j * kThreads;
      if (i < nv) {
        p[j].load(y, i);
        if constexpr (RES) r[j] = ld_stream(res + i);
      }
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const unsigned i = base + j * kThreads;
      if (i >= nv) break;
      float t[kVec];
      p[j].widen(t);
      if constexpr (BIAS) {
        const float4* b =
            reinterpret_cast<const float4*>(bias) + 2 * (i % cv);
        const float4 b0 = __ldg(b), b1 = __ldg(b + 1);
        const float bv[kVec] = {b0.x, b0.y, b0.z, b0.w,
                                b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          t[e] = round_bf16(t[e] + round_bf16(bv[e]));
      }
      if constexpr (RES) {
        const uint32_t a[4] = {r[j].x, r[j].y, r[j].z, r[j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          t[2 * e] = round_bf16(t[2 * e] + __uint_as_float(a[e] << 16));
          t[2 * e + 1] =
              round_bf16(t[2 * e + 1] + __uint_as_float(a[e] & 0xffff0000u));
        }
      }
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            activate<ACT>(t[2 * e]), activate<ACT>(t[2 * e + 1]));
        o[e] = *reinterpret_cast<const uint32_t*>(&v);
      }
      out[i] = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      return 132;
    count[dev] = n;
  }
  return count[dev];
}

template <typename In, int ACT, bool BIAS, bool RES>
void launch_form(const void* y, const float* bias, const void* res, void* out,
                 unsigned nv, unsigned cv, cudaStream_t stream) {
  const unsigned per_block = kThreads * kInFlight;
  const unsigned cap = (unsigned)sm_count() * kBlocksPerSm;
  unsigned blocks = (nv + per_block - 1) / per_block;
  if (blocks > cap) blocks = cap;
  epilogue_fused_kernel<In, ACT, BIAS, RES><<<blocks, kThreads, 0, stream>>>(
      y, bias, static_cast<const uint4*>(res), static_cast<uint4*>(out), nv,
      cv);
}

template <typename In, int ACT>
void launch_act(const void* y, const float* bias, const void* res, void* out,
                unsigned nv, unsigned cv, cudaStream_t stream) {
  if (bias && res)
    launch_form<In, ACT, true, true>(y, bias, res, out, nv, cv, stream);
  else if (bias)
    launch_form<In, ACT, true, false>(y, bias, res, out, nv, cv, stream);
  else if (res)
    launch_form<In, ACT, false, true>(y, bias, res, out, nv, cv, stream);
  else
    launch_form<In, ACT, false, false>(y, bias, res, out, nv, cv, stream);
}

template <typename In>
void launch_in(const void* y, const float* bias, const void* res, void* out,
               unsigned nv, unsigned cv, int act, cudaStream_t stream) {
  switch (act) {
    case kRelu:
      launch_act<In, kRelu>(y, bias, res, out, nv, cv, stream);
      break;
    case kGelu:
      launch_act<In, kGelu>(y, bias, res, out, nv, cv, stream);
      break;
    case kGeluTanh:
      launch_act<In, kGeluTanh>(y, bias, res, out, nv, cv, stream);
      break;
    default:
      launch_act<In, kNone>(y, bias, res, out, nv, cv, stream);
  }
}

}  // namespace

// y: n elements in rows of c (in_dtype 0: float32, 1: bf16); bias: c
// float32 or null; res: n bf16 or null; out: n bf16. act 0: none, 1: relu,
// 2: gelu (erf), 3: gelu_tanh. y, res and out 16-byte aligned, bias
// 16-byte aligned, c a multiple of 8. Returns a CUDA error code.
extern "C" int epilogue_fused_launch(const void* y, const void* bias,
                                     const void* res, void* out, long long n,
                                     int c, int in_dtype, int act,
                                     cudaStream_t stream) {
  if (n <= 0 || c <= 0 || c % kVec != 0 || n % c != 0 || act < 0 || act > 3 ||
      in_dtype < 0 || in_dtype > 1)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)y | (uintptr_t)bias | (uintptr_t)res |
                          (uintptr_t)out;
  if (align % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const long long cv = c / kVec;
  const long long rows = n / c;
  // whole rows a launch, below 2^30 vectors
  const long long rows_per = kMaxVectors / cv > 0 ? kMaxVectors / cv : 1;
  const size_t in_size = in_dtype == 0 ? 4 : 2;
  for (long long r0 = 0; r0 < rows; r0 += rows_per) {
    const long long nr = rows - r0 < rows_per ? rows - r0 : rows_per;
    const long long e0 = r0 * c;
    const unsigned nv = (unsigned)(nr * cv);
    const void* yc = static_cast<const char*>(y) + e0 * in_size;
    const void* rc = res ? static_cast<const char*>(res) + e0 * 2 : nullptr;
    void* oc = static_cast<char*>(out) + e0 * 2;
    const float* b = static_cast<const float*>(bias);
    if (in_dtype == 0)
      launch_in<float>(yc, b, rc, oc, nv, (unsigned)cv, act, stream);
    else
      launch_in<__nv_bfloat16>(yc, b, rc, oc, nv, (unsigned)cv, act, stream);
  }
  return (int)cudaGetLastError();
}
