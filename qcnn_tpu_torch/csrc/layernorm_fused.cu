// layernorm_fused: LayerNorm over the last axis of a bf16 tensor in one
// pass over memory, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves LayerNorm to XLA. In the
// port it was three of torch's passes (models/transformer.layernorm's float32
// form): the bf16 activation widened to a float32 copy, torch's float32
// LayerNorm, and the cast of its float32 output back to bf16, 20 bytes an
// element in all.
//
// Computes, over each row of C elements of a contiguous (rows, C) bf16 x:
//   mean = (sum of x) / C                          float32
//   var  = (sum of (x - mean)^2) / C               float32, biased
//   rstd = rsqrtf(var + eps)
//   y    = bf16(fmaf(scale[c], (x - mean) * rstd, shift[c]))
// with float32 scale and shift. Each bf16 element widens exactly; both sums
// run over the row held in registers (the second is no second read of
// memory), each thread's part in order and then a tree of warp shuffles; the
// result rounds once, to nearest even. This is the float32 form's
// arithmetic in torch's order (its kernel computes scale * (rstd * (x -
// mean)) + shift, which the compiler contracts to the same fma), with the
// statistics in two passes over registers where torch runs Welford's
// update: the two differ in the last float32 bits of the statistics, so an
// output may round to the neighbouring bf16 value (or, where the shift
// nearly cancels it, differ by the float32 rounding of its terms).
//
// Bound: bytes. One read of x and one write of y, 4 bytes an element (the
// scale and shift are C floats that every row reads again from cache):
// ViT-L/16's LayerNorm at B=128 (73,856 rows of 1,024) moves 302.5 MB,
// 0.0903 ms at 3.35 TB/s; Swin-L's stage 0 (1,179,648 rows of 192) 906.0
// MB, 0.270 ms.
//
// Design:
// - a vector is 8 elements, one 16-byte load or store; C is a multiple of
//   8, so a row is whole vectors;
// - a row belongs to a group of TPR lanes of one warp (8, 16 or 32, set by
//   C), each lane holding VPT of its vectors in registers; the group's sums
//   are butterfly shuffles within it;
// - each lane keeps ROWS rows in flight: it loads every vector of all of
//   them before it sums any, so that short rows still keep 48-64 bytes a
//   thread in flight (MaxViT's stage 0, C = 128: 4 rows of one vector a
//   lane);
// - x is read with `ld.global.nc.L1::no_allocate` (each byte once); the
//   scale and shift through the read-only path (`__ldg`), once a vector for
//   all of a lane's rows;
// - a warp takes 32 / TPR x ROWS consecutive rows an iteration and strides
//   over the tensor; the grid is one wave of resident blocks on the card's
//   SMs (the occupancy the compiled instance allows), fewer for a small
//   tensor;
// - the widths of the port's models (128, 192, 256, 384, 512, 768, 1024,
//   1536, 3072) are instances with every size a constant, their lanes a
//   row, rows a lane and register caps (MINB) the fastest of a sweep over
//   the three cells' shapes on an H100 (78-84 % of 3.35 TB/s at 73,728
//   rows and more); any other multiple of 8 up to kMaxC takes the general
//   instance, 16 vectors a lane of a whole warp with the row's width read
//   at run time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;       // elements a vector
constexpr int kMaxC = 4096;   // the general instance: 16 vectors x 32 lanes
constexpr int kGeneralVpt = kMaxC / kVec / 32;

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// element e (0..7) of a vector of 8 bf16, widened exactly
__device__ __forceinline__ float widen(const uint4& w, int e) {
  const uint32_t a = e < 2 ? w.x : e < 4 ? w.y : e < 6 ? w.z : w.w;
  return (e & 1) ? __uint_as_float(a & 0xffff0000u) : __uint_as_float(a << 16);
}

// the sum over the TPR lanes of this lane's group (aligned within the warp)
template <int TPR>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// EXACT: the row is VPT x TPR vectors; else cv (at most VPT x TPR) vectors
// read at run time, TPR = 32. MINB: the blocks an SM must hold (a cap on
// the registers a thread).
template <int VPT, int TPR, int ROWS, bool EXACT, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
layernorm_fused_kernel(const uint4* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       uint4* __restrict__ out, unsigned long long rows,
                       unsigned cv_arg, float eps) {
  constexpr int kGroups = 32 / TPR;          // rows a warp holds at once
  constexpr int kWarpRows = kGroups * ROWS;  // rows a warp takes a step
  const unsigned cv = EXACT ? VPT * TPR : cv_arg;
  const float c = (float)(cv * kVec);
  const int lane = threadIdx.x & 31;
  const int sub = lane % TPR;
  const int grp = lane / TPR;
  const unsigned long long warps = (unsigned long long)gridDim.x * kWarps;
  // the loop's bound is the warp's, so every lane reaches every shuffle
  for (unsigned long long base =
           ((unsigned long long)blockIdx.x * kWarps + threadIdx.x / 32) *
           kWarpRows;
       base < rows; base += warps * kWarpRows) {
    uint4 v[ROWS][VPT];
    bool ok[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const unsigned long long row = base + r * kGroups + grp;
      ok[r] = row < rows;
      const uint4* xr = x + row * cv;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const unsigned idx = j * TPR + sub;
        v[r][j] = (ok[r] && (EXACT || idx < cv)) ? ld_stream(xr + idx)
                                                 : make_uint4(0, 0, 0, 0);
      }
    }
    float mean[ROWS], rstd[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < VPT; ++j)
#pragma unroll
        for (int e = 0; e < kVec; ++e) s += widen(v[r][j], e);
      mean[r] = group_sum<TPR>(s) / c;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (!EXACT && j * TPR + sub >= cv) continue;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = widen(v[r][j], e) - mean[r];
          q += d * d;
        }
      }
      rstd[r] = rsqrtf(group_sum<TPR>(q) / c + eps);
    }
    // no shuffle below: lanes of rows past the end may leave
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const unsigned idx = j * TPR + sub;
      if (!EXACT && idx >= cv) break;
      const float4* g = reinterpret_cast<const float4*>(scale) + 2 * idx;
      const float4* b = reinterpret_cast<const float4*>(shift) + 2 * idx;
      const float4 g0 = __ldg(g), g1 = __ldg(g + 1);
      const float4 b0 = __ldg(b), b1 = __ldg(b + 1);
      const float gv[kVec] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bv[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (!ok[r]) continue;
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y0 = fmaf(
              gv[2 * e], (widen(v[r][j], 2 * e) - mean[r]) * rstd[r],
              bv[2 * e]);
          const float y1 = fmaf(
              gv[2 * e + 1], (widen(v[r][j], 2 * e + 1) - mean[r]) * rstd[r],
              bv[2 * e + 1]);
          const __nv_bfloat162 p = __floats2bfloat162_rn(y0, y1);
          o[e] = *reinterpret_cast<const uint32_t*>(&p);
        }
        const unsigned long long row = base + r * kGroups + grp;
        out[row * cv + idx] = make_uint4(o[0], o[1], o[2], o[3]);
      }
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

template <int VPT, int TPR, int ROWS, bool EXACT, int MINB = 1>
int launch(const void* x, const float* scale, const float* shift, void* out,
           unsigned long long rows, unsigned cv, float eps,
           cudaStream_t stream) {
  auto kernel = layernorm_fused_kernel<VPT, TPR, ROWS, EXACT, MINB>;
  static int per_sm = 0;  // resident blocks an SM, from the compiled kernel
  if (per_sm == 0) {
    int n = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm = n > 0 ? n : 1;
  }
  constexpr unsigned long long kBlockRows =
      (unsigned long long)kWarps * (32 / TPR) * ROWS;
  const unsigned long long wave = (unsigned long long)sm_count() * per_sm;
  unsigned long long blocks = (rows + kBlockRows - 1) / kBlockRows;
  if (blocks > wave) blocks = wave;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), scale, shift, static_cast<uint4*>(out),
      rows, cv, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: rows x c bf16, contiguous; scale, shift: c float32. All four
// 16-byte aligned, c a multiple of 8 and at most 4096. Returns a CUDA error
// code.
extern "C" int layernorm_fused_launch(const void* x, const void* scale,
                                      const void* shift, void* out,
                                      long long rows, int c, float eps,
                                      cudaStream_t stream) {
  if (rows <= 0 || c <= 0 || c % kVec != 0 || c > kMaxC)
    return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)scale |
                          (uintptr_t)shift | (uintptr_t)out;
  if (align % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const float* g = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(shift);
  const unsigned long long n = (unsigned long long)rows;
  const unsigned cv = (unsigned)(c / kVec);
  switch (c) {
    case 128:
      return launch<1, 16, 4, true>(x, g, b, out, n, cv, eps, stream);
    case 192:
      return launch<3, 8, 1, true, 2>(x, g, b, out, n, cv, eps, stream);
    case 256:
      return launch<2, 16, 2, true>(x, g, b, out, n, cv, eps, stream);
    case 384:
      return launch<3, 16, 2, true>(x, g, b, out, n, cv, eps, stream);
    case 512:
      return launch<2, 32, 1, true>(x, g, b, out, n, cv, eps, stream);
    case 768:
      return launch<3, 32, 2, true>(x, g, b, out, n, cv, eps, stream);
    case 1024:
      return launch<4, 32, 1, true>(x, g, b, out, n, cv, eps, stream);
    case 1536:
      return launch<6, 32, 1, true, 2>(x, g, b, out, n, cv, eps, stream);
    case 3072:
      return launch<12, 32, 1, true>(x, g, b, out, n, cv, eps, stream);
    default:
      return launch<kGeneralVpt, 32, 1, false>(x, g, b, out, n, cv, eps,
                                               stream);
  }
}
