// pq_lut_gather: PQ FC as a gather-accumulate over an inner-product LUT,
// for the small batches of the serving path, for Hopper (sm_90a).
//
// Replaces qcnn_tpu/ops/pallas/pq_lut_gather.py `_lut_gather` (the
// pallas_call at :97, `_kernel`), reached there by `pq_fc_lut_gather`.
//
// Computes  out[b, o] = bias[o] + sum_s LUT[b, s, A[o, s]]
// with LUT (B, S, K) float32 built outside the kernel (ops/lut.build_lut,
// as the JAX package builds it outside its kernel), A (Cout, S) uint8 in
// its natural layout, bias and out float32. Sums accumulate in float32.
//
// Bound: bytes. At batch 1 or 2 the uint8 ids (Cout*S bytes: 9.4 MB for
// AlexNet fc6) are the stream, read once; the LUT rows (S*K*4 bytes each,
// 295 KB for fc6) and the adds are small beside them. By the data sheet
// fc6 is 0.003 ms, under the cost of launching a kernel at all: what the
// design goes after is the number of dependent round trips to memory
// between the launch and the last add.
//
// Design (the staged kernel):
// - a block owns an output tile, a range of S and 1, 2, 4 or 8 batch rows
//   (a template parameter; a larger batch walks tiles of 8). Its rows'
//   slices LUT[b, s0:s1, :] are contiguous runs and are copied whole into
//   shared memory with `cp.async`: no ring, the range is cut so that the
//   slices fit;
// - a thread owns one output. The 32 lanes of a warp sit at the same s, so
//   a gathered value is one `LDS.32` at [(s K + id) * 4]: for K <= 32 the
//   bank is the id, equal ids broadcast, and the loads are free of
//   conflicts. The ids go from global memory to registers as 16-byte
//   loads, 4 in flight and 4 more requested before the first are used,
//   and each is read once for all rows of the block;
// - a block has 8 warps over 32 to 256 outputs: where Cout is small the
//   warps share an output tile and each takes a sub-range of the block's
//   range (`groups`); their sums are added in sub-range order in shared
//   memory;
// - S is split across blockIdx.z until the grid fills the card. The
//   splits are added in split order, then the bias, so two launches give
//   the same bits. The partial sums go through a float32 workspace and a
//   reduce kernel that is launched programmatically dependent on the
//   gather: the gather says at its start that the reduce may be brought
//   onto the card, and the reduce's blocks wait (`griddepcontrol.wait`)
//   for the gather's stores, so the second launch costs no trip through
//   the front end after the first has drained. (A thread-block cluster
//   along S that adds the sums through distributed shared memory in one
//   launch was measured slower at every AlexNet layer and is not kept:
//   PERF.md.)
// Rows, outputs and splits come from ops/cuda/_plan.py `plan_lut_gather`;
// the launcher only validates them.
//
// The general kernel (S not a multiple of 16, K not a multiple of 4: rows
// of ids or LUT slices that do not start 16-byte aligned) gives a warp to
// each (b, o): the lanes walk the row of ids together, each gathers its
// LUT entry through L1/L2, and a shuffle tree adds the lanes. It has a
// launcher of its own, so the two kernels are counted apart.

#include "pq_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnit = 16;      // ids a 16-byte load
constexpr int kInFlight = 4;   // 16-byte id loads a thread starts together

// The two ends of a programmatic dependent launch: the reduce's blocks
// wait for the gather's stores, and the gather says at its start that the
// dependent grid may be brought onto the card.
__device__ __forceinline__ void dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void dependents_may_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// out[i] = (ws[0][i] + ws[1][i] + ...) + bias[i % cout], in that order
__global__ void lut_split_reduce_kernel(const float* __restrict__ ws,
                                        const float* __restrict__ bias,
                                        float* __restrict__ out, int n,
                                        int cout, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float bo = i < n ? __ldg(bias + i % cout) : 0.f;
  dependency_wait();
  if (i >= n) return;
  float acc = ws[i];
  for (int z = 1; z < splits; ++z) acc += ws[static_cast<long long>(z) * n + i];
  out[i] = acc + bo;
}

template <int R>
__global__ void __launch_bounds__(kThreads)
lut_gather_kernel(const float* __restrict__ lut,
                  const uint8_t* __restrict__ asmt,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int nb, int s, int k, int cout, int groups,
                  int units_per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wo = kWarps / groups;            // warps across the outputs
  const int ot = 32 * wo;                    // outputs of the block
  const int g = warp / wo;                   // this warp's sub-range
  const int oi = (warp - g * wo) * 32 + lane;
  const int o = blockIdx.x * ot + oi;
  const int b0 = blockIdx.y * R;
  const int nrows = min(R, nb - b0);
  const int units = s / kUnit;
  const int u_lo = blockIdx.z * units_per_split;
  const int n_units = min(units, u_lo + units_per_split) - u_lo;
  const int span = n_units * kUnit * k;      // floats of one row's slice
  float* part = reinterpret_cast<float*>(smem);    // [groups][R][ot]
  float* lut_s = part + kThreads * R;              // [R][span]

  const bool split = gridDim.z > 1;
  if (split) dependents_may_launch();
  for (int r = 0; r < nrows; ++r) {
    const float* src =
        lut + (static_cast<long long>(b0 + r) * s + u_lo * kUnit) * k;
    for (int i = tid; i < span / 4; i += kThreads)
      pq::cp_async16(pq::smem_u32(lut_s + r * span + 4 * i), src + 4 * i,
                     true);
  }

  // this warp's units of the block's range
  const int per_g = (n_units + groups - 1) / groups;
  const int g_lo = min(n_units, g * per_g);
  const bool active = o < cout;
  const int n = active ? min(n_units, g_lo + per_g) - g_lo : 0;
  const uint4* ap = reinterpret_cast<const uint4*>(
                        asmt + static_cast<long long>(active ? o : 0) * s) +
                    u_lo + g_lo;
  uint4 cur[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u)
    cur[u] = u < n ? __ldg(ap + u) : make_uint4(0, 0, 0, 0);
  pq::cp_async_wait_all();
  __syncthreads();

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const float* base = lut_s + g_lo * kUnit * k;
  for (int i0 = 0; i0 < n; i0 += kInFlight) {
    uint4 nxt[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      nxt[u] = i0 + kInFlight + u < n ? __ldg(ap + i0 + kInFlight + u)
                                      : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (i0 + u < n) {
        const float* l = base + (i0 + u) * kUnit * k;
        const uint32_t w[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
#pragma unroll
        for (int j = 0; j < kUnit; ++j) {
          const float* p = l + j * k + ((w[j / 4] >> (8 * (j % 4))) & 0xff);
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] += p[r * span];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) cur[u] = nxt[u];
  }

  // the block's sub-ranges, in order
  if (groups > 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[(g * R + r) * ot + oi] = acc[r];
    __syncthreads();
    if (g == 0) {
      for (int gg = 1; gg < groups; ++gg)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] += part[(gg * R + r) * ot + oi];
    }
  }

  if (g == 0 && active) {
    // one split: the final output; else split z's partial sums at
    // z * nb * cout of the workspace
    const float bo = split ? 0.f : __ldg(bias + o);
    float* dst = out + static_cast<long long>(blockIdx.z) * nb * cout;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nrows)
        dst[static_cast<long long>(b0 + r) * cout + o] = acc[r] + bo;
  }
}

__global__ void lut_gather_general_kernel(const float* __restrict__ lut,
                                          const uint8_t* __restrict__ asmt,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, int s,
                                          int k, int cout) {
  const int o = (int)((blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  if (o >= cout) return;  // uniform across the warp
  const uint8_t* a = asmt + (long long)o * s;
  const float* l = lut + (long long)b * s * k;
  float acc = 0.f;
#pragma unroll 4
  for (int j = lane; j < s; j += 32) {
    acc += __ldg(l + (long long)j * k + __ldg(a + j));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) out[(long long)b * cout + o] = __ldg(bias + o) + acc;
}

struct Args {
  const float* lut;
  const uint8_t* asmt;
  const float* bias;
  float* out;
  float* ws;
  int nb, s, k, cout, outputs, splits;
};

template <int R>
int launch(const Args& a, cudaStream_t stream) {
  const int units = a.s / kUnit;
  const int per_split = (units + a.splits - 1) / a.splits;
  if ((units + per_split - 1) / per_split != a.splits)
    return static_cast<int>(cudaErrorInvalidValue);  // an empty split
  const int groups = kThreads / a.outputs;
  const int out_tiles = (a.cout + a.outputs - 1) / a.outputs;
  const int b_tiles = (a.nb + R - 1) / R;
  const long long n = static_cast<long long>(a.nb) * a.cout;  // outputs
  if (b_tiles > 65535 || n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem =
      (static_cast<long long>(R) * per_split * kUnit * a.k + kThreads * R) * 4;
  if (smem > pq::kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_set = 0;  // per instantiation and process
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        lut_gather_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = static_cast<int>(smem);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(out_tiles, b_tiles, a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, lut_gather_kernel<R>, a.lut, a.asmt, a.bias,
      a.splits > 1 ? a.ws : a.out, a.nb, a.s, a.k, a.cout, groups, per_split);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return static_cast<int>(e);
  cudaLaunchConfig_t rcfg = {};
  rcfg.gridDim = dim3(static_cast<unsigned>((n + 255) / 256));
  rcfg.blockDim = dim3(256);
  rcfg.stream = stream;
  cudaLaunchAttribute rattr[1];
  rattr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  rattr[0].val.programmaticStreamSerializationAllowed = 1;
  rcfg.attrs = rattr;
  rcfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&rcfg, lut_split_reduce_kernel,
                         static_cast<const float*>(a.ws), a.bias, a.out,
                         static_cast<int>(n), a.cout, a.splits);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// The staged kernel under the wrapper's plan: `rows` (batch rows a block: 1,
// 2, 4 or 8), `outputs` (32, 64, 128 or 256 a block) and `splits` (blocks
// along S). S is a multiple of 16, K of 4, `lut` and `asmt` are 16-byte
// aligned, and `ws` holds splits x nb x cout floats when splits > 1.
extern "C" int pq_lut_gather_launch(const void* lut, const void* asmt,
                                    const void* bias, void* out, void* ws,
                                    int nb, int s, int k, int cout, int rows,
                                    int outputs, int splits,
                                    cudaStream_t stream) {
  if (nb == 0 || cout == 0) return 0;
  if (s < kUnit || s % kUnit != 0 || k < 4 || k % 4 != 0 ||
      !pq::aligned16(lut) || !pq::aligned16(asmt) ||
      (outputs != 32 && outputs != 64 && outputs != 128 && outputs != 256) ||
      splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(lut),
               static_cast<const uint8_t*>(asmt),
               static_cast<const float*>(bias),
               static_cast<float*>(out),
               static_cast<float*>(ws),
               nb, s, k, cout, outputs, splits};
  switch (rows) {
    case 1:
      return launch<1>(a, stream);
    case 2:
      return launch<2>(a, stream);
    case 4:
      return launch<4>(a, stream);
    case 8:
      return launch<8>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The general kernel: a warp a (row, output), any S and K.
extern "C" int pq_lut_gather_general_launch(const void* lut, const void* asmt,
                                            const void* bias, void* out,
                                            int nb, int s, int k, int cout,
                                            cudaStream_t stream) {
  if (nb == 0 || cout == 0) return 0;
  if (nb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((cout + kWarps - 1) / kWarps, nb);
  lut_gather_general_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(asmt),
      static_cast<const float*>(bias), static_cast<float*>(out), s, k, cout);
  return static_cast<int>(cudaGetLastError());
}
