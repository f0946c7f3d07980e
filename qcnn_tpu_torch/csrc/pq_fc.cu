// pq_fc: PQ FC as a gather-accumulate over an inner-product LUT, tiled over
// the batch, for Hopper (sm_90a).
//
// Replaces qcnn_tpu/ops/pallas/pq_fc.py `_pq_fc_pallas` (the pallas_call at
// :81, `_kernel`), reached there by `pq_fc_pallas`, strategy "pallas".
//
// Computes  out[b, o] = bias[o] + sum_s LUT[b, s, A[o, s]]
// with LUT (B, S, K) float32 built outside the kernel (ops/lut.build_lut,
// as the JAX entry builds it outside its kernel), A (Cout, S) uint8 in its
// natural layout, bias and out float32. Sums accumulate in float32, in
// order of s.
//
// Bound: at AlexNet fc6 B=256 the LUT (75.5 MB) and the ids (9.4 MB) take
// 0.025 ms to read and the 2.4e9 float32 adds 0.036 ms: operations, by a
// little. What the kernel actually pays is one shared-memory load per add.
//
// Design: the batched counterpart of pq_lut_gather, which reads A once per
// batch row. Here a block owns 8 batch rows x 256 outputs, one output per
// thread, and walks S in chunks. Each chunk's ids (256 outputs x chunk
// bytes, in A's own layout, copied with 16-byte loads where A's rows allow)
// and the 8 rows' LUT chunk (8 x chunk x K floats, at most 32 KB, 16-byte
// loads where aligned: the fc6 LUT row is 295 KB and does not fit whole) are
// staged in shared memory once. A thread then reads its output's ids 4 at a
// time, and each id serves all 8 rows. The id rows are padded to an odd
// number of words, so the 32 lanes' reads fall in distinct banks; for
// K <= 32 the K floats of one sub-space sit in distinct banks too, so the
// gathers of a warp do not conflict.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBT = 8;           // batch rows per block
constexpr int kCT = 256;         // outputs per block, one per thread
constexpr int kThreads = kCT;
constexpr int kLutFloats = 8192;   // the LUT chunk of all 8 rows (32 KB)
constexpr int kMaxChunk = 64;      // sub-spaces a chunk

// bytes between two outputs' staged ids: a multiple of 4, and an odd
// number of words for the chunks AlexNet uses (32, 64)
__host__ __device__ inline int id_pitch(int chunk) {
  return (chunk + 3) / 4 * 4 + 4;
}

__global__ void __launch_bounds__(kThreads)
pq_fc_kernel(const float* __restrict__ lut, const uint8_t* __restrict__ asmt,
             const float* __restrict__ bias, float* __restrict__ out, int nb,
             int s, int k, int cout, int chunk, bool lut_vec, bool id_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut_s = reinterpret_cast<float*>(smem);  // [kBT][chunk * k]
  uint8_t* ids_s = smem + kBT * chunk * k * 4;    // [kCT][pitch]

  const int b0 = blockIdx.y * kBT;
  const int o0 = blockIdx.x * kCT;
  const int tid = threadIdx.x;
  const int nrows = min(kBT, nb - b0);
  const int row_span = chunk * k;
  const int pitch = id_pitch(chunk);

  float acc[kBT];
#pragma unroll
  for (int r = 0; r < kBT; ++r) acc[r] = 0.f;

  for (int s0 = 0; s0 < s; s0 += chunk) {
    const int ns = min(chunk, s - s0);
    const int span = ns * k;
    for (int r = 0; r < nrows; ++r) {
      const float* src = lut + ((long long)(b0 + r) * s + s0) * k;
      float* dst = lut_s + r * row_span;
      if (lut_vec) {
        for (int i = tid; i < span / 4; i += kThreads)
          reinterpret_cast<float4*>(dst)[i] =
              __ldg(reinterpret_cast<const float4*>(src) + i);
      } else {
        for (int i = tid; i < span; i += kThreads) dst[i] = __ldg(src + i);
      }
    }
    if (id_vec) {  // ns is a multiple of 16 and every row 16-byte aligned
      const int per = ns / 16;
      for (int i = tid; i < kCT * per; i += kThreads) {
        const int oo = i / per, q = i % per;
        const int o = o0 + oo;
        const uint4 v =
            o < cout ? __ldg(reinterpret_cast<const uint4*>(
                                 asmt + (long long)o * s + s0) + q)
                     : make_uint4(0, 0, 0, 0);
        uint32_t* dst =
            reinterpret_cast<uint32_t*>(ids_s + oo * pitch) + 4 * q;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
      for (int i = tid; i < kCT * ns; i += kThreads) {
        const int oo = i / ns, j = i % ns;
        const int o = o0 + oo;
        ids_s[oo * pitch + j] =
            o < cout ? __ldg(asmt + (long long)o * s + s0 + j) : 0;
      }
    }
    __syncthreads();
    const uint8_t* mine = ids_s + tid * pitch;
    int j = 0;
    for (; j + 4 <= ns; j += 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(mine + j);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* l = lut_s + (j + u) * k + ((w >> (8 * u)) & 0xff);
#pragma unroll
        for (int r = 0; r < kBT; ++r) acc[r] += l[r * row_span];
      }
    }
    for (; j < ns; ++j) {
      const float* l = lut_s + j * k + mine[j];
#pragma unroll
      for (int r = 0; r < kBT; ++r) acc[r] += l[r * row_span];
    }
    __syncthreads();
  }

  const int o = o0 + tid;
  if (o < cout) {
    const float bo = __ldg(bias + o);
    for (int r = 0; r < nrows; ++r)
      out[(long long)(b0 + r) * cout + o] = bo + acc[r];
  }
}

}  // namespace

extern "C" int pq_fc_launch(const void* lut, const void* asmt,
                            const void* bias, void* out, int nb, int s, int k,
                            int cout, cudaStream_t stream) {
  if (nb == 0 || cout == 0) return 0;
  if (k < 1 || k > 256) return (int)cudaErrorInvalidValue;
  const long long b_tiles = (nb + kBT - 1) / kBT;
  if (b_tiles > 65535) return (int)cudaErrorInvalidValue;
  int chunk = kLutFloats / (kBT * k);
  if (chunk > kMaxChunk) chunk = kMaxChunk;
  if (chunk < 1) chunk = 1;
  const int smem = kBT * chunk * k * 4 + kCT * id_pitch(chunk);
  static int attr_bytes = 0;  // the largest size set so far in this process
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_fc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  dim3 grid((cout + kCT - 1) / kCT, (unsigned)b_tiles);
  // 16-byte loads where every staged run starts 16-byte aligned
  const bool lut_vec = (long long)s * k % 4 == 0 && chunk * k % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(lut) % 16 == 0;
  const bool id_vec = s % 16 == 0 && chunk % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(asmt) % 16 == 0;
  pq_fc_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(asmt),
      static_cast<const float*>(bias), static_cast<float*>(out), nb, s, k,
      cout, chunk, lut_vec, id_vec);
  return (int)cudaGetLastError();
}
