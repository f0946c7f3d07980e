// pq_lut_gather: PQ FC as a gather-accumulate over an inner-product LUT,
// for Hopper (sm_90a).
//
// Replaces qcnn_tpu/ops/pallas/pq_lut_gather.py `_lut_gather` (the
// pallas_call at :97, `_kernel`), reached there by `pq_fc_lut_gather`.
//
// Computes  out[b, o] = bias[o] + sum_s LUT[b, s, A[o, s]]
// with LUT (B, S, K) float32 built outside the kernel (ops/lut.build_lut,
// as the JAX package builds it outside its kernel), A (Cout, S) uint8 in
// its natural layout, bias and out float32. Sums accumulate in float32.
//
// Bound: bytes. At batch 1 the uint8 ids (Cout*S bytes: 9.4 MB for AlexNet
// fc6) are the stream; the LUT row (S*K*4 bytes, 295 KB for fc6) is read
// many times but stays in L2, and the adds are few.
//
// Design: one warp per (b, o). The 32 lanes walk the row A[o, :] together,
// so each warp load of ids is 32 consecutive bytes (no transposed copy of
// A is needed), and each lane gathers its LUT entry, which L1/L2 serve.
// A shuffle tree sums the lanes. The LUT is larger than shared memory at
// fc6, so it is left to the caches.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void pq_lut_gather_kernel(const float* __restrict__ lut,
                                     const uint8_t* __restrict__ asmt,
                                     const float* __restrict__ bias,
                                     float* __restrict__ out, int s, int k,
                                     int cout) {
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

extern "C" int pq_lut_gather_launch(const void* lut, const void* asmt,
                                    const void* bias, void* out, int b,
                                    int s, int k, int cout,
                                    cudaStream_t stream) {
  if (b == 0 || cout == 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 warps, one output each
  dim3 grid((cout + 7) / 8, b);
  pq_lut_gather_kernel<<<grid, threads, 0, stream>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(asmt),
      static_cast<const float*>(bias), static_cast<float*>(out), s, k, cout);
  return (int)cudaGetLastError();
}
