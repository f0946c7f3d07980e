// pq_decode: PQ weight decode for Hopper (sm_90a).
//
// Replaces qcnn_tpu/ops/pallas/pq_decode.py `_decode_sdn` (the pallas_calls
// at :132 `_decode_kernel_sdn` and :146 `_decode_kernel`), reached there by
// `decode_fc_weight_gather` and `decode_conv_kernel_gather`.
//
// Computes, row-major (N, C) with C <= S*D:
//     out[n, c] = cb[c / D, A[n, c / D], c % D]
// N = Cout*kh*kw gives a conv kernel in OHWI order (the layout the
// convolution takes as a channels_last OIHW weight); N = Cout gives an fc
// weight as (Cout, Cin). Columns past C (the overhang of the last
// sub-space) are not written.
//
// Bound: bytes. It reads N*S id bytes and the codebook (at most 590 KB for
// AlexNet, so it stays in L2) and writes N*C elements; there is no
// arithmetic. The output dominates.
//
// Design: one thread per output element, consecutive threads on
// consecutive columns, so every warp's stores are one contiguous run and
// the D neighbours that share an id read one cached byte. The decode is a
// bit copy (elements move as 16- or 32-bit words), so the result is
// bit-identical to the plain gather. Grid-stride loop over N*C.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__global__ void pq_decode_kernel(const T* __restrict__ cb,
                                 const uint8_t* __restrict__ asmt,
                                 T* __restrict__ out, long long total,
                                 int c_len, int s, int k, int d) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long n = i / c_len;
    const int c = (int)(i - n * c_len);
    const int sub = c / d;
    const int code = __ldg(asmt + n * s + sub);
    out[i] = __ldg(cb + ((long long)sub * k + code) * d + (c - sub * d));
  }
}

// elem_bytes: 4 for float32 codebooks, 2 for bfloat16 (copied as bits).
extern "C" int pq_decode_launch(const void* cb, const void* asmt, void* out,
                                int n, int s, int k, int d, int c_len,
                                int elem_bytes, cudaStream_t stream) {
  const long long total = (long long)n * c_len;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const uint8_t* a = static_cast<const uint8_t*>(asmt);
  if (elem_bytes == 4) {
    pq_decode_kernel<uint32_t><<<(int)blocks, threads, 0, stream>>>(
        static_cast<const uint32_t*>(cb), a, static_cast<uint32_t*>(out),
        total, c_len, s, k, d);
  } else if (elem_bytes == 2) {
    pq_decode_kernel<uint16_t><<<(int)blocks, threads, 0, stream>>>(
        static_cast<const uint16_t*>(cb), a, static_cast<uint16_t*>(out),
        total, c_len, s, k, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
