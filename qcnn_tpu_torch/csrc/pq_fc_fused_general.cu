// pq_fc_fused_general: the general path of the PQ FC decode-GEMM, for the
// shapes the wgmma kernel of pq_fc_fused.cu does not take (Cin not a
// multiple of 64 or short of S*D, D outside {1, 2, 4}).
//
// Same function as qcnn_tpu/ops/pallas/pq_fc_fused.py `_pq_fc_fused`:
//   out[b, o] = bias[o] + sum_f x[b, f] * W[f, o]
// with W[f, o] = cb[f / D, A[o, f / D], f % D] (f < Cin <= S*D), x and cb
// in bfloat16, products accumulated in float32, bias and out float32. The
// decoded weight never reaches device memory. The wrapper picks this kernel
// by the shape alone, never after a failure of the other.
//
// It takes any Cin, D, K <= 128 and ragged B and Cout, at the price of
// speed: a 128x64 output tile per block of 8 warps walks the contraction in
// 64-feature chunks, and each chunk runs its three steps in sequence
// between block-wide barriers.
// - The next chunk's x tile, uint8 ids and codebook span (the codewords of
//   the chunk's sub-spaces; 16-byte loads where the shapes allow) are
//   loaded into registers while the current chunk is decoded and
//   multiplied, then stored to shared memory.
// - Each thread decodes whole codewords: for one output column and one
//   sub-space it reads the id and copies the D codeword values, all from
//   shared memory, into the 64x64 bf16 weight tile. (A codebook span too
//   large or misaligned to stage is read from L1/L2 instead.)
// - Each warp runs 2x2 WMMA 16x16x16 bf16 products into float32 fragments.
// Everything past Cin, B and Cout is zero. The epilogue goes through
// shared memory, 64 rows at a time, to mask the ragged edge and add the
// bias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kBT = 128;         // batch rows per block
constexpr int kOT = 64;          // output columns per block
constexpr int kKC = 64;          // contraction features per chunk
constexpr int kThreads = 256;    // 8 warps: 4 row bands x 2 column bands
constexpr int kMaxSub = kKC;     // sub-spaces one chunk can touch (D >= 1)
constexpr int kIdLD = kMaxSub + 4;  // odd word pitch: no bank conflicts
constexpr int kXLD = kKC + 8;    // shared-memory row pitches (elements):
constexpr int kWLD = kOT + 8;    // multiples of 8 as WMMA requires, padded
constexpr int kCLD = kOT + 4;    // to spread the banks
constexpr int kXVec = kBT * kKC / 8 / kThreads;   // 16-byte x loads a thread
constexpr int kIdLoads = kOT * kMaxSub / kThreads;  // id bytes a thread
constexpr int kCbMax = 8192;     // codebook elements staged a chunk
constexpr int kCbVec = kCbMax / 8 / kThreads;  // 16-byte codebook loads

constexpr int kXBytes = kBT * kXLD * 2;
constexpr int kWBytes = kKC * kWLD * 2;
constexpr int kIdBytes = kOT * kIdLD;
constexpr int kCbBytes = kCbMax * 2;
constexpr int kCBytes = (kBT / 2) * kCLD * 4;  // half the epilogue tile
static_assert(kCBytes <= kXBytes + kWBytes, "epilogue tile must fit");

struct Chunk {
  int f0, sub0, nsub, nvalid;
};

__device__ __forceinline__ Chunk chunk_at(int f0, int cin, int d) {
  Chunk c;
  c.f0 = f0;
  c.sub0 = f0 / d;
  c.nvalid = min(f0 + kKC, cin) - f0;
  c.nsub = (f0 + c.nvalid - 1) / d - c.sub0 + 1;
  return c;
}

__global__ void __launch_bounds__(kThreads)
pq_fc_fused_general_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ cb,
                   const uint8_t* __restrict__ asmt,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int nb, int cin, int s, int k, int d, int cout,
                   bool x_vec, bool cb_stage) {
  __shared__ __align__(128) unsigned char
      smem[kXBytes + kWBytes + kIdBytes + kCbBytes];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + kXBytes);
  uint8_t* ids = smem + kXBytes + kWBytes;  // [kOT][kIdLD]
  __nv_bfloat16* cbs =  // the chunk's codewords, (nsub, K, D)
      reinterpret_cast<__nv_bfloat16*>(smem + kXBytes + kWBytes + kIdBytes);
  float* cs = reinterpret_cast<float*>(smem);

  const int b0 = blockIdx.y * kBT;
  const int o0 = blockIdx.x * kOT;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // warp's 32-row band of the tile
  const int wc = warp & 1;   // warp's 32-column band
  const __nv_bfloat16 zero = __ushort_as_bfloat16(0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 xr[kXVec];
  uint8_t idr[kIdLoads];
  uint4 cbr[kCbVec];
  const int kd = k * d;

  // global -> registers: slot i of the x tile is (row i / 8, 8 columns
  // from (i % 8) * 8); slot i of the ids is (output i / kMaxSub,
  // sub-space i % kMaxSub), unused past nsub
  auto load = [&](const Chunk& ch) {
    if (x_vec) {
#pragma unroll
      for (int r = 0; r < kXVec; ++r) {
        const int i = tid + r * kThreads;
        const int b = b0 + i / (kKC / 8), f = ch.f0 + (i % (kKC / 8)) * 8;
        xr[r] = (b < nb && f < cin)
                    ? __ldg(reinterpret_cast<const uint4*>(
                          x + (long long)b * cin + f))
                    : make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int r = 0; r < kIdLoads; ++r) {
      const int i = tid + r * kThreads;
      const int o = o0 + i / kMaxSub, j = i % kMaxSub;
      idr[r] = (j < ch.nsub && o < cout)
                   ? __ldg(asmt + (long long)o * s + ch.sub0 + j)
                   : 0;
    }
    if (cb_stage) {
      const uint4* src =
          reinterpret_cast<const uint4*>(cb + (long long)ch.sub0 * kd);
#pragma unroll
      for (int r = 0; r < kCbVec; ++r) {
        const int i = tid + r * kThreads;
        cbr[r] = i * 8 < ch.nsub * kd ? __ldg(src + i) : make_uint4(0, 0, 0, 0);
      }
    }
  };

  // registers -> shared memory (rows past Cin or B are zero)
  auto store = [&](const Chunk& ch) {
    if (x_vec) {
#pragma unroll
      for (int r = 0; r < kXVec; ++r) {
        const int i = tid + r * kThreads;
        *reinterpret_cast<uint4*>(xs + (i / (kKC / 8)) * kXLD +
                                  (i % (kKC / 8)) * 8) = xr[r];
      }
    } else {
      for (int i = tid; i < kBT * kKC; i += kThreads) {
        const int row = i / kKC, c = i % kKC;
        const int b = b0 + row, f = ch.f0 + c;
        xs[row * kXLD + c] =
            (b < nb && f < cin) ? x[(long long)b * cin + f] : zero;
      }
    }
#pragma unroll
    for (int r = 0; r < kIdLoads; ++r) {
      const int i = tid + r * kThreads;
      ids[(i / kMaxSub) * kIdLD + i % kMaxSub] = idr[r];
    }
    if (cb_stage) {
#pragma unroll
      for (int r = 0; r < kCbVec; ++r) {
        reinterpret_cast<uint4*>(cbs)[tid + r * kThreads] = cbr[r];
      }
    }
  };

  const int nchunks = (cin + kKC - 1) / kKC;
  if (nchunks > 0) load(chunk_at(0, cin, d));
  for (int ci = 0; ci < nchunks; ++ci) {
    const Chunk ch = chunk_at(ci * kKC, cin, d);
    store(ch);
    __syncthreads();
    if (ci + 1 < nchunks) load(chunk_at((ci + 1) * kKC, cin, d));

    // decode: ws[c][oo] = W[f0 + c, o0 + oo], whole codewords a thread
    {
      const int oo = tid % kOT;
      const bool o_ok = o0 + oo < cout;
#pragma unroll 4
      for (int j = tid / kOT; j < ch.nsub; j += kThreads / kOT) {
        const int sub = ch.sub0 + j;
        const int c0 = sub * d - ch.f0;  // < 0 when D does not divide f0
        const int code = ids[oo * kIdLD + j];
        const int lo = max(0, -c0), hi = min(d, ch.nvalid - c0);
        if (cb_stage) {
          const __nv_bfloat16* src = cbs + j * kd + code * d;
          for (int dd = lo; dd < hi; ++dd)
            ws[(c0 + dd) * kWLD + oo] = o_ok ? src[dd] : zero;
        } else {
          const __nv_bfloat16* src = cb + (long long)sub * kd + code * d;
          for (int dd = lo; dd < hi; ++dd)
            ws[(c0 + dd) * kWLD + oo] = o_ok ? __ldg(src + dd) : zero;
        }
      }
      for (int i = ch.nvalid * kOT + tid; i < kKC * kOT; i += kThreads) {
        ws[(i / kOT) * kWLD + i % kOT] = zero;  // rows past Cin
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wr * 32 + i * 16) * kXLD + kk,
                               kXLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], ws + kk * kWLD + wc * 32 + j * 16,
                               kWLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, 64 rows at a time through shared memory (aliases xs + ws)
  for (int half = 0; half < 2; ++half) {
    if ((wr >> 1) == half) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(
              cs + ((wr & 1) * 32 + i * 16) * kCLD + wc * 32 + j * 16,
              acc[i][j], kCLD, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < (kBT / 2) * kOT; i += kThreads) {
      const int r = i / kOT, c = i % kOT;
      const int b = b0 + half * (kBT / 2) + r, o = o0 + c;
      if (b < nb && o < cout) {
        out[(long long)b * cout + o] = cs[r * kCLD + c] + __ldg(bias + o);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int pq_fc_fused_general_launch(const void* x, const void* cb,
                                          const void* asmt,
                                          const void* bias, void* out,
                                          int nb, int cin, int s, int k,
                                          int d, int cout,
                                          cudaStream_t stream) {
  if (nb == 0 || cout == 0) return 0;
  if ((nb + kBT - 1) / kBT > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((cout + kOT - 1) / kOT, (nb + kBT - 1) / kBT);
  // 16-byte loads of x when every row starts 16-byte aligned
  const bool x_vec =
      cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // stage the codebook span in shared memory when it fits and every
  // span starts 16-byte aligned
  const int max_nsub = (kKC - 1) / d + 2 < kMaxSub ? (kKC - 1) / d + 2
                                                   : kMaxSub;
  const bool cb_stage = (long long)max_nsub * k * d <= kCbMax &&
                        (k * d) % 8 == 0 &&
                        reinterpret_cast<uintptr_t>(cb) % 16 == 0;
  pq_fc_fused_general_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(cb),
      static_cast<const uint8_t*>(asmt), static_cast<const float*>(bias),
      static_cast<float*>(out), nb, cin, s, k, d, cout, x_vec, cb_stage);
  return (int)cudaGetLastError();
}
