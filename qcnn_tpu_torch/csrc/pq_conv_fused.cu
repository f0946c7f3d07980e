// pq_conv_fused: PQ convolution whose weight tiles are decoded on chip, as
// an implicit GEMM, for Hopper (sm_90a).
//
// Replaces qcnn_tpu/ops/pallas/pq_conv_fused.py `_pq_conv_fused` (the
// pallas_call at :127, `_kernel`), reached there by `pq_conv_fused` and the
// memory-mode conv route `memory_fused`.
//
// Computes, for a stride-1, ungrouped, square kh x kh conv with zero
// padding `pad`:
//   out[b, ho, wo, o] = bias[o]
//       + sum_{ti, tj, c} x[b, ho + ti - pad, wo + tj - pad, c] * W[o, ti, tj, c]
// with W[o, ti, tj, c] = cb[c / D, A[o, ti, tj, c / D], c % D] (c < Cin <=
// S*D), x and cb in bfloat16 (the wrapper casts them, as the JAX kernel
// does), products accumulated in float32, bias and out float32. x is NHWC,
// out is NHWC (B, Ho, Wo, Cout), A is (Cout, kh, kh, S) uint8. The decoded
// weight never reaches device memory.
//
// Bound: operations. ResNet-50's fused convs at B=64 are 14.8 GFLOP
// (14x14, 256->256) of bf16 tensor-core work against ~19 MB of x, ids and
// output.
//
// Design (simple first, no TMA or wgmma yet): the conv is a GEMM of
// M = B*Ho*Wo output pixels by N = Cout over kh*kh taps x Cin. A block of
// 8 warps owns a 128-pixel x 64-channel output tile and loops over
// (tap, 64-channel chunk) pairs:
// - The x tile of the pair is read straight from the NHWC activations: each
//   of its 128 rows is the input pixel that the tap shifts to, or zeros
//   where that pixel lies in the padding (cp.async with a zero source size
//   fills zeros). So the TPU kernel's padded, flattened copy of x, its wrap
//   columns and the slice of the output are gone. The next pair's x tile
//   is copied asynchronously while the current one is decoded and
//   multiplied (two buffers).
// - The 64x64 weight tile is decoded into shared memory: one thread reads
//   one id and copies the D codeword values (one 2D-byte load) into the
//   tile, which is stored as (output, channel) so the copy is one store.
//   One decoded tile serves 128 output pixels.
// - Each warp runs 2x2 WMMA 16x16x16 bf16 products into float32 fragments.
// The epilogue goes through shared memory to mask the ragged edge and add
// the bias.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kMT = 128;       // output pixels per block
constexpr int kNT = 64;        // output channels per block
constexpr int kKC = 64;        // input channels per chunk
constexpr int kThreads = 256;  // 8 warps: 4 row bands x 2 column bands
constexpr int kLD = kKC + 8;   // shared row pitch (bf16) of x rows and of
                               // weight columns: a multiple of 8, padded
constexpr int kCLD = kNT + 4;  // epilogue pitch (f32)
constexpr int kXTile = kMT * kLD;
constexpr int kWTile = kNT * kLD;
constexpr int kSmemBytes = 2 * (kXTile + kWTile) * 2;  // two buffers each
constexpr int kRows = kMT * (kKC / 8) / kThreads;  // x rows a thread loads
static_assert(kMT * kCLD * 4 <= kSmemBytes, "epilogue tile must fit");

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;  // 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// one codeword of D bf16 values, moved as one load and one store
template <int D>
struct Word;
template <>
struct Word<1> {
  using T = unsigned short;
};
template <>
struct Word<2> {
  using T = unsigned int;
};
template <>
struct Word<4> {
  using T = uint2;
};

struct Geometry {
  int nb, h, w, cin, s, k, cout, kh, pad, ho, wo;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
pq_conv_fused_kernel(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ cb,
                     const uint8_t* __restrict__ asmt,
                     const float* __restrict__ bias, float* __restrict__ out,
                     Geometry g, bool x_vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kMT][kLD]
  __nv_bfloat16* ws = xs + 2 * kXTile;  // [2][kNT][kLD], (output, channel)
  float* cs = reinterpret_cast<float*>(smem);  // epilogue, after the loop

  using W = typename Word<D>::T;
  constexpr int kSub = kKC / D;  // sub-spaces a full chunk spans
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // warp's 32-row band of the tile
  const int wc = warp & 1;   // warp's 32-column band
  const int m0 = blockIdx.y * kMT;
  const int o0 = blockIdx.x * kNT;
  const int taps = g.kh * g.kh;
  const int howo = g.ho * g.wo;
  const long long m_total = (long long)g.nb * howo;
  const int nchunks = (g.cin + kKC - 1) / kKC;
  const int n_it = taps * nchunks;

  // the output pixels of this thread's x rows (vector path): row
  // tid / 8 + 32 r, 8 channels from (tid % 8) * 8
  int pix_b[kRows], pix_h[kRows], pix_w[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long m = m0 + tid / (kKC / 8) + r * (kThreads / (kKC / 8));
    if (m < m_total) {
      pix_b[r] = (int)(m / howo);
      const int rem = (int)(m % howo);
      pix_h[r] = rem / g.wo;
      pix_w[r] = rem % g.wo;
    } else {
      pix_b[r] = -1;
      pix_h[r] = pix_w[r] = 0;
    }
  }

  // x tile of pair `it` into buffer `buf`: zeros for padding pixels,
  // channels past Cin and pixels past M
  auto load_x = [&](int it, int buf) {
    const int t = it / nchunks;
    const int c0 = (it % nchunks) * kKC;
    const int ti = t / g.kh, tj = t % g.kh;
    __nv_bfloat16* dst = xs + buf * kXTile;
    if (x_vec) {
      const int cc = (tid % (kKC / 8)) * 8;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = tid / (kKC / 8) + r * (kThreads / (kKC / 8));
        const int ih = pix_h[r] + ti - g.pad, iw = pix_w[r] + tj - g.pad;
        const bool ok = pix_b[r] >= 0 && ih >= 0 && ih < g.h && iw >= 0 &&
                        iw < g.w && c0 + cc < g.cin;
        const __nv_bfloat16* src =
            ok ? x + (((long long)pix_b[r] * g.h + ih) * g.w + iw) * g.cin +
                     c0 + cc
               : x;
        cp_async16(dst + row * kLD + cc, src, ok);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < kMT * kKC; i += kThreads) {
        const int row = i / kKC, cc = i % kKC;
        const long long m = m0 + row;
        __nv_bfloat16 v = __ushort_as_bfloat16(0);
        if (m < m_total && c0 + cc < g.cin) {
          const int b = (int)(m / howo), rem = (int)(m % howo);
          const int ih = rem / g.wo + ti - g.pad, iw = rem % g.wo + tj - g.pad;
          if (ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
            v = x[(((long long)b * g.h + ih) * g.w + iw) * g.cin + c0 + cc];
        }
        dst[row * kLD + cc] = v;
      }
    }
  };

  // weight tile of pair `it` into buffer `buf`: ws[oo][c] = W[o0 + oo,
  // tap, c0 + c]; zero past the chunk's sub-spaces and past Cout
  auto decode = [&](int it, int buf) {
    const int t = it / nchunks;
    const int c0 = (it % nchunks) * kKC;
    const int sub0 = c0 / D;
    const int nsub = (min(kKC, g.cin - c0) + D - 1) / D;
    __nv_bfloat16* dst = ws + buf * kWTile;
#pragma unroll 4
    for (int i = tid; i < kNT * kSub; i += kThreads) {
      const int oo = i / kSub, j = i % kSub;
      const int o = o0 + oo;
      W v;
      if (j < nsub && o < g.cout) {
        const int code =
            __ldg(asmt + ((long long)o * taps + t) * g.s + sub0 + j);
        v = __ldg(reinterpret_cast<const W*>(
            cb + ((long long)(sub0 + j) * g.k + code) * D));
      } else {
        v = W{};
      }
      *reinterpret_cast<W*>(dst + oo * kLD + j * D) = v;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if (n_it > 0) load_x(0, 0);
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    decode(it, buf);
    if (x_vec) cp_async_wait_all();
    __syncthreads();
    // the other buffers were last read by the products of pair it - 1,
    // which every thread finished before the barrier above
    if (it + 1 < n_it) load_x(it + 1, buf ^ 1);

    const __nv_bfloat16* xa = xs + buf * kXTile;
    const __nv_bfloat16* wb = ws + buf * kWTile;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bw[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xa + (wr * 32 + i * 16) * kLD + kk, kLD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bw[j], wb + (wc * 32 + j * 16) * kLD + kk,
                               kLD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], bw[j], acc[i][j]);
    }
  }
  __syncthreads();  // every product done before cs overwrites the tiles

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wr * 32 + i * 16) * kCLD + wc * 32 + j * 16,
                              acc[i][j], kCLD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kMT * kNT; i += kThreads) {
    const int r = i / kNT, c = i % kNT;
    const long long m = m0 + r;
    const int o = o0 + c;
    if (m < m_total && o < g.cout) {
      out[m * g.cout + o] = cs[r * kCLD + c] + __ldg(bias + o);
    }
  }
}

template <int D>
int launch(const void* x, const void* cb, const void* asmt, const void* bias,
           void* out, const Geometry& g, cudaStream_t stream) {
  static bool attr_set = false;  // once per instantiation and process
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_conv_fused_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const long long m_total = (long long)g.nb * g.ho * g.wo;
  const long long m_tiles = (m_total + kMT - 1) / kMT;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((g.cout + kNT - 1) / kNT, (unsigned)m_tiles);
  // 16-byte x loads when every pixel's channels start 16-byte aligned
  const bool x_vec =
      g.cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  pq_conv_fused_kernel<D><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(cb),
      static_cast<const uint8_t*>(asmt), static_cast<const float*>(bias),
      static_cast<float*>(out), g, x_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pq_conv_fused_launch(const void* x, const void* cb,
                                    const void* asmt, const void* bias,
                                    void* out, int nb, int h, int w, int cin,
                                    int s, int k, int d, int cout, int kh,
                                    int pad, cudaStream_t stream) {
  Geometry g{nb, h, w, cin, s, k, cout, kh, pad, h + 2 * pad - kh + 1,
             w + 2 * pad - kh + 1};
  if (nb == 0 || cout == 0 || g.ho <= 0 || g.wo <= 0) return 0;
  // one codeword is one aligned load of 2*D bytes
  if (reinterpret_cast<uintptr_t>(cb) % (2 * d) != 0)
    return (int)cudaErrorMisalignedAddress;
  switch (d) {
    case 1:
      return launch<1>(x, cb, asmt, bias, out, g, stream);
    case 2:
      return launch<2>(x, cb, asmt, bias, out, g, stream);
    case 4:
      return launch<4>(x, cb, asmt, bias, out, g, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
