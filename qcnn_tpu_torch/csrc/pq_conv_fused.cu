// pq_conv_fused: PQ convolution whose weight is decoded inside the kernel,
// as an implicit GEMM, for Hopper (sm_90a): warp-specialised, `mbarrier`
// ring, `wgmma`.
//
// Replaces qcnn_tpu/ops/pallas/pq_conv_fused.py `_pq_conv_fused` (the
// pallas_call at :127, `_kernel`), reached there by `pq_conv_fused` and the
// memory-mode conv route `memory_fused`.
//
// Computes, for a stride-1, ungrouped, square kh x kh conv with zero
// padding `pad`:
//   out[b, ho, wo, o] = bias[o]
//       + sum_{ti, tj, c} x[b, ho + ti - pad, wo + tj - pad, c] * W[o, ti, tj, c]
// with W[o, ti, tj, c] = cb[c / D, A[o, ti, tj, c / D], c % D], x and cb in
// bfloat16 (the wrapper casts them, as the JAX kernel does), products
// accumulated in float32, bias and out float32. x is NHWC, out is NHWC
// (B, Ho, Wo, Cout), A is (Cout, kh, kh, S) uint8. The decoded weight never
// reaches device memory, nor shared memory: it exists only as `wgmma` A
// fragments.
//
// Bound on this card. At large batch, operations: ResNet-50's fused convs
// at B=64 are 14.8 GFLOP each of bf16 tensor-core work against 10-19 MB of
// x, ids and output. At B=1 a conv is 0.23 GFLOP in 2-4 output tiles:
// latency, unless the contraction is spread over the card.
//
// Design (the kernel is pq_tile.cuh's `decode_gemm_kernel`, shared with
// pq_fc_fused.cu). The conv is the GEMM out^T = W X^T over (64-channel
// chunk, tap) pairs, with 128 output channels a block as `wgmma`'s M and a
// tile of 64, 128 or 256 output pixels as its N (one decoded fragment
// feeds the whole width):
// - The producer warpgroup gathers the pair's X tile straight from NHWC x,
//   one 128-byte row per output pixel: the input pixel the tap shifts it
//   to, or zeros in the padding (`cp.async` with a zero source size),
//   written with the 128-byte swizzle. With it come the pair's ids: 16
//   contiguous bytes per channel for D=4. No padded copy of x, no wrap
//   columns, no dependent global loads in the loop.
// - The codebook chunks of the block's range stay resident in shared memory
//   (64 KB for Cin=256, 128 KB for Cin=512 at K=128), loaded once.
// - Each consumer thread decodes its own A fragment from ids and codebook
//   in shared memory while its previous `wgmma` group runs.
// - Where the tiles do not fill the card (B=1: 8 tiles a conv), the
//   (chunk, tap) range is split across blockIdx.z. The splits' partial
//   sums are reduced in split order by `split_reduce_kernel`, which adds
//   the bias: the result is the same from run to run.
//
// The pixel tile and the number of splits are chosen by
// ops/cuda/pq_conv_fused.py `plan`, a pure function of the geometry.
// Geometries that this kernel does not take (see pq_tile.cuh) go to
// pq_conv_fused_general.cu.

#include "pq_tile.cuh"

namespace {

// NT = 256 (128 accumulators a thread) is built for D = 4 only: the decode
// of D < 4 needs the registers.
template <int NT>
int launch_nt(const pq::Problem& p, float* ws, int d, int splits,
              cudaStream_t stream) {
  if (d == 4)
    return pq::launch_decode_gemm<NT, 4, true>(p, ws, splits, stream);
  if constexpr (NT <= 128) {
    if (d == 2)
      return pq::launch_decode_gemm<NT, 2, true>(p, ws, splits, stream);
    if (d == 1)
      return pq::launch_decode_gemm<NT, 1, true>(p, ws, splits, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `nt` (output pixels a block: 64, 128 or 256) and `splits` come from the
// wrapper's plan; `ws` holds splits x (nb * ho * wo) x cout floats when
// splits > 1.
extern "C" int pq_conv_fused_launch(const void* x, const void* cb,
                                    const void* asmt, const void* bias,
                                    void* out, void* ws, int nb, int h,
                                    int w, int cin, int s, int k, int d,
                                    int cout, int kh, int pad, int nt,
                                    int splits, cudaStream_t stream) {
  const int ho = h + 2 * pad - kh + 1, wo = w + 2 * pad - kh + 1;
  if (nb == 0 || cout == 0 || ho <= 0 || wo <= 0) return 0;
  if (cin % pq::kKC != 0 || cin != s * d || cin == 0 || k < 1 || k > 128 ||
      kh < 1 || h > 65535 || w > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!pq::aligned16(x) || !pq::aligned16(cb) || !pq::aligned16(asmt))
    return static_cast<int>(cudaErrorMisalignedAddress);
  pq::Problem p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.cb = static_cast<const __nv_bfloat16*>(cb);
  p.ids = static_cast<const uint8_t*>(asmt);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.m_total = static_cast<long long>(nb) * ho * wo;
  p.cin = cin;
  p.s = s;
  p.k = k;
  p.cout = cout;
  p.h = h;
  p.w = w;
  p.kh = kh;
  p.pad = pad;
  p.ho = ho;
  p.wo = wo;
  float* wsp = static_cast<float*>(ws);
  switch (nt) {
    case 64:
      return launch_nt<64>(p, wsp, d, splits, stream);
    case 128:
      return launch_nt<128>(p, wsp, d, splits, stream);
    case 256:
      return launch_nt<256>(p, wsp, d, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
