// pq_fc_fused: PQ FC as one GEMM whose weight is decoded inside the kernel,
// for Hopper (sm_90a): warp-specialised, `mbarrier` ring, `wgmma`.
//
// Replaces qcnn_tpu/ops/pallas/pq_fc_fused.py `_pq_fc_fused` (the
// pallas_calls at :164, `_kernel_gather` for decode="gather", and :219,
// `_kernel` for decode="select"), reached there by `pq_fc_fused`. The two
// Pallas variants compute the same function and differ only in how the TPU
// decodes a tile; this one kernel serves both.
//
// Computes  out[b, o] = bias[o] + sum_f x[b, f] * W[f, o]
// with W[f, o] = cb[f / D, A[o, f / D], f % D], x and cb in bfloat16 (the
// wrapper casts them, as the JAX kernel does), products accumulated in
// float32, bias and out float32. The decoded weight never reaches device
// memory, nor shared memory: it exists only as `wgmma` A fragments.
//
// Bound on this card. At large batch, operations: AlexNet fc6 at B=256 is
// 19.3 GFLOP of bf16 tensor-core work against 9.4 MB of ids and 4.7 MB of
// x. At small batch, the uint8 id stream (9.4 MB for fc6) and, before it,
// the decode itself: every id costs a consumer thread two shared-memory
// reads whatever the batch.
//
// Design (the kernel is pq_tile.cuh's `decode_gemm_kernel`, shared with
// pq_conv_fused.cu):
// - The product is computed as out^T = W x^T: the 64 x 16 decoded weight
//   fragment is `wgmma`'s A operand, from registers, and the x tile is its
//   B operand, from shared memory. So the batch is the instruction's N:
//   B=3 pads to 8 rows, not to 64, and a large batch takes 256-row tiles,
//   where one decoded fragment feeds an m64n256k16.
// - A producer warpgroup keeps up to 12 stages of (x tile, ids, codebook
//   span of the chunk) in flight with `cp.async` on `mbarrier`s; two
//   consumer warpgroups (64 outputs each) decode and multiply. Nothing in
//   the loop is a block-wide barrier, and a thread decodes the next stage
//   while its `wgmma` group runs.
// - 128 outputs x 256 batch rows leave AlexNet's layers under the card's
//   132 SMs (fc6 at B=256: 32 tiles; fc8: 16), so the wrapper splits the
//   contraction across blockIdx.z to about one wave. Each split writes its
//   partial sums to a float32 workspace and `split_reduce_kernel` adds them
//   in split order, then the bias: the result is the same from run to run.
//
// The tile (NT batch rows) and the number of splits are chosen by
// ops/cuda/pq_fc_fused.py `plan`, a pure function of the shape. Shapes that
// this kernel does not take (see pq_tile.cuh) go to pq_fc_fused_general.cu.

#include "pq_tile.cuh"

namespace {

// NT = 256 (128 accumulators a thread) is built for D = 4 only: the decode
// of D < 4 needs the registers.
template <int NT>
int launch_nt(const pq::Problem& p, float* ws, int d, int splits,
              cudaStream_t stream) {
  if (d == 4)
    return pq::launch_decode_gemm<NT, 4, false>(p, ws, splits, stream);
  if constexpr (NT <= 128) {
    if (d == 2)
      return pq::launch_decode_gemm<NT, 2, false>(p, ws, splits, stream);
    if (d == 1)
      return pq::launch_decode_gemm<NT, 1, false>(p, ws, splits, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `nt` (batch rows a block: 8, 32, 64, 128 or 256) and `splits` come from
// the wrapper's plan; `ws` holds splits x nb x cout floats when splits > 1.
extern "C" int pq_fc_fused_launch(const void* x, const void* cb,
                                  const void* asmt, const void* bias,
                                  void* out, void* ws, int nb, int cin,
                                  int s, int k, int d, int cout, int nt,
                                  int splits, cudaStream_t stream) {
  if (nb == 0 || cout == 0) return 0;
  if (cin % pq::kKC != 0 || cin != s * d || cin == 0 || k < 1 || k > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!pq::aligned16(x) || !pq::aligned16(cb) || !pq::aligned16(asmt))
    return static_cast<int>(cudaErrorMisalignedAddress);
  pq::Problem p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.cb = static_cast<const __nv_bfloat16*>(cb);
  p.ids = static_cast<const uint8_t*>(asmt);
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<float*>(out);
  p.m_total = nb;
  p.cin = cin;
  p.s = s;
  p.k = k;
  p.cout = cout;
  p.h = p.w = p.kh = p.ho = p.wo = 1;
  p.pad = 0;
  float* w = static_cast<float*>(ws);
  switch (nt) {
    case 8:
      return launch_nt<8>(p, w, d, splits, stream);
    case 32:
      return launch_nt<32>(p, w, d, splits, stream);
    case 64:
      return launch_nt<64>(p, w, d, splits, stream);
    case 128:
      return launch_nt<128>(p, w, d, splits, stream);
    case 256:
      return launch_nt<256>(p, w, d, splits, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
