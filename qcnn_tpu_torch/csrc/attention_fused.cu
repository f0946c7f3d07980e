// attention_fused: the attention of a ViT block in one kernel, for Hopper
// (sm_90a): q k^T, the softmax and the product with v, with nothing of the
// (N, N) logits in device memory.
//
// Replaces no Pallas kernel: the JAX package leaves attention to XLA
// (qcnn_tpu/models/vit.py `_masked_attention`), and the port ran it as a
// chain of library calls that materializes the logits (twelve kernels a
// block at ViT-L/16's 577 tokens, models/vit.py). It computes that chain's
// function, for a head dimension of 64 and a `scale` that is a power of
// two (1/8 there):
//   s = float32 sum of q . k, times `scale`, rounded once to bf16;
//   the softmax's max and sum in float32 over those rounded logits;
//   o = float32 sum of p . v over bf16 probabilities, in out's dtype.
// The design is the online softmax: key tiles stream past a query tile
// that stays in registers, the running max and sum are kept a row, and
// the probabilities exp(s - running max) are rounded to bf16 before the
// final division by the sum. The plain chain divides first and rounds
// after, so this moves one bf16 rounding of each probability; it keeps its
// precision. exp is 2^x with x = (logit - max) log2(e) from one fused
// multiply-add, by `ex2.approx.ftz` (exp2f's instruction; results below
// 2^-126, which no bf16 probability that counts against a sum of at least
// 1 can carry, flush to 0). The logits are rounded unscaled and the scale
// joins log2(e) in that multiply-add: rounding commutes with a power of
// two, so the rounded logits are the same, a multiply an element cheaper.
//
// Bound: at ViT-L/16 and B=128 (16 heads, N=577) a block's two products are
// 174.5 GFLOP (0.18 ms at 989 TFLOP/s) and one read of q, k, v and one
// write of o move 605 MB (0.18 ms at 3.35 TB/s); the softmax's 6.8e8 `exp`
// take ~0.16 ms at 16 a clock an SM. The chain moved ~13.6 GB a block. So
// the kernel is bound by tensor-core time and by the softmax's
// instructions, which it overlaps across warpgroups.
//
// Design:
// - a block owns 128 query rows of one (batch, head): two warpgroups of 64
//   rows each (the grid runs the query tiles of a head next to each other,
//   so that its K and V come from L2 after the first tile);
// - q, k and v are read in place from the qkv projection's (B, N, 3 H 64)
//   output by their strides (no transpose, no copy); o is written to a
//   (B, N, H 64) tensor, so the head merge costs nothing;
// - a thread loads its query rows once, as the A operand of `wgmma`
//   (registers); K and V tiles of 64 keys stream through a 4-stage
//   shared-memory ring filled by 16-byte `cp.async` with the 128-byte
//   swizzle, two tiles ahead, one barrier a tile;
// - S = Q K^T is one m64n64k16 `wgmma` group a tile (K-major B); the
//   accumulators are rounded, masked, exponentiated and packed to bf16 in
//   registers, and their layout is the A operand's, so P feeds P V
//   (`wgmma` with V as an MN-major B, the transpose flag set) without
//   leaving the registers. P V is left running while the block passes the
//   next barrier and starts the next S, and is waited for with it;
// - keys past N are zero-filled by the copies and masked to -inf before
//   the max (the last tile only); query rows past N are read as zeros and
//   not stored;
// - two blocks fit an SM (at most 128 registers a thread, 65 KB of shared
//   memory), so one block's softmax overlaps the other's products.
// Measured at ViT-L/16's B=128 (H100, 700 W): 0.674 ms a block, 259 TFLOP/s,
// 26 % of the products' peak. What was tried and lost: a second set of S
// accumulators, so that tile t + 1's S runs during tile t's softmax (FA3's
// intra-warpgroup overlap), needs 175 registers, so one block an SM, and
// ptxas serialized its `wgmma`: 1.05 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90.cuh"

namespace {

constexpr int kHd = 64;                     // head dimension
constexpr int kWarpgroups = 2;              // 64 query rows each
constexpr int kRows = 64 * kWarpgroups;     // query rows a block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kKeys = 64;                   // keys a tile
constexpr int kStages = 4;                  // K and V tiles in the ring
constexpr int kTileBytes = kKeys * kHd * 2;  // one K or V tile: 8 KB
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kSmem = 1024 + kStages * kStageBytes;  // + alignment slack
constexpr float kLog2e = 1.4426950408889634f;

struct Operand {
  const __nv_bfloat16* p;
  long long sb, sn, sh;  // element strides of batch, token and head
};

struct Args {
  Operand q, k, v;
  void* out;  // (B, N, H * 64) in the output dtype
  int n, heads;
  float scale;
};

// D (+)= A B for one k16 step, m64n64k16, bf16 operands, f32 accumulators:
// A from registers (see pq_wgmma.cuh for the fragment layouts), B from
// shared memory through `desc`; scale_d 0 overwrites D. kTransB 0 reads B
// K-major, 1 MN-major.
template <int kTransB>
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t* a,
                                    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(kTransB));
}

// 2^x; +0 for -inf
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) rounded to bf16 (to nearest even) and packed, a in the low half
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
}

// One key tile's softmax step for a thread's two rows. Accumulator pair i
// (s[2i], s[2i + 1]) is row i & 1 (row0, row0 + 8) at columns
// 8 (i / 2) + 2q + {0, 1}; the same holds for o. Keys at column - 2q >= lim
// are masked (kMask: the last, ragged tile). Brings the running max m and
// the thread's share l of the running sum up to date, rescales o, and
// packs P = exp(logit - max) as bf16 into pf, whose pair i is the A
// fragment register i of P V. The scale, a power of two, is applied after
// the rounding: m is the max of the unscaled logits.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&o)[32],
                                             uint32_t (&pf)[16], float (&m)[2],
                                             float (&l)[2], float scale,
                                             int lim) {
  const float c = scale * kLog2e;  // exponent a unit of unscaled logit
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t r = pack_bf16(s[2 * i], s[2 * i + 1]);
    float x0 = __uint_as_float(r << 16);
    float x1 = __uint_as_float(r & 0xffff0000u);
    if (kMask) {
      const int c = 8 * (i >> 1);
      if (c >= lim) x0 = -INFINITY;
      if (c + 1 >= lim) x1 = -INFINITY;
    }
    s[2 * i] = x0;
    s[2 * i + 1] = x1;
    mx[i & 1] = fmaxf(mx[i & 1], fmaxf(x0, x1));
  }
  float alpha[2], neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's 64 keys lie on 4 lanes
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);  // finite: a tile has a real key
    alpha[r] = ex2((m[r] - mn) * c);  // 0 on the first tile
    m[r] = mn;
    neg[r] = -mn * c;
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float p0 = ex2(fmaf(s[2 * i], c, neg[i & 1]));
    const float p1 = ex2(fmaf(s[2 * i + 1], c, neg[i & 1]));
    sum[i & 1] += p0 + p1;
    pf[i] = pack_bf16(p0, p1);
    o[2 * i] *= alpha[i & 1];
    o[2 * i + 1] *= alpha[i & 1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

template <typename Out>
__global__ void __launch_bounds__(kThreads, 2)
    attention_fused_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (pq::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  // this thread's query rows: row0 and row0 + 8 (warp w owns 16 rows)
  const int row0 = blockIdx.x * kRows + (tid >> 5) * 16 + g;
  const __nv_bfloat16* qp = a.q.p + b * a.q.sb + h * a.q.sh;
  const __nv_bfloat16* kp = a.k.p + b * a.k.sb + h * a.k.sh;
  const __nv_bfloat16* vp = a.v.p + b * a.v.sb + h * a.v.sh;
  const int tiles = (a.n + kKeys - 1) / kKeys;

  // K and V of tile t into stage t % kStages, one commit group a tile
  // (empty past the last): this thread copies 16-byte group tid % 8 of key
  // rows tid / 8 and tid / 8 + 32 of each; keys past n land as zeros
  auto load = [&](int t) {
    if (t < tiles) {
      const uint32_t st = base + (t % kStages) * kStageBytes;
      const int c16 = tid & 7;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = (tid >> 3) + 32 * i;
        const int key = t * kKeys + r;
        const bool ok = key < a.n;
        const long long kk = ok ? key : 0;
        pq::cp_async16(st + pq::swizzle128(r, c16), kp + kk * a.k.sn + 8 * c16,
                       ok);
        pq::cp_async16(st + kTileBytes + pq::swizzle128(r, c16),
                       vp + kk * a.v.sn + 8 * c16, ok);
      }
    }
    pq::cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kStages - 2; ++t) load(t);

  // Q as A fragments: qf[4 ks + 2 hi + r] = q[row0 + 8 r, p .. p + 1] at
  // p = 16 ks + 8 hi + 2 q4; rows past n are zeros
  uint32_t qf[16];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const int col = 16 * ks + 8 * hi + 2 * q4;
        qf[4 * ks + 2 * hi + r] =
            row < a.n ? __ldg(reinterpret_cast<const unsigned int*>(
                            qp + row * a.q.sn + col))
                      : 0u;
      }

  float s[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = 0.0f;
    o[i] = 0.0f;
  }
  uint32_t pf[16];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const int ragged = a.n % kKeys;  // real keys of the last tile, or 0

  // P V of tile t runs on while the block moves to tile t + 1: it is
  // waited for together with tile t + 1's S, before o is next rescaled
  for (int t = 0; t < tiles; ++t) {
    pq::cp_async_wait<kStages - 3>();  // this thread's copies of tile t
    pq::fence_proxy_async();
    // everyone's copies of tile t are in; everyone has waited for P V of
    // tile t - 2, the last reader of the stage that tile t + 2 goes to
    __syncthreads();
    load(t + kStages - 2);
    const uint32_t st = base + (t % kStages) * kStageBytes;

    const uint64_t kd = pq::kmajor_desc(st);
    pq::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma<0>(s, qf + 4 * ks, kd + 2 * ks, ks);
    pq::wgmma_commit();
    pq::wgmma_wait<0>();  // S of tile t and P V of tile t - 1
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      pq::keep(s[i]);
      pq::keep(o[i]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) pq::keep(pf[i]);

    if (t == tiles - 1 && ragged)
      softmax_tile<true>(s, o, pf, m, l, a.scale, ragged - 2 * q4);
    else
      softmax_tile<false>(s, o, pf, m, l, a.scale, kKeys);

    const uint64_t vd = pq::mnmajor_desc(st + kTileBytes);
    pq::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) mma<1>(o, pf + 4 * ks, vd + 128 * ks, 1);
    pq::wgmma_commit();
  }
  pq::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) pq::keep(o[i]);
#pragma unroll
  for (int i = 0; i < 16; ++i) pq::keep(pf[i]);
  pq::cp_async_wait<0>();

  // o / (the row's sum over its 4 lanes); column 8 j + 2 q4 + {0, 1}
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row < a.n) {
      Out* dst = static_cast<Out*>(a.out) +
                 (static_cast<long long>(b) * a.n + row) * (a.heads * kHd) +
                 h * kHd + 2 * q4;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(dst + 8 * j, o[4 * j + 2 * r] / l[r],
               o[4 * j + 2 * r + 1] / l[r]);
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename Out>
int launch(const Args& a, int batch, cudaStream_t stream) {
  static bool smem_set = false;  // per instantiation and process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fused_kernel<Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid((a.n + kRows - 1) / kRows, a.heads, batch);
  attention_fused_kernel<Out><<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v: (B, N, H, hd) bf16 by element strides (batch, token, head; the
// last dimension dense), 16-byte aligned with strides of whole 16-byte
// groups; out: a dense (B, N, H * hd) tensor of out_dtype (0 float32,
// 1 bf16). hd must be 64 and scale a power of two.
extern "C" int attention_fused_launch(
    const void* q, const void* k, const void* v, void* out, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh, int batch,
    int n, int heads, int hd, float scale, int out_dtype,
    cudaStream_t stream) {
  int exponent;
  if (hd != kHd || batch < 0 || n < 0 || heads < 1 || heads > 65535 ||
      batch > 65535 || (out_dtype != 0 && out_dtype != 1) || !(scale > 0) ||
      std::frexp(scale, &exponent) != 0.5f)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n == 0) return 0;
  const long long strides[9] = {q_sb, q_sn, q_sh, k_sb, k_sn,
                                k_sh, v_sb, v_sn, v_sh};
  for (long long s : strides)
    if (s % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = {static_cast<const __nv_bfloat16*>(q), q_sb, q_sn, q_sh};
  a.k = {static_cast<const __nv_bfloat16*>(k), k_sb, k_sn, k_sh};
  a.v = {static_cast<const __nv_bfloat16*>(v), v_sb, v_sn, v_sh};
  a.out = out;
  a.n = n;
  a.heads = heads;
  a.scale = scale;
  return out_dtype == 0 ? launch<float>(a, batch, stream)
                        : launch<__nv_bfloat16>(a, batch, stream);
}
