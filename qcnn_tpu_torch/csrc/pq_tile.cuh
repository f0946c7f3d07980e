// pq_tile.cuh: the decode-GEMM that pq_fc_fused.cu and pq_conv_fused.cu
// share, for Hopper (sm_90a).
//
// Both kernels compute  out[m, o] = bias[o] + sum_f X[m, f] * W[o, f]  where
// W is never stored: W[o, f] = cb[f / D, ids[o, f / D], f % D]. For the FC,
// m is a batch row and X is x. For the conv, m is an output pixel and the
// contraction runs over (64-channel chunk, tap) pairs, X being the input
// pixel that the tap shifts m to (zeros in the padding).
//
// The product is computed transposed, out^T = W X^T, so that the decoded
// operand is `wgmma`'s A, which may come from registers:
// - a block owns 128 output channels (64 per consumer warpgroup) by NT rows
//   of X (NT in 8..256: the batch pads to 8, not to 64) and a range of the
//   contraction (blockIdx.z; partial sums are reduced in a fixed order by
//   `split_reduce_kernel`). A decoded fragment feeds one `wgmma` of N = NT,
//   so a wide tile amortises the decode;
// - warpgroup 0 is the producer. Per stage of a ring (as deep as shared
//   memory allows, at most 12) it copies, with 16-byte `cp.async`, the X
//   tile (written with the 128-byte swizzle that the `wgmma` B descriptor
//   reads), the channels' uint8 ids of the chunk and, for the FC, the
//   chunk's codebook span (the conv keeps its codebook resident). The
//   copies arrive on the stage's `full` mbarrier;
// - each consumer thread builds its own A fragment: for its two rows
//   (channels) and its eight k positions of a k16 step it reads the id and
//   then the half codeword it needs, both from shared memory. The decoded
//   weight exists only in registers. While the four `wgmma` of one stage
//   run, the thread decodes the next stage into the other of two register
//   sets, and at most two groups are in flight;
// - a consumer warp releases a stage on its `empty` mbarrier once the
//   `wgmma` group that read it is done. No `__syncthreads()` after the
//   prologue. Where a thread holds 128 accumulators (NT = 256) the producer
//   warpgroup hands registers to the consumers (`setmaxnreg`).
//
// What a stage costs, by count: a 256-row stage is 1024 clocks of
// tensor-core work beside about 300 shared-memory wavefronts of X writes,
// 512 of `wgmma` B reads (each 64-channel block reads the whole X tile) and
// a decode of 32 dependent shared-memory reads a thread. The decode takes a
// warpgroup about as long as its four m64n256k16 and overlaps only the other
// warpgroup's products; a narrow tile is bound by it alone, since it costs
// the same whatever NT. Reading the ids 16 bytes at a time, or the
// codewords free of bank conflicts (a transposed codebook, each row group
// of a warp on its own sub-space), did not make it faster.
//
// Shapes taken: Cin = S * D, Cin % 64 == 0, D in {1, 2, 4}, K <= 128,
// 16-byte aligned x, ids and cb. The wrappers send everything else to the
// general kernels (pq_*_fused_general.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "pq_wgmma.cuh"

namespace pq {

constexpr int kKC = 64;            // contraction features per stage: one
                                   // 128-byte swizzle row of bf16
constexpr int kFixedSmem = 1024 + 256;  // alignment slack and barriers
constexpr int kMaxStages = 12;     // ring depth: what fits, up to this,
constexpr int kMinStages = 3;      // and no shallower than this
constexpr int kProducers = 128;    // warpgroup 0
constexpr int kMT = 128;           // output channels per block
constexpr int kConsumerWarps = 8;  // warpgroups 1 and 2, 64 channels each
constexpr int kThreads = kProducers + 32 * kConsumerWarps;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may ask

struct Problem {
  const __nv_bfloat16* x;
  const __nv_bfloat16* cb;
  const uint8_t* ids;
  const float* bias;
  float* out;         // (m_total, cout); split z writes at z * m_total * cout
  long long m_total;  // rows of X: batch rows (fc) or output pixels (conv)
  int cin, s, k, cout;
  int h, w, kh, pad, ho, wo;  // conv geometry (fc: h = w = kh = 1, pad = 0)
  int n_its;          // (chunk, tap) pairs in all, chunk-major
  int its_per_split;  // pairs a block walks
  int add_bias;       // 1 when there is one split: out is final
};

// ---- PTX wrappers ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes global -> shared; !ok writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

// this thread arrives on `bar` once all its earlier cp.async have landed
// (the arrival is one of the count the barrier was initialised with)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) become
// visible to the async proxy that `wgmma` reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// registers a warpgroup may use from here on (a multiple of 8): the
// producer gives some up, the consumers take them
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// tell the compiler a register that an in-flight wgmma reads or writes is
// live (and may have changed) up to here
__device__ __forceinline__ void keep(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void keep(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ uint32_t lds_u8(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// ---- the swizzled K-major tile ----------------------------------------

// Byte offset of 16-byte group `c16` (0..7) of row `row` in a tile of
// 128-byte rows stored with the 128-byte swizzle; the tile starts on a
// 1024-byte boundary. (ops/cuda/_plan.py mirrors it for the CPU tests.)
__device__ __forceinline__ uint32_t swizzle128(int row, int c16) {
  return static_cast<uint32_t>(row * 128 + ((c16 ^ (row & 7)) << 4));
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled tile at
// `addr` (1024-byte aligned; + 32 bytes per k16 step): 8-row groups 1024
// bytes apart, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// ---- decode: the A fragments of one 64-channel block ---------------------

// The 16 A registers of a thread for one chunk: f[4 ks + 2 hi + r] is the
// bf16 pair W[row_r, p], W[row_r, p + 1] at p = 16 ks + 8 hi + 2 q, for the
// thread's rows row_0 and row_1 = row_0 + 8. `ids0` is the shared address
// of row_0's 64 / D ids (row_1's are 8 rows further), `cbs` of the chunk's
// codebook span (64 / D sub-spaces x K codewords x D values).
template <int D>
__device__ __forceinline__ void decode_frags(uint32_t (&f)[16], uint32_t ids0,
                                             uint32_t cbs, int k, int q) {
  constexpr int kIdRow = kKC / D;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int p = 16 * ks + 8 * hi + 2 * q;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t ids_row = ids0 + 8 * r * kIdRow;
        uint32_t v;
        if constexpr (D == 4) {  // half a codeword
          const int sub = p >> 2;
          v = lds_u32(cbs + (((sub * k + lds_u8(ids_row + sub)) << 3) |
                             ((p & 2) << 1)));
        } else if constexpr (D == 2) {  // one codeword
          const int sub = p >> 1;
          v = lds_u32(cbs + ((sub * k + lds_u8(ids_row + sub)) << 2));
        } else {  // D == 1: two codewords of two sub-spaces
          const uint32_t two = lds_u16(ids_row + p);
          const uint32_t lo = lds_u16(cbs + ((p * k + (two & 0xff)) << 1));
          const uint32_t up =
              lds_u16(cbs + (((p + 1) * k + (two >> 8)) << 1));
          v = lo | (up << 16);
        }
        f[4 * ks + 2 * hi + r] = v;
      }
    }
  }
}

// ---- shared-memory plan (the launcher and the kernel agree on it) -------

template <int NT, int D, bool kConv>
struct Layout {
  static constexpr int kXBytes = NT * 128;
  static constexpr int kIdBytes = kMT * (kKC / D);
  __host__ __device__ static int cb_chunk_bytes(int k) { return 2 * kKC * k; }
  __host__ __device__ static int stage_bytes(int k) {
    const int raw = kXBytes + kIdBytes + (kConv ? 0 : cb_chunk_bytes(k));
    return (raw + 1023) / 1024 * 1024;
  }
};

// ---- the kernel ----------------------------------------------------------

template <int NT, int D, bool kConv>
__global__ void __launch_bounds__(kThreads, 1)
decode_gemm_kernel(const Problem p, int stages, int cb_resident_bytes) {
  using L = Layout<NT, D, kConv>;
  // a consumer thread with 128 accumulators needs more registers than an
  // even share of the file: 56 * 128 + 224 * 256 = 168 * 384
  constexpr bool kRebalance = NT / 2 > 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int stage_bytes = L::stage_bytes(p.k);
  const uint32_t cb_res = base + stages * stage_bytes;
  const uint32_t bars = cb_res + cb_resident_bytes;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kMaxStages + st); };
  const uint32_t cb_full = bars + 16 * kMaxStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full(st), kProducers);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init(cb_full, kProducers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int taps = kConv ? p.kh * p.kh : 1;
  const long long m0 = static_cast<long long>(blockIdx.x) * NT;
  const int o0 = blockIdx.y * kMT;
  const int it_lo = blockIdx.z * p.its_per_split;
  const int it_hi = min(p.n_its, it_lo + p.its_per_split);
  const int chunk_lo = it_lo / taps;
  const int cb_chunk = L::cb_chunk_bytes(p.k);

  if (tid < kProducers) {
    // ===== producer warpgroup =====
    if constexpr (kRebalance) setmaxnreg_dec<56>();
    if (kConv && it_lo < it_hi) {  // the block's codebook chunks, resident
      const int n16 = ((it_hi - 1) / taps - chunk_lo + 1) * (cb_chunk / 16);
      const __nv_bfloat16* src =
          p.cb + static_cast<long long>(chunk_lo) * kKC * p.k;
      for (int i = tid; i < n16; i += kProducers)
        cp_async16(cb_res + i * 16, src + i * 8, true);
    }
    cp_async_arrive(cb_full);

    // This thread's X rows and its 16-byte group(s) of each (one group and
    // rows tid / 8 + 16 j up to NT = 128; two adjacent groups at 256). Per
    // row, the element offset of the input pixel that tap (0, 0) reads
    // (the launcher holds x and ids below 2^31 elements) and, for the conv,
    // the row's output pixel as (oh << 16) | ow; -1 marks a row past the
    // end. Per pair, a row then costs two compares and one add: no
    // division and no 64-bit product sits between two stages.
    constexpr int kG = NT > 128 ? NT / 128 : 1;  // adjacent groups a row
    constexpr int kRowStep = 16 * kG;            // rows a pass of the threads
    constexpr int kXV = (NT + kRowStep - 1) / kRowStep;
    const int c16 = (tid % (8 / kG)) * kG;
    const int row_lo = tid / (8 / kG);
    int row_off[kXV], row_hw[kXV];
#pragma unroll
    for (int j = 0; j < kXV; ++j) {
      const int row = row_lo + kRowStep * j;
      const long long m = m0 + row;
      const bool ok = row < NT && m < p.m_total;
      row_off[j] = 0;
      row_hw[j] = ok ? 0 : -1;
      if (ok && kConv) {
        const int howo = p.ho * p.wo;
        const int img = static_cast<int>(m / howo);
        const int rem = static_cast<int>(m % howo);
        const int oh = rem / p.wo, ow = rem % p.wo;
        row_off[j] = ((img * p.h + oh - p.pad) * p.w + ow - p.pad) * p.cin;
        row_hw[j] = (oh << 16) | ow;
      } else if (ok) {
        row_off[j] = static_cast<int>(m) * p.cin;
      }
    }
    // this thread's id copies: channel c / kIdV, 16-byte unit c % kIdV
    constexpr int kIdV = kKC / D / 16;
    int ids_off[kIdV];
#pragma unroll
    for (int j = 0; j < kIdV; ++j) {
      const int c = tid + j * kProducers;
      const int o = o0 + c / kIdV;
      ids_off[j] = o < p.cout ? o * taps * p.s + (c % kIdV) * 16 : -1;
    }

    int chunk = chunk_lo, tap = it_lo % taps;
    int ti = tap / p.kh, tj = tap % p.kh;
    int st = 0;
    uint32_t parity = 1;  // a fresh barrier's phase of parity 1 has passed
    for (int it = it_lo; it < it_hi; ++it) {
      mbar_wait(empty(st), parity);
      const uint32_t sbase = base + st * stage_bytes;
      const int x_off = (ti * p.w + tj) * p.cin + chunk * kKC + c16 * 8;
      const int lo_h = p.pad - ti, lo_w = p.pad - tj;  // first valid oh, ow
#pragma unroll
      for (int j = 0; j < kXV; ++j) {
        const int row = row_lo + kRowStep * j;
        if (row < NT) {
          bool ok = row_hw[j] >= 0;
          if (kConv) {  // 0 <= oh - lo_h < h and 0 <= ow - lo_w < w
            const unsigned ih = (row_hw[j] >> 16) - lo_h;
            const unsigned iw = (row_hw[j] & 0xffff) - lo_w;
            ok = ok && ih < static_cast<unsigned>(p.h) &&
                 iw < static_cast<unsigned>(p.w);
          }
#pragma unroll
          for (int gi = 0; gi < kG; ++gi)
            cp_async16(sbase + swizzle128(row, c16 + gi),
                       p.x + (ok ? row_off[j] + x_off + 8 * gi : 0), ok);
        }
      }
      // ids: 64 / D bytes a channel, 16 bytes a copy
      const uint32_t ids_s = sbase + L::kXBytes;
      const int id_off = tap * p.s + chunk * (kKC / D);
#pragma unroll
      for (int j = 0; j < kIdV; ++j) {
        const bool ok = ids_off[j] >= 0;
        cp_async16(ids_s + (tid + j * kProducers) * 16,
                   p.ids + (ok ? ids_off[j] + id_off : 0), ok);
      }
      if (!kConv) {  // the chunk's codebook span: 64 * K contiguous values
        const __nv_bfloat16* src =
            p.cb + static_cast<long long>(chunk) * kKC * p.k;
        const uint32_t cbs = ids_s + L::kIdBytes;
        for (int c = tid; c < cb_chunk / 16; c += kProducers)
          cp_async16(cbs + c * 16, src + c * 8, true);
      }
      cp_async_arrive(full(st));
      if (++st == stages) {
        st = 0;
        parity ^= 1;
      }
      // the next pair: taps inside a chunk, row-major
      if (++tap == taps) {
        tap = ti = tj = 0;
        ++chunk;
      } else if (++tj == p.kh) {
        tj = 0;
        ++ti;
      }
    }
    cp_async_wait_all();
  } else {
    // ===== consumer warpgroups =====
    if constexpr (kRebalance) setmaxnreg_inc<224>();
    const int ct = tid - kProducers;
    const int lane = ct & 31;
    const int g = lane >> 2, q = lane & 3;
    const int r0 = (ct >> 5) * 16 + g;  // tile-local channel; also r0 + 8
    constexpr int kIdRow = kKC / D;

    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) {
      acc[i] = 0.0f;
      keep(acc[i]);  // zeroed here, not between two groups in flight
    }
    uint32_t f0[16], f1[16];

    // `st`/`parity` follow the stage being decoded, `rel` the stage to
    // release next.
    const int n_its = it_hi - it_lo;
    int st = 0, rel = 0;
    uint32_t parity = 0;
    int tap = it_lo % taps;     // conv: tap of the stage being decoded and
    uint32_t cb_cur = cb_res;   // its chunk's codebook, resident

    // wait for stage i of the block's range and decode it into f
    auto fetch = [&](uint32_t(&f)[16], int i) {
      if (i > 0) {
        if (++st == stages) {
          st = 0;
          parity ^= 1;
        }
        if (kConv && ++tap == taps) {  // the next chunk's codebook
          tap = 0;
          cb_cur += cb_chunk;
        }
      }
      mbar_wait(full(st), parity);
      fence_proxy_async();
      const uint32_t sbase = base + st * stage_bytes;
      decode_frags<D>(f, sbase + L::kXBytes + r0 * kIdRow,
                      kConv ? cb_cur : sbase + L::kXBytes + L::kIdBytes, p.k,
                      q);
    };
    // start stage i's products from `cur`; stage i - 1 (read `other`) is then
    // the only older group: wait for it, release it, and decode stage
    // i + 1 into `other` while stage i runs
    auto step = [&](uint32_t(&cur)[16], uint32_t(&other)[16], int i) {
      const uint64_t desc = kmajor_desc(base + st * stage_bytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        Wgmma<NT>::rs(acc, cur + 4 * ks, desc + 2 * ks);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int j = 0; j < 16; ++j) keep(other[j]);
      if (i > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(rel));
        if (++rel == stages) rel = 0;
      }
      if (i + 1 < n_its) fetch(other, i + 1);
    };

    if (kConv) mbar_wait(cb_full, 0);
    if (n_its > 0) fetch(f0, 0);
    // two stages a trip, so that each register set has a fixed role and no
    // branch sits between a group's start and its wait; one may be left over
    int i = 0;
    for (; i + 1 < n_its; i += 2) {
      step(f0, f1, i);
      step(f1, f0, i + 1);
    }
    if (i < n_its) step(f0, f1, i);
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      keep(f0[j]);
      keep(f1[j]);
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) keep(acc[j]);

    // epilogue: acc[4 j + 2 e2 + e1] is channel r0 + 8 e2, row
    // 8 j + 2 q + e1; a warp's store covers 8 consecutive channels of 4
    // rows (32-byte runs)
    float* dst =
        p.out + static_cast<long long>(blockIdx.z) * p.m_total * p.cout;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int o = o0 + r0 + 8 * e2;
      if (o < p.cout) {
        const float b = p.add_bias ? __ldg(p.bias + o) : 0.0f;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const long long m = m0 + 8 * j + 2 * q + e1;
            if (m < p.m_total)
              dst[m * p.cout + o] = acc[4 * j + 2 * e2 + e1] + b;
          }
        }
      }
    }
  }
}

// out[i] = (ws[0][i] + ws[1][i] + ...) + bias[i % cout], in that order
static __global__ void split_reduce_kernel(const float* __restrict__ ws,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out,
                                           long long n, int cout,
                                           int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  float acc = ws[i];
  for (int z = 1; z < splits; ++z) acc += ws[z * n + i];
  out[i] = acc + __ldg(bias + i % cout);
}

// ---- host side -------------------------------------------------------------

// Launch the decode-GEMM (and the reduce when splits > 1). `p.out` is the
// final output; `ws` holds splits x m_total x cout floats when splits > 1.
template <int NT, int D, bool kConv>
int launch_decode_gemm(Problem p, float* ws, int splits,
                       cudaStream_t stream) {
  using L = Layout<NT, D, kConv>;
  const int taps = kConv ? p.kh * p.kh : 1;
  const int nchunks = p.cin / kKC;
  p.n_its = nchunks * taps;
  if (splits < 1 || splits > p.n_its || splits > 65535 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  p.its_per_split = (p.n_its + splits - 1) / splits;
  if ((p.n_its + p.its_per_split - 1) / p.its_per_split != splits)
    return static_cast<int>(cudaErrorInvalidValue);  // an empty split
  int cb_resident = 0;
  if (kConv) {
    const int chunks =
        std::min(nchunks, (p.its_per_split + taps - 2) / taps + 1);
    cb_resident = chunks * L::cb_chunk_bytes(p.k);
  }
  // as many stages as fit, at most kMaxStages and no more than the pairs
  const int stage = L::stage_bytes(p.k);
  const int stages = std::min(
      std::min(kMaxStages, std::max(p.its_per_split, kMinStages)),
      (kSmemLimit - kFixedSmem - cb_resident) / stage);
  if (stages < kMinStages) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kFixedSmem + stages * stage + cb_resident;
  static int smem_set = 0;  // per instantiation and process
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_gemm_kernel<NT, D, kConv>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const long long m_tiles = (p.m_total + NT - 1) / NT;
  const int o_tiles = (p.cout + kMT - 1) / kMT;
  if (m_tiles > 2147483647LL || o_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel indexes x and ids with 32-bit element offsets
  const long long x_elems = kConv ? p.m_total / (p.ho * p.wo) * p.h * p.w *
                                        p.cin
                                  : p.m_total * p.cin;
  if (x_elems > 2147483647LL ||
      static_cast<long long>(p.cout) * taps * p.s > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = p.out;
  p.add_bias = splits == 1;
  if (splits > 1) p.out = ws;
  dim3 grid(static_cast<unsigned>(m_tiles), o_tiles, splits);
  decode_gemm_kernel<NT, D, kConv>
      <<<grid, kThreads, smem, stream>>>(p, stages, cb_resident);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const long long n = p.m_total * p.cout;
  split_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        stream>>>(ws, p.bias, out, n, p.cout, splits);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace pq
