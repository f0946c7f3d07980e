// window_attention_fused: the window attention of a Swin block, or of a
// MaxViT block or grid partition, in one kernel, for Hopper (sm_90a): q k^T,
// the scale, the relative-position bias and shift mask, the softmax and the
// product with v, for every (window, head) of a batch, reading q, k and v in
// place from the qkv projection's output on the block's grid and writing o
// onto the grid.
//
// Two partitions of a G x G grid into windows of w x w tokens, nw = G / w
// windows a side, each a compile-time case of the kernel:
// - block (Swin, MaxViT's block attention): window (a, b) holds the
//   contiguous tokens at row a w + i, column b w + j, token (i, j);
// - grid (MaxViT's grid attention): window (a, b) holds the tokens spaced
//   nw apart, at row i nw + a, column j nw + b.
// Only the addressing of a window's first token, of a token within it and
// of o differs; the block case compiles to the code it had alone.
//
// Replaces no Pallas kernel: the JAX package has no Swin, and the port ran
// the attention as a chain of library calls (models/swin.py, its plain
// version window_attention_plain): the window partition, q
// k^T widened to float32 and summed without TF32, the division by
// sqrt(head dim), the bias added, the float32 softmax cast to bf16, the
// product with v, the head merge and the window reverse. It computes that
// chain's function at its rounding points, for a head dimension of 32 and
// windows of n <= 144 tokens:
//   s = float32 sum of the bf16 products q . k (exact products; the sum in
//       another order), times `scale` = float32(1 / sqrt(32)) as the card's
//       chain multiplies by the reciprocal, plus the float32 bias, each step
//       rounded in float32 as the chain rounds it (no fused multiply-add);
//   p = exp(s - row max) / row sum in float32 over the whole row (n keys
//       fit one tile, so no online rescaling), rounded once to bf16; the
//       division is a multiply by the row's float32 reciprocal, and exp is
//       2^x by `ex2.approx.ftz` from one fused multiply-add, each within a
//       few float32 ulps of the chain's, far below the bf16 rounding after;
//   o = float32 sum of p . v, emitted in bf16 or float32.
// The logits are never rounded to bf16.
//
// Bound: at Swin-L/4-w12@384 and B=128 a step's 24 blocks hold 380,928
// (window, head) pairs of n = 144 and hd 32: the two products are 1.01
// TFLOP (1.02 ms at 989 TFLOP/s) and one read of q, k, v and one write of o
// move 14.04 GB (4.19 ms at 3.35 TB/s), the biases another 0.13 GB; the
// softmax takes 7.9 G exp (2.0 ms at 16 a clock an SM). So the kernel is
// bound by bytes, with the softmax's instructions next.
//
// Design:
// - a block walks a contiguous range of work items (window position in the
//   image, head, image), the image fastest, so it holds one (position,
//   head) bias slice, n x n float32 (83 KB at n = 144), in shared memory
//   for up to the whole batch before it moves to the next slice; the grid
//   is the card's resident blocks, each with an equal share of the items
//   (to one);
// - q, k and v of a window (144 tokens x 64 bytes each) stream through a
//   3-window ring of shared memory by 16-byte `cp.async`, two windows ahead,
//   stored with the 64-byte swizzle that `wgmma` reads; rows past n of k and
//   v are zeros, and bias columns past n hold -inf, rows past n zeros;
// - the query rows are ceil(n / 64) row tiles of 64, one warpgroup each
//   (n = 144: three, the last with 16 real rows); a thread loads its q rows
//   as `wgmma`'s A operand from the ring (registers), S = Q K^T is one
//   m64n144k16 `wgmma` per 16 of the head dimension (K-major B), the
//   whole row in registers (72 accumulators a thread at n = 144);
// - the scale, bias, max, exp, sum and division run on the accumulators,
//   packed to bf16 in the layout of the A operand of P V, which is
//   m64n32k16 `wgmma` over 144 / 16 steps with V MN-major (the transpose
//   flag set);
// - o goes straight from the accumulators to its token's place on the grid,
//   the heads merged: no partition, head split, merge or reverse copy.
// Measured at Swin-L's B=128 (H100 80GB HBM3, 700 W): 10.36 ms for the 24
// blocks of a forward, 41 % of the byte bound; the chain took 187 ms.
// Compiled for windows padded to 144 tokens (n <= 144, Swin's windows up
// to 12 x 12: three warpgroups, one block an SM; a smaller window leaves
// warpgroups idle). A larger window takes the plain chain. The grid case
// reads each token's 64 bytes of q, k and v from rows nw apart: the same
// bytes in 64-byte pieces, where the block case reads runs of w tokens.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "sm90.cuh"

namespace {

constexpr int kHd = 32;             // head dimension
constexpr int kRowBytes = 2 * kHd;  // one token's q, k or v of a head
constexpr int kStages = 3;          // windows in the shared-memory ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kN = 144;  // tokens a window is padded to: 12 x 12
constexpr int kWarpgroups = 3;  // one a row tile of 64 of the kN rows
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTile = kN * kRowBytes;  // q, k or v of one window
constexpr int kStage = 3 * kTile;
// floats a bias row in shared memory: 8 or 24 banks apart mod 32, so a
// warp's float2 reads of 8 rows fall on distinct banks
constexpr int kBiasStride = kN + 8;
constexpr int kSmem = 1024 + kStages * kStage + kN * kBiasStride * 4;
// 16-byte copies of q, k and v a thread makes for each window
constexpr int kSlots = (12 * kN + kThreads - 1) / kThreads;

struct Args {
  const __nv_bfloat16* qkv;  // (B, G, G, 3 H 32) by element strides sb,
  long long sb, sy, sx;      // sy, sx; q, k, v at channel 0, C, 2C
  const float* bias;         // (position, head) slice at p bw + h bh, n x n
  long long bw, bh;
  void* out;  // (B, G, G, H 32), dense
  int batch, grid, window, heads, n;
  float scale;
  int out_bf16;
};

// Byte offset of 16-byte group `c16` (0..3) of row `row` in a tile of
// 64-byte rows stored with the 64-byte swizzle (address bits 4-5 XOR bits
// 7-8); the tile starts on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swizzle64(int row, int c16) {
  return static_cast<uint32_t>(row * kRowBytes +
                               ((c16 ^ ((row >> 1) & 3)) << 4));
}

// wgmma descriptor of a K-major, 64-byte-swizzled tile at `addr` (+ 32
// bytes per k16 step): 8-row groups 512 bytes apart, layout type 2
__device__ __forceinline__ uint64_t kmajor_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (32ull << 32) | (2ull << 62);
}

// The same tile read as an MN-major B operand (the transpose flag set):
// its 64-byte rows run along K, each the 32 values of N, and a k16 step
// advances 16 rows (1024 bytes). Along K the 8-row groups lie 512 bytes
// apart; with N = 32 there is no second group along N, so both offsets of
// the descriptor hold 512 bytes.
__device__ __forceinline__ uint64_t mnmajor_desc64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (32ull << 16) |
         (32ull << 32) | (2ull << 62);
}

// S (+)= Q K^T over one k16 step: m64n144k16, bf16 operands, float32
// accumulators, A from registers (see pq_wgmma.cuh for the fragment
// layouts), B K-major from shared memory. <false> overwrites S (its
// registers are outputs only, so nothing of them lives on from the last
// tile), <true> adds to it.
template <bool kAcc>
__device__ __forceinline__ void qk_mma(float (&d)[72], const uint32_t* a,
                                       uint64_t desc) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71}, "
        "{%72, %73, %74, %75}, %76, p, 1, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %77, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71}, "
        "{%72, %73, %74, %75}, %76, p, 1, 1, 0;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
          "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
          "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
          "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
          "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
          "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
          "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
          "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
          "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63]), "=f"(d[64]),
          "=f"(d[65]), "=f"(d[66]), "=f"(d[67]), "=f"(d[68]), "=f"(d[69]),
          "=f"(d[70]), "=f"(d[71])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(0));
  }
}

// O (+)= P V over one k16 step: m64n32k16, V MN-major (the transpose
// flag); <false> overwrites O, <true> adds to it
template <bool kAcc>
__device__ __forceinline__ void pv_mma(float (&d)[16], const uint32_t* a,
                                       uint64_t desc) {
  if constexpr (kAcc) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
          "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
          "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
          "=f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
          "r"(0));
  }
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

// the bias of row r, column c of the slice at `gb` (global), as the
// shared-memory copy holds it: -inf past n columns, 0 past n rows
__device__ __forceinline__ float bias_at(const float* gb, int r, int c,
                                         int n) {
  if (c >= n) return -INFINITY;
  return r < n ? __ldg(gb + r * n + c) : 0.0f;
}

// a work item: image b, head h, window (wy, wx) of the image's windows;
// next() steps to the following item, the image fastest
struct Item {
  int b, h, wy, wx;
  __device__ __forceinline__ void next(int batch, int heads, int nwx) {
    if (++b < batch) return;
    b = 0;
    if (++h < heads) return;
    h = 0;
    if (++wx < nwx) return;
    wx = 0;
    ++wy;
  }
};

template <bool kGrid>
__global__ void __launch_bounds__(kThreads, 1)
    window_attention_fused_kernel(const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = pq::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);  // 1024-aligned
  float* const sbias = reinterpret_cast<float*>(smem + kStages * kStage);
  const int tid = threadIdx.x;
  const int lane = tid & 31, g = lane >> 2, q4 = lane & 3;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int n = a.n, w = a.window;
  const int nwx = a.grid / w;
  const int c_all = a.heads * kHd;  // channels of q (of k, of v, of o)
  // grid rows (and columns) between two tokens of a window, and between
  // the first tokens of two neighbouring windows
  const int tstep = kGrid ? nwx : 1;
  const int wstep = kGrid ? 1 : w;

  // this block's work items: (position, head, image), the image fastest,
  // items first .. first + count - 1 (the launcher keeps their number in
  // 31 bits)
  const int total = nwx * nwx * a.heads * a.batch;
  const int first = static_cast<int>(
      static_cast<long long>(total) * blockIdx.x / gridDim.x);
  const int count = static_cast<int>(
      static_cast<long long>(total) * (blockIdx.x + 1) / gridDim.x - first);
  Item ld, cur;  // the next item to load and the one to compute
  {
    const int slice = first / a.batch, pos = slice / a.heads;
    ld.b = first - slice * a.batch;
    ld.h = slice - pos * a.heads;
    ld.wy = pos / nwx;
    ld.wx = pos - ld.wy * nwx;
    cur = ld;
  }

  // the 16-byte copies this thread makes of every window: copy i is group
  // i % 4 of q (i / 4 % 3 = 0), k (1) or v (2) of token i / 12
  int src[kSlots];
  uint32_t dst[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = tid + j * kThreads;
    src[j] = -1;
    dst[j] = 0;
    if (i < 12 * n) {
      const int r = i / 12, part = (i >> 2) % 3, c = i & 3;
      const int ty = r / w, tx = r - ty * w;
      src[j] = static_cast<int>((ty * tstep) * a.sy + (tx * tstep) * a.sx) +
               part * c_all + 8 * c;
      dst[j] = part * kTile + swizzle64(r, c);
    }
  }
  // window t's q, k and v into stage t % kStages, one commit group a
  // window (empty past the last); called for t = 0, 1, 2, ... in turn
  auto load = [&](int t) {
    if (t < count) {
      const __nv_bfloat16* p = a.qkv + ld.b * a.sb + (ld.wy * wstep) * a.sy +
                               (ld.wx * wstep) * a.sx + ld.h * kHd;
      const uint32_t st = base + (t % kStages) * kStage;
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        if (src[j] >= 0) pq::cp_async16(st + dst[j], p + src[j], true);
      ld.next(a.batch, a.heads, nwx);
    }
    pq::cp_async_commit();
  };

  // rows n..kN - 1 of q, k and v are zeros in every stage (the copies
  // write rows below n only): keys past n then give finite logits, masked
  // by the bias, and zero rows of V
  if (n < kN) {
    const int pad = (kN - n) * 4;
    for (int i = tid; i < kStages * 3 * pad; i += kThreads) {
      const int s = i / (3 * pad), rem = i - s * 3 * pad;
      const int part = rem / pad, k = rem - part * pad;
      *reinterpret_cast<uint4*>(smem + s * kStage + part * kTile +
                                swizzle64(n + (k >> 2), k & 3)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load(t);


  for (int t = 0; t < count; ++t, cur.next(a.batch, a.heads, nwx)) {
    pq::cp_async_wait<kStages - 2>();  // this thread's copies of window t
    pq::fence_proxy_async();
    // everyone's copies of window t are in; everyone is done with window
    // t - 1, whose stage window t + 2 goes to, and with the bias
    __syncthreads();
    load(t + kStages - 1);
    const int b = cur.b, h = cur.h, wy = cur.wy, wx = cur.wx;
    const float* gb = a.bias + (wy * nwx + wx) * a.bw + h * a.bh;
    if (t == 0 || b == 0) {  // a new (position, head)
      // 16 loads in flight a thread, then their stores
      for (int i0 = tid; i0 < kN * kN; i0 += 16 * kThreads) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int i = i0 + u * kThreads, r = i / kN;
          v[u] = i < kN * kN ? bias_at(gb, r, i - r * kN, n) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int i = i0 + u * kThreads, r = i / kN;
          if (i < kN * kN) sbias[r * kBiasStride + i - r * kN] = v[u];
        }
      }
      __syncthreads();
    }
    const uint32_t st = base + (t % kStages) * kStage;

    for (int tile = wg; tile * 64 < n; tile += kWarpgroups) {
      const int rw = tile * 64 + warp * 16;  // this warp's first row
      const int r0 = rw + g;                 // this thread's: r0, r0 + 8
      const bool live = rw < n;              // the warp has a real row
      uint32_t qf[8];
      // Q as A fragments: qf[4 ks + 2 hi + r] = q[r0 + 8 r, c .. c + 1] at
      // c = 16 ks + 8 hi + 2 q4
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            qf[4 * ks + 2 * hi + r] =
                live ? pq::lds_u32(st + swizzle64(r0 + 8 * r, 2 * ks + hi) +
                                   4 * q4)
                     : 0u;

      float s[kN / 2], o[16];  // written by the first k16 step of each
      uint32_t pf[kN / 4];
      const uint64_t kd = kmajor_desc64(st + kTile);
      pq::wgmma_fence();
      qk_mma<false>(s, qf, kd);
      qk_mma<true>(s, qf + 4, kd + 2);
      pq::wgmma_commit();
      pq::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) pq::keep(s[i]);
#pragma unroll
      for (int i = 0; i < 8; ++i) pq::keep(qf[i]);

      // accumulator 4 j + 2 r + e is row r0 + 8 r, column 8 j + 2 q4 + e
      if (live) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          const int c = 8 * j + 2 * q4;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 bb = *reinterpret_cast<const float2*>(
                sbias + (r0 + 8 * r) * kBiasStride + c);
            float& x0 = s[4 * j + 2 * r];
            float& x1 = s[4 * j + 2 * r + 1];
            x0 = __fadd_rn(__fmul_rn(x0, a.scale), bb.x);
            x1 = __fadd_rn(__fmul_rn(x1, a.scale), bb.y);
            mx[r] = fmaxf(mx[r], fmaxf(x0, x1));
          }
        }
        float neg[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // a row lies on 4 lanes
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          neg[r] = -mx[r] * kLog2e;  // finite: a row has a real key
        }
#pragma unroll
        for (int i = 0; i < kN / 2; ++i) {
          const int r = (i >> 1) & 1;
          s[i] = ex2(fmaf(s[i], kLog2e, neg[r]));
          sum[r] += s[i];
        }
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          inv[r] = 1.0f / sum[r];
        }
        // P's pair 2 j + r (row r, columns 8 j + 2 q4 + {0, 1}) is A
        // fragment register 2 j + r of P V
#pragma unroll
        for (int i = 0; i < kN / 4; ++i)
          pf[i] = pack_bf16(__fmul_rn(s[2 * i], inv[i & 1]),
                            __fmul_rn(s[2 * i + 1], inv[i & 1]));
      } else {
#pragma unroll
        for (int i = 0; i < kN / 4; ++i) pf[i] = 0u;
      }

      pq::wgmma_fence();
      const uint32_t vt = st + 2 * kTile;  // + 16 rows a k16 step
      pv_mma<false>(o, pf, mnmajor_desc64(vt));
#pragma unroll
      for (int ks = 1; ks < kN / 16; ++ks)
        pv_mma<true>(o, pf + 4 * ks,
                     mnmajor_desc64(vt + ks * 16 * kRowBytes));
      pq::wgmma_commit();
      pq::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 16; ++i) pq::keep(o[i]);
#pragma unroll
      for (int i = 0; i < kN / 4; ++i) pq::keep(pf[i]);

      // o of row r0 + 8 r to its token's place, columns 8 j + 2 q4 + e
      if (live) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          if (row < n) {
            const int ty = row / w, tx = row - ty * w;
            const long long tok =
                (static_cast<long long>(b) * a.grid + wy * wstep +
                 ty * tstep) * a.grid +
                wx * wstep + tx * tstep;
            const long long at = tok * c_all + h * kHd + 2 * q4;
            if (a.out_bf16) {
              __nv_bfloat16* d = static_cast<__nv_bfloat16*>(a.out) + at;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                *reinterpret_cast<uint32_t*>(d + 8 * j) =
                    pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
            } else {
              float* d = static_cast<float*>(a.out) + at;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                *reinterpret_cast<float2*>(d + 8 * j) =
                    make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
            }
          }
        }
      }
    }
  }
  pq::cp_async_wait<0>();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <bool kGrid>
int launch(const Args& a, cudaStream_t stream) {
  auto* kernel = window_attention_fused_kernel<kGrid>;
  static int resident = 0;  // blocks the card holds at once; per process
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = sms * per_sm;
  }
  const long long nw = a.grid / a.window;
  const long long total = nw * nw * a.heads * a.batch;
  const int blocks = static_cast<int>(total < resident ? total : resident);
  kernel<<<blocks, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv: (B, G, G, 3 H hd) bf16 by element strides (batch, grid row, grid
// column; the channels dense), 16-byte aligned with strides of whole
// 16-byte groups; q, k and v of head h at channels h hd, C + h hd and
// 2 C + h hd (C = H hd). bias: float32, the (n, n) slice of window position
// p (row-major within the image's windows) and head h dense at bias +
// p bias_sw + h bias_sh (0 strides broadcast). out: a dense (B, G, G, C)
// tensor of out_dtype (0 float32, 1 bf16). hd must be 32, n = window^2 at
// most 144, and window must divide G. partition 0: block (contiguous
// windows), 1: grid (windows of tokens G / window apart).
extern "C" int window_attention_fused_launch(
    const void* qkv, long long sb, long long sy, long long sx,
    const void* bias, long long bias_sw, long long bias_sh, void* out,
    int batch, int grid, int window, int heads, int hd, float scale,
    int out_dtype, int partition, cudaStream_t stream) {
  if (hd != kHd || batch < 0 || heads < 1 || window < 1 || grid < window ||
      grid % window || window * window > kN ||
      (out_dtype != 0 && out_dtype != 1) || !(scale > 0) || bias_sw < 0 ||
      bias_sh < 0 || (partition != 0 && partition != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  if (sb % 8 || sy % 8 || sx % 8 || sy < 0 || sx < 0 || sb < 0 ||
      !aligned(qkv, 16) || !aligned(out, 16) || !aligned(bias, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  // a window's copies address q, k and v from its first token in 32 bits,
  // and the work items (window, head, image) count in 31
  const long long nw = grid / window;
  const long long tstep = partition ? nw : 1;
  if ((window - 1) * tstep * (sy + sx) + 3LL * heads * kHd >= (1LL << 31) ||
      nw * nw * heads * batch >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.qkv = static_cast<const __nv_bfloat16*>(qkv);
  a.sb = sb;
  a.sy = sy;
  a.sx = sx;
  a.bias = static_cast<const float*>(bias);
  a.bw = bias_sw;
  a.bh = bias_sh;
  a.out = out;
  a.batch = batch;
  a.grid = grid;
  a.window = window;
  a.heads = heads;
  a.n = window * window;
  a.scale = scale;
  a.out_bf16 = out_dtype;
  return partition ? launch<true>(a, stream) : launch<false>(a, stream);
}
