// pq_decode: PQ weight decode for Hopper (sm_90a), one launch for a group
// of weights.
//
// Replaces qcnn_tpu/ops/pallas/pq_decode.py `_decode_sdn` (the pallas_calls
// at :132 `_decode_kernel_sdn` and :146 `_decode_kernel`), reached there by
// `decode_fc_weight_gather` and `decode_conv_kernel_gather`.
//
// Computes, for every item of the launch, row-major (N, C) with C <= S*D:
//     out[n, c] = cb[c / D, A[n, c / D], c % D]
// N = Cout*kh*kw gives a conv kernel in OHWI order (the layout the
// convolution takes as a channels_last OIHW weight); N = Cout gives an fc
// weight as (Cout, Cin). Columns past C (the overhang of the last
// sub-space) are not written. The decode is a bit copy, so the result is
// bit-identical to the plain gather.
//
// Bound: bytes. An item reads N*S id bytes and its codebook (at most 64 KB
// for the models' convs: it stays in L1 and L2) and writes N*C elements;
// there is no arithmetic, and the output dominates. What a model's step
// paid before was not bytes but launches: a weight of 83 KB and one of
// 1.9 MB both took 6 to 9 us flushed, and a ResNet-50 forward decoded 46 of
// them.
//
// Design:
// - a launch takes up to 16 items. Their descriptors travel as one kernel
//   argument, and every item owns a range of blocks (1024 vectors or 256 elements each), so a
//   residual block's or a whole AlexNet's weights decode in one launch;
// - the vector kernel: a thread writes 16 bytes of a row, the threads of a
//   warp consecutive vectors. It reads the 1, 2, 4 or 8 ids of its vector
//   as one word (where S allows), then the codewords as whole 2-, 4-, 8- or
//   16-byte loads, all four vectors of a thread before the first store;
//   offsets are 32-bit. It takes rows of whole vectors and codewords of a
//   power of two of bytes (2, 4, 8: several to a vector; 16 or more: a
//   vector is a piece of one);
// - the general kernel takes every other item (conv1's 3-channel rows, a
//   row length that cuts a codeword): one element a thread, 64-bit offsets.
// Which kernel an item runs is decided by ops/cuda/_plan.py `plan_decode`;
// the launcher validates it. The codebook is not staged in shared memory:
// a block would copy up to 64 KB to decode 16 KB, and the read-only path
// keeps it in L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;                  // vectors a thread
constexpr int kUnits = kThreads * kPerThread;  // vectors a block
constexpr int kElements = kThreads;            // general: elements a block
constexpr int kMaxItems = 16;

struct Item {
  const uint8_t* cb;
  const uint8_t* ids;
  uint8_t* out;
  long long units;  // 16-byte vectors (vector) or elements (general)
  int s, k, d, c_len, elem_bytes;
  int vector;       // 1: the vector kernel
  int cw_log2;      // vector: log2 of the codeword's bytes
  int vpr;          // vector: 16-byte vectors a row
  int ids_word;     // vector: the ids of a vector can be read as one word
  int block0;       // the item's first block
};

struct Table {
  int n_items;
  Item items[kMaxItems];
};

// the Q ids of a vector, id i in byte i
template <int Q>
__device__ __forceinline__ uint64_t load_ids(const uint8_t* p, bool word) {
  if (word) {
    if (Q == 8) return __ldg(reinterpret_cast<const unsigned long long*>(p));
    if (Q == 4) return __ldg(reinterpret_cast<const uint32_t*>(p));
    if (Q == 2) return __ldg(reinterpret_cast<const uint16_t*>(p));
  }
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < Q; ++i)
    v |= static_cast<uint64_t>(__ldg(p + i)) << (8 * i);
  return v;
}

// Vectors of Q = 16 / codeword bytes whole codewords (Q >= 2), or a
// 16-byte piece of one codeword (Q = 1).
template <int Q>
__device__ __forceinline__ void decode_vectors(const Item& it,
                                               uint32_t base) {
  const uint32_t units = static_cast<uint32_t>(it.units);
  uint32_t idx[kPerThread], sub[kPerThread], piece[kPerThread];
  uint64_t codes[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    idx[u] = base + u * kThreads + threadIdx.x;
    if (idx[u] < units) {
      const uint32_t n = idx[u] / it.vpr, v = idx[u] - n * it.vpr;
      // the first sub-space of the vector, and for Q = 1 its piece of the
      // codeword
      sub[u] = Q > 1 ? v * Q : (v << 4) >> it.cw_log2;
      piece[u] = (v << 4) & ((1u << it.cw_log2) - 1);
      codes[u] = load_ids<Q>(it.ids + n * it.s + sub[u], it.ids_word);
    }
  }
  uint4 val[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    if (idx[u] < units) {
      if constexpr (Q == 1) {
        val[u] = __ldg(reinterpret_cast<const uint4*>(
            it.cb + ((sub[u] * it.k + static_cast<uint32_t>(codes[u]))
                     << it.cw_log2) + piece[u]));
      } else {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < Q; ++i) {
          const uint32_t code = (codes[u] >> (8 * i)) & 0xff;
          const uint8_t* src =
              it.cb + ((sub[u] + i) * it.k + code) * (16 / Q);
          if constexpr (Q == 2) {
            const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
            w[2 * i] = t.x, w[2 * i + 1] = t.y;
          } else if constexpr (Q == 4) {
            w[i] = __ldg(reinterpret_cast<const uint32_t*>(src));
          } else {  // Q == 8: two codewords a word
            const uint32_t h = __ldg(reinterpret_cast<const uint16_t*>(src));
            w[i / 2] = i % 2 ? w[i / 2] | (h << 16) : h;
          }
        }
        val[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u)
    if (idx[u] < units)
      reinterpret_cast<uint4*>(it.out)[idx[u]] = val[u];
}

template <typename T>
__device__ __forceinline__ void decode_elements(const Item& it,
                                                long long base) {
  const T* cb = reinterpret_cast<const T*>(it.cb);
  T* out = reinterpret_cast<T*>(it.out);
  const long long i = base + threadIdx.x;
  if (i < it.units) {
    const long long n = i / it.c_len;
    const int c = static_cast<int>(i - n * it.c_len);
    const int sub = c / it.d;
    const int code = __ldg(it.ids + n * it.s + sub);
    out[i] = __ldg(cb + (static_cast<long long>(sub) * it.k + code) * it.d +
                   (c - sub * it.d));
  }
}

__global__ void __launch_bounds__(kThreads)
pq_decode_kernel(const __grid_constant__ Table table) {
  int i = 0;
  while (i + 1 < table.n_items &&
         static_cast<int>(blockIdx.x) >= table.items[i + 1].block0)
    ++i;
  const Item& it = table.items[i];
  const uint32_t block = blockIdx.x - it.block0;
  if (it.vector) {
    const uint32_t base = block * kUnits;
    switch (it.cw_log2) {
      case 1:
        return decode_vectors<8>(it, base);
      case 2:
        return decode_vectors<4>(it, base);
      case 3:
        return decode_vectors<2>(it, base);
      default:
        return decode_vectors<1>(it, base);
    }
  }
  const long long base = static_cast<long long>(block) * kElements;
  if (it.elem_bytes == 4) return decode_elements<uint32_t>(it, base);
  decode_elements<uint16_t>(it, base);
}

}  // namespace

// One item of a launch as the wrapper describes it. `vector` and `blocks`
// are the plan's (ops/cuda/_plan.py `plan_decode`); the launcher checks
// them against the shape.
struct PqDecodeItem {
  const void* cb;
  const void* ids;
  void* out;
  int n, s, k, d, c_len, elem_bytes, vector, blocks;
};

extern "C" int pq_decode_launch(const PqDecodeItem* items, int n_items,
                                cudaStream_t stream) {
  if (n_items < 1 || n_items > kMaxItems)
    return static_cast<int>(cudaErrorInvalidValue);
  Table table{};
  long long blocks = 0;
  for (int i = 0; i < n_items; ++i) {
    const PqDecodeItem& in = items[i];
    if (in.n < 0 || in.s < 1 || in.k < 1 || in.k > 256 || in.d < 1 ||
        in.c_len < 0 || in.c_len > in.s * in.d ||
        (in.elem_bytes != 2 && in.elem_bytes != 4))
      return static_cast<int>(cudaErrorInvalidValue);
    Item& it = table.items[table.n_items];
    it.cb = static_cast<const uint8_t*>(in.cb);
    it.ids = static_cast<const uint8_t*>(in.ids);
    it.out = static_cast<uint8_t*>(in.out);
    it.s = in.s, it.k = in.k, it.d = in.d, it.c_len = in.c_len;
    it.elem_bytes = in.elem_bytes;
    it.vector = in.vector;
    const long long cw = static_cast<long long>(in.d) * in.elem_bytes;
    const long long row_bytes =
        static_cast<long long>(in.c_len) * in.elem_bytes;
    if (in.vector) {
      // whole 16-byte vectors a row, a power-of-two codeword that a vector
      // holds whole or is a piece of, 32-bit offsets, aligned buffers
      const long long units = in.n * row_bytes / 16;
      if (row_bytes % 16 != 0 || (cw & (cw - 1)) != 0 || cw < 2 ||
          cw > 32768 || static_cast<long long>(in.n) * in.s > 2147483647LL ||
          static_cast<long long>(in.s) * in.k * cw > 2147483647LL ||
          units > 2147483647LL ||
          reinterpret_cast<uintptr_t>(in.cb) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(in.out) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      it.units = units;
      it.cw_log2 = 0;
      while ((1LL << it.cw_log2) < cw) ++it.cw_log2;
      it.vpr = static_cast<int>(row_bytes / 16);
      const int q = cw >= 16 ? 1 : static_cast<int>(16 / cw);
      it.ids_word = q > 1 && in.s % q == 0 &&
                    reinterpret_cast<uintptr_t>(in.ids) % q == 0;
    } else {
      it.units = static_cast<long long>(in.n) * in.c_len;
    }
    const int per_block = in.vector ? kUnits : kElements;
    const long long own = (it.units + per_block - 1) / per_block;
    if (own != in.blocks) return static_cast<int>(cudaErrorInvalidValue);
    if (own == 0) continue;  // an empty item owns no block
    it.block0 = static_cast<int>(blocks);
    blocks += own;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    ++table.n_items;
  }
  if (table.n_items == 0) return 0;
  pq_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      table);
  return static_cast<int>(cudaGetLastError());
}
