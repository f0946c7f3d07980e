// Native bit-packing codec for the reference ".cbn" page format.
//
// TPU-native replacement for the reference's in-process byte loop
// (the reference's include/FileIO.h:110-178, :281-350): the same 4096-byte
// MSB-first page layout, implemented as a branch-free 64-bit shift register
// so host-side weight loading never bottlenecks device feeds.
//
// Exposed via ctypes (see __init__.py). All values are 0-based codeword
// indices; the ±1 MATLAB offset is handled by the Python layer.

#include <cstdint>
#include <cstring>

namespace {
constexpr int kPageBytes = 4096;
constexpr int kPageBits = kPageBytes * 8;
}  // namespace

extern "C" {

// Unpack `n` elements of width `bits` from pages[] into out[].
// pages must hold ceil(n / (kPageBits/bits)) * kPageBytes bytes.
void qcnn_unpack_pages(const uint8_t* pages, int64_t n, int bits,
                       uint32_t* out) {
  const int per_page = kPageBits / bits;
  const uint32_t mask = (bits >= 32) ? 0xffffffffu : ((1u << bits) - 1u);
  int64_t idx = 0;
  for (int64_t page_off = 0; idx < n; page_off += kPageBytes) {
    const uint8_t* p = pages + page_off;
    const int64_t count = (n - idx < per_page) ? (n - idx) : per_page;
    uint64_t acc = 0;  // bit accumulator, data in the low `have` bits
    int have = 0;
    int64_t byte_pos = 0;
    for (int64_t i = 0; i < count; ++i) {
      while (have < bits) {
        acc = (acc << 8) | p[byte_pos++];
        have += 8;
      }
      have -= bits;
      out[idx + i] = static_cast<uint32_t>(acc >> have) & mask;
    }
    idx += count;
  }
}

// Pack `n` elements of width `bits` from vals[] into pages[].
// pages must hold ceil(n / (kPageBits/bits)) * kPageBytes bytes; it is
// zeroed here (the reference zero-fills each page, FileIO.h:321).
void qcnn_pack_pages(const uint32_t* vals, int64_t n, int bits,
                     uint8_t* pages) {
  if (bits <= 0 || bits >= 32) return;  // (1u << bits) below is UB at 32
  const int per_page = kPageBits / bits;
  const int64_t n_pages = (n + per_page - 1) / per_page;
  memset(pages, 0, static_cast<size_t>(n_pages) * kPageBytes);
  int64_t idx = 0;
  for (int64_t page = 0; page < n_pages; ++page) {
    uint8_t* p = pages + page * kPageBytes;
    const int64_t count = (n - idx < per_page) ? (n - idx) : per_page;
    uint64_t acc = 0;
    int have = 0;
    int64_t byte_pos = 0;
    for (int64_t i = 0; i < count; ++i) {
      acc = (acc << bits) | (vals[idx + i] & ((1u << bits) - 1u));
      have += bits;
      while (have >= 8) {
        have -= 8;
        p[byte_pos++] = static_cast<uint8_t>(acc >> have);
      }
    }
    if (have > 0) {
      p[byte_pos++] = static_cast<uint8_t>(acc << (8 - have));
    }
    idx += count;
  }
}

}  // extern "C"
