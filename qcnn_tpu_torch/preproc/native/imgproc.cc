// Native threaded image-preprocessing pipeline.
//
// The reference does BMP decode + bilinear resize + crop + mean-subtract in
// single-threaded C++ (src/BmpImgIO.cc:40-224, third-party
// include/bitmap_image.hpp). This is the production equivalent: the same
// pipeline, batch-oriented and parallelized over images with std::thread,
// exposed as a C ABI consumed via ctypes (qcnn_tpu/preproc/native/__init__.py).
//
// Semantics mirror qcnn_tpu/preproc/pipeline.py exactly (which in turn
// mirrors the reference):
//  - 24-bit BI_RGB BMP decode to float32 BGR HWC (BmpImgIO.cc:73-103)
//  - bilinear resize, STRICT (exact target) or RELAXED (aspect-preserving,
//    min scale) with align-corners scale factors and border-degenerate
//    weight renormalization (BmpImgIO.cc:105-178)
//  - center crop (BmpImgIO.cc:180-201)
//  - mean subtraction, FULL (subtract 256x256 mean then crop) or CROP
//    (crop then subtract cropped mean) order (BmpImgIO.cc:56-68)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread -o libimgproc.so imgproc.cc

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kEps = 1e-7;

struct Image {
  std::vector<float> data;  // HWC BGR
  int h = 0;
  int w = 0;
};

int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}

// 24-bit BI_RGB decode; returns false on unsupported input.
bool decode_bmp(const uint8_t* buf, int64_t len, Image* out) {
  if (len < 54 || buf[0] != 'B' || buf[1] != 'M') return false;
  uint32_t pixel_offset = rd_u32(buf + 10);
  uint32_t header_size = rd_u32(buf + 14);
  if (header_size < 40) return false;
  int32_t width = rd_i32(buf + 18);
  int32_t height = rd_i32(buf + 22);
  uint16_t bpp = rd_u16(buf + 28);
  uint32_t compression = rd_u32(buf + 30);
  if (bpp != 24 || compression != 0 || width <= 0) return false;
  bool top_down = height < 0;
  // Untrusted input (the HTTP /classify path feeds raw uploads here):
  // reject implausible dimensions up front so all later size arithmetic
  // stays far from int64 overflow, and phrase the length check as a
  // division so attacker-controlled width*height cannot wrap it.
  if (height == INT32_MIN) return false;
  height = std::abs(height);
  if (height == 0 || width > (1 << 16) || height > (1 << 16)) return false;
  int64_t row_bytes = (static_cast<int64_t>(width) * 3 + 3) & ~int64_t{3};
  int64_t off = static_cast<int64_t>(pixel_offset);
  if (off < 54 || off > len || row_bytes > (len - off) / height)
    return false;
  out->h = height;
  out->w = width;
  out->data.resize(static_cast<size_t>(height) * width * 3);
  for (int y = 0; y < height; ++y) {
    int src_y = top_down ? y : height - 1 - y;
    const uint8_t* row = buf + pixel_offset + row_bytes * src_y;
    float* dst = out->data.data() + static_cast<size_t>(y) * width * 3;
    for (int x = 0; x < width * 3; ++x) dst[x] = static_cast<float>(row[x]);
  }
  return true;
}

struct Taps {
  std::vector<int> lo, hi;
  std::vector<double> wlo, whi;
};

Taps make_taps(double scale, int n_out, int n_src) {
  Taps t;
  t.lo.resize(n_out);
  t.hi.resize(n_out);
  t.wlo.resize(n_out);
  t.whi.resize(n_out);
  for (int i = 0; i < n_out; ++i) {
    double c = scale * i;
    int lo = std::max(0, static_cast<int>(c));
    int hi = std::min(n_src - 1, lo + 1);
    t.lo[i] = lo;
    t.hi[i] = hi;
    t.wlo[i] = 1.0 - (c - lo);
    t.whi[i] = 1.0 - (hi - c);
  }
  return t;
}

// Bilinear resize with border weight renormalization (pipeline.py:42-80).
Image resize_bilinear(const Image& img, int out_h, int out_w, bool relaxed) {
  // out dims < 2 make the align-corners divisor 0 (NaN taps); a 1-pixel
  // SOURCE is fine under STRICT (taps clamp to pixel 0) but under RELAXED
  // makes s = 0 and the divisions below produce NaN/inf whose int cast is
  // UB (confirmed under UBSan). Signal failure via an empty image rather
  // than throwing: the ASan-preloaded sanitize gate cannot unwind
  // __cxa_throw from an instrumented lib under uninstrumented python.
  if (out_h < 2 || out_w < 2 || (relaxed && (img.h < 2 || img.w < 2))) {
    Image empty;
    empty.h = empty.w = 0;
    return empty;
  }
  double scale_h = static_cast<double>(img.h - 1) / (out_h - 1);
  double scale_w = static_cast<double>(img.w - 1) / (out_w - 1);
  if (relaxed) {
    double s = std::min(scale_h, scale_w);
    scale_h = scale_w = s;  // s > 0 guaranteed by the >=2px guard above
    out_h = static_cast<int>((img.h - 1) / s + kEps) + 1;
    out_w = static_cast<int>((img.w - 1) / s + kEps) + 1;
  }
  Taps th = make_taps(scale_h, out_h, img.h);
  Taps tw = make_taps(scale_w, out_w, img.w);
  Image out;
  out.h = out_h;
  out.w = out_w;
  out.data.resize(static_cast<size_t>(out_h) * out_w * 3);
  for (int y = 0; y < out_h; ++y) {
    const float* row_lo = img.data.data() + static_cast<size_t>(th.lo[y]) * img.w * 3;
    const float* row_hi = img.data.data() + static_cast<size_t>(th.hi[y]) * img.w * 3;
    float* dst = out.data.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      double wlt = th.wlo[y] * tw.wlo[x];
      double wrt = th.wlo[y] * tw.whi[x];
      double wlb = th.whi[y] * tw.wlo[x];
      double wrb = th.whi[y] * tw.whi[x];
      double den = wlt + wrt + wlb + wrb;
      const float* lt = row_lo + static_cast<size_t>(tw.lo[x]) * 3;
      const float* rt = row_lo + static_cast<size_t>(tw.hi[x]) * 3;
      const float* lb = row_hi + static_cast<size_t>(tw.lo[x]) * 3;
      const float* rb = row_hi + static_cast<size_t>(tw.hi[x]) * 3;
      for (int c = 0; c < 3; ++c) {
        double num = lt[c] * wlt + rt[c] * wrt + lb[c] * wlb + rb[c] * wrb;
        dst[x * 3 + c] = static_cast<float>(num / den);
      }
    }
  }
  return out;
}

bool center_crop_into(const Image& img, int crop_h, int crop_w,
                      const float* mean, int mean_h, int mean_w,
                      bool subtract_before_crop, float* dst) {
  // subtract_before_crop == FULL mean order: mean spans the full resized
  // image; else mean is cropped to crop size and subtracted after.
  int oy = (img.h - crop_h) / 2;
  int ox = (img.w - crop_w) / 2;
  int m_oy = (mean_h - crop_h) / 2;
  int m_ox = (mean_w - crop_w) / 2;
  // a resized image (or mean) smaller than the crop would make these
  // negative and the row pointers read out of bounds
  if (oy < 0 || ox < 0 || (!subtract_before_crop && (m_oy < 0 || m_ox < 0)) ||
      (subtract_before_crop && (mean_h < img.h || mean_w < img.w)))
    return false;
  for (int y = 0; y < crop_h; ++y) {
    const float* src = img.data.data() +
                       (static_cast<size_t>(y + oy) * img.w + ox) * 3;
    float* out_row = dst + static_cast<size_t>(y) * crop_w * 3;
    const float* mean_row =
        subtract_before_crop
            ? mean + (static_cast<size_t>(y + oy) * mean_w + ox) * 3
            : mean + (static_cast<size_t>(y + m_oy) * mean_w + m_ox) * 3;
    for (int i = 0; i < crop_w * 3; ++i) out_row[i] = src[i] - mean_row[i];
  }
  return true;
}

// Half-pixel-convention bilinear resize (pipeline.py
// resize_bilinear_halfpixel): the torch/standard-imaging convention used
// by the torch-ecosystem eval transform. Separable two-pass in double,
// matching the NumPy reference's accumulation order.
Image resize_halfpixel(const Image& img, int out_h, int out_w) {
  auto taps = [](int n_out, int n_src, std::vector<int>* lo,
                 std::vector<int>* hi, std::vector<double>* wlo,
                 std::vector<double>* whi) {
    lo->resize(n_out);
    hi->resize(n_out);
    wlo->resize(n_out);
    whi->resize(n_out);
    double scale = static_cast<double>(n_src) / n_out;
    for (int i = 0; i < n_out; ++i) {
      double c = (i + 0.5) * scale - 0.5;
      c = std::min(std::max(c, 0.0), static_cast<double>(n_src - 1));
      int l = static_cast<int>(c);
      (*lo)[i] = l;
      (*hi)[i] = std::min(n_src - 1, l + 1);
      (*whi)[i] = c - l;
      (*wlo)[i] = 1.0 - (*whi)[i];
    }
  };
  std::vector<int> hl, hh, wl, wh;
  std::vector<double> whl, whh, wwl, wwh;
  taps(out_h, img.h, &hl, &hh, &whl, &whh);
  taps(out_w, img.w, &wl, &wh, &wwl, &wwh);
  Image out;
  out.h = out_h;
  out.w = out_w;
  out.data.resize(static_cast<size_t>(out_h) * out_w * 3);
  std::vector<double> row(static_cast<size_t>(img.w) * 3);
  for (int y = 0; y < out_h; ++y) {
    const float* rlo = img.data.data() + static_cast<size_t>(hl[y]) * img.w * 3;
    const float* rhi = img.data.data() + static_cast<size_t>(hh[y]) * img.w * 3;
    for (size_t i = 0; i < row.size(); ++i)
      row[i] = rlo[i] * whl[y] + rhi[i] * whh[y];
    float* dst = out.data.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const double* l = row.data() + static_cast<size_t>(wl[x]) * 3;
      const double* r = row.data() + static_cast<size_t>(wh[x]) * 3;
      for (int c = 0; c < 3; ++c)
        dst[x * 3 + c] =
            static_cast<float>(l[c] * wwl[x] + r[c] * wwh[x]);
    }
  }
  return out;
}

}  // namespace

extern "C" {

// Decode + preprocess a batch of BMP buffers into out (N, crop_h, crop_w, 3)
// float32 BGR. Returns the number of failed images (their slots are zeroed).
//
// mean: (mean_h, mean_w, 3) float32 BGR. mean_full != 0 selects the FULL
// order (resize -> subtract full mean -> crop; requires the resized image to
// equal the mean's size, like AlexNet's 256x256); otherwise CROP order.
// relaxed != 0 selects aspect-preserving resize. threads <= 0 -> hardware
// concurrency.
int qcnn_preproc_batch(const uint8_t** buffers, const int64_t* lengths,
                       int n, int full_h, int full_w, int crop_h, int crop_w,
                       int relaxed, const float* mean, int mean_h, int mean_w,
                       int mean_full, float* out, int threads) {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 4;
  }
  threads = std::min(threads, n);
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  size_t out_stride = static_cast<size_t>(crop_h) * crop_w * 3;

  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      float* dst = out + out_stride * i;
      // An exception escaping a std::thread body calls std::terminate;
      // treat any failure (incl. bad_alloc on hostile dimensions) as a
      // per-image decode failure instead.
      try {
        Image img;
        if (!decode_bmp(buffers[i], lengths[i], &img)) {
          std::memset(dst, 0, out_stride * sizeof(float));
          failures.fetch_add(1);
          continue;
        }
        Image resized = resize_bilinear(img, full_h, full_w, relaxed != 0);
        bool full_order = mean_full != 0;
        if (resized.h == 0 ||
            (full_order &&
             (resized.h != mean_h || resized.w != mean_w))) {
          // degenerate resize, or FULL order without an exact-size mean
          // (pipeline.py raises here): fail rather than silently misalign
          std::memset(dst, 0, out_stride * sizeof(float));
          failures.fetch_add(1);
          continue;
        }
        if (!center_crop_into(resized, crop_h, crop_w, mean, mean_h, mean_w,
                              full_order, dst)) {
          std::memset(dst, 0, out_stride * sizeof(float));
          failures.fetch_add(1);
          continue;
        }
      } catch (...) {
        std::memset(dst, 0, out_stride * sizeof(float));
        failures.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

// torch-ecosystem eval transform (pipeline.py TorchPreprocessor): BGR->RGB,
// aspect-preserving shorter-side half-pixel bilinear resize to `resize`
// (other side >= crop), center crop to (crop, crop), v/255 then per-channel
// (v - mean[c]) / std[c]. out: (N, crop, crop, 3) float32 RGB normalized.
// Returns the number of failed images (their slots are zeroed).
int qcnn_preproc_batch_torch(const uint8_t** buffers, const int64_t* lengths,
                             int n, int resize, int crop, const float* mean3,
                             const float* std3, float* out, int threads) {
  if (threads <= 0) {
    threads = static_cast<int>(std::thread::hardware_concurrency());
    if (threads <= 0) threads = 4;
  }
  threads = std::min(threads, n);
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  size_t out_stride = static_cast<size_t>(crop) * crop * 3;

  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      float* dst = out + out_stride * i;
      try {
        Image img;
        if (!decode_bmp(buffers[i], lengths[i], &img)) {
          std::memset(dst, 0, out_stride * sizeof(float));
          failures.fetch_add(1);
          continue;
        }
        // BGR -> RGB in place
        for (size_t p = 0; p < img.data.size(); p += 3)
          std::swap(img.data[p], img.data[p + 2]);
        int oh, ow;
        if (img.h <= img.w) {
          oh = resize;
          // nearbyint = round-half-to-even, matching Python round()
          ow = std::max(crop, static_cast<int>(std::nearbyint(
                  static_cast<double>(img.w) * resize / img.h)));
        } else {
          ow = resize;
          oh = std::max(crop, static_cast<int>(std::nearbyint(
                  static_cast<double>(img.h) * resize / img.w)));
        }
        Image full = resize_halfpixel(img, oh, ow);
        int oy = (full.h - crop) / 2;
        int ox = (full.w - crop) / 2;
        if (oy < 0 || ox < 0) {
          // crop > resize (only the long side is clamped to crop above):
          // negative offsets would read before the buffer. The Python
          // binding rejects this config (TorchPreprocessor.__post_init__);
          // defend in depth for direct callers.
          std::memset(dst, 0, out_stride * sizeof(float));
          failures.fetch_add(1);
          continue;
        }
        for (int y = 0; y < crop; ++y) {
          const float* src = full.data.data() +
                             (static_cast<size_t>(y + oy) * full.w + ox) * 3;
          float* row = dst + static_cast<size_t>(y) * crop * 3;
          for (int x = 0; x < crop; ++x) {
            for (int c = 0; c < 3; ++c) {
              double v = static_cast<double>(src[x * 3 + c]) / 255.0;
              row[x * 3 + c] = static_cast<float>(
                  (v - static_cast<double>(mean3[c])) /
                  static_cast<double>(std3[c]));
            }
          }
        }
      } catch (...) {
        std::memset(dst, 0, out_stride * sizeof(float));
        failures.fetch_add(1);
      }
    }
  };

  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
