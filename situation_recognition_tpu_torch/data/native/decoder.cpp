// Native batch JPEG decode into 256x256x3 uint8 windows.
//
// The port's own copy of the JAX package's decoder (same source, same
// streams): one shared library doing multithreaded libjpeg decode straight
// into a caller-provided batch buffer, the GIL released for the whole
// batch (ctypes, data/native_decoder.py).
//
// Window semantics mirror data/transforms.py::host_window: images whose
// shorter side != 256 are first resized (separable ANTIALIASED triangle
// filter, PIL-BILINEAR-compatible; dims via Python round()) so the shorter
// side is 256, then a 256x256 window is cut — random offset along the long
// axis for training (deterministic splitmix64 stream keyed by
// (seed, epoch, index); also yields the horizontal-flip bit),
// torchvision-aligned center offset for eval.  The native augmentation
// stream is deterministic but distinct from the Python loader's numpy
// PCG64 stream: each loader is reproducible on its own.
//
// Build: data/native_decoder.py (g++ -O3 -shared -ljpeg into build/).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>  // requires <cstddef>/<cstdio> first (size_t, FILE)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kWindow = 256;

// ---------------------------------------------------------------- RNG

static inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// ---------------------------------------------------------------- JPEG

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

static void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to RGB8.  Returns true on success.
static bool decode_jpeg(const char* path, std::vector<uint8_t>& pixels,
                        int& width, int& height) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  width = cinfo.output_width;
  height = cinfo.output_height;
  if (cinfo.output_components != 3 || width <= 0 || height <= 0) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  pixels.resize(static_cast<size_t>(width) * height * 3);
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = pixels.data() + static_cast<size_t>(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// ------------------------------------------------------------- resize

// Python round(): round-half-to-EVEN.  The Python loader path computes its
// resize dims and center offsets with the builtin round, so the native
// path must match bit-for-bit or the two loaders cut different windows.
static inline long round_half_even(double v) {
  double f = std::floor(v);
  double diff = v - f;
  if (diff > 0.5) return static_cast<long>(f) + 1;
  if (diff < 0.5) return static_cast<long>(f);
  long lf = static_cast<long>(f);
  return (lf % 2 == 0) ? lf : lf + 1;
}

// PIL-style ANTIALIASED separable triangle-filter resampling coefficients
// for one axis (PIL ImagingResampleHorizontal/Vertical with the BILINEAR
// filter): when downscaling, the triangle support widens by the scale
// factor so every source pixel contributes — a plain 2-tap bilinear skips
// most source pixels at 4x downscale (measured mean 18 / max 96 uint8
// divergence vs PIL before this).  Weights here are float (PIL quantizes
// to 8-bit fixed point), so resized outputs agree with PIL to ~1-2 LSB
// rather than byte-exactly; the no-resize path stays byte-exact.
static void build_coeffs(int src, int dst, std::vector<int>& bounds,
                         std::vector<float>& weights, int& ksize) {
  const double scale = static_cast<double>(src) / dst;
  const double filterscale = std::max(scale, 1.0);
  const double support = 1.0 * filterscale;  // triangle filter support
  ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(dst) * 2, 0);
  weights.assign(static_cast<size_t>(dst) * ksize, 0.0f);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < dst; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(std::max(0.0, std::floor(center - support)));
    int xmax = static_cast<int>(
        std::min(static_cast<double>(src), std::ceil(center + support)));
    const int n = std::min(xmax - xmin, ksize);
    double sum = 0.0;
    for (int j = 0; j < n; ++j) {
      double d = std::fabs((xmin + j + 0.5 - center) / filterscale);
      k[j] = d < 1.0 ? 1.0 - d : 0.0;
      sum += k[j];
    }
    for (int j = 0; j < n; ++j) {
      weights[static_cast<size_t>(xx) * ksize + j] =
          static_cast<float>(sum > 0.0 ? k[j] / sum : 0.0);
    }
    bounds[static_cast<size_t>(xx) * 2] = xmin;
    bounds[static_cast<size_t>(xx) * 2 + 1] = n;
  }
}

static void resize_bilinear(const uint8_t* src, int sw, int sh,
                            uint8_t* dst, int dw, int dh) {
  std::vector<int> xb, yb;
  std::vector<float> xw, yw;
  int xk = 0, yk = 0;
  build_coeffs(sw, dw, xb, xw, xk);
  build_coeffs(sh, dh, yb, yw, yk);

  // horizontal pass (float intermediate)
  std::vector<float> tmp(static_cast<size_t>(dw) * sh * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int xmin = xb[static_cast<size_t>(x) * 2];
      const int n = xb[static_cast<size_t>(x) * 2 + 1];
      const float* k = xw.data() + static_cast<size_t>(x) * xk;
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int j = 0; j < n; ++j) {
        const uint8_t* p = srow + static_cast<size_t>(xmin + j) * 3;
        acc0 += k[j] * p[0];
        acc1 += k[j] * p[1];
        acc2 += k[j] * p[2];
      }
      trow[x * 3 + 0] = acc0;
      trow[x * 3 + 1] = acc1;
      trow[x * 3 + 2] = acc2;
    }
  }
  // vertical pass
  for (int y = 0; y < dh; ++y) {
    const int ymin = yb[static_cast<size_t>(y) * 2];
    const int n = yb[static_cast<size_t>(y) * 2 + 1];
    const float* k = yw.data() + static_cast<size_t>(y) * yk;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int i = 0; i < dw * 3; ++i) {
      float v = 0;
      for (int j = 0; j < n; ++j) {
        v += k[j] * tmp[static_cast<size_t>(ymin + j) * dw * 3 + i];
      }
      drow[i] = static_cast<uint8_t>(std::min(255.0f, std::max(0.0f, v + 0.5f)));
    }
  }
}

// ------------------------------------------------------------- window

// Mirror of transforms._center_offset: the reference center-crops AFTER
// resizing to 224-short-side with int(round(...)) (torchvision
// CenterCrop); compute that offset at the reference's scale and map it
// back into 256-space.  Python round() semantics throughout.
static int center_offset(int full) {
  if (full <= kWindow) return 0;
  int dim224 = static_cast<int>(round_half_even(full * 224.0 / 256.0));
  int off224 = static_cast<int>(round_half_even((dim224 - 224) / 2.0));
  long mapped = round_half_even(
      static_cast<double>(off224) * full / dim224);
  return static_cast<int>(
      std::min<long>(full - kWindow, mapped));
}

static bool make_window(const char* path, bool train, uint64_t seed,
                        uint64_t epoch, int64_t index, uint8_t* out,
                        uint8_t* flip_out) {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  if (!decode_jpeg(path, pixels, w, h)) return false;

  const uint8_t* img = pixels.data();
  std::vector<uint8_t> resized;
  if (std::min(w, h) != kWindow) {
    // dims with Python round() semantics — must match
    // transforms.normalize_short_side or the two loaders disagree
    double scale = static_cast<double>(kWindow) / std::min(w, h);
    int nw = std::max(kWindow, static_cast<int>(round_half_even(w * scale)));
    int nh = std::max(kWindow, static_cast<int>(round_half_even(h * scale)));
    resized.resize(static_cast<size_t>(nw) * nh * 3);
    resize_bilinear(pixels.data(), w, h, resized.data(), nw, nh);
    img = resized.data();
    w = nw;
    h = nh;
  }

  int ox, oy;
  uint8_t flip = 0;
  if (train) {
    uint64_t state = seed * 0x9E3779B97F4A7C15ULL + epoch * 0xD1B54A32D192ED03ULL
                     + static_cast<uint64_t>(index) + 1;
    oy = (h > kWindow) ? static_cast<int>(splitmix64(state) % (h - kWindow + 1)) : 0;
    ox = (w > kWindow) ? static_cast<int>(splitmix64(state) % (w - kWindow + 1)) : 0;
    flip = static_cast<uint8_t>(splitmix64(state) & 1);
  } else {
    oy = center_offset(h);
    ox = center_offset(w);
  }
  if (flip_out) *flip_out = flip;

  for (int y = 0; y < kWindow; ++y) {
    std::memcpy(out + static_cast<size_t>(y) * kWindow * 3,
                img + (static_cast<size_t>(oy + y) * w + ox) * 3,
                kWindow * 3);
  }
  return true;
}

}  // namespace

extern "C" {

// Decode a batch of JPEGs into (n, 256, 256, 3) uint8 windows.
//
//   paths     n NUL-terminated file paths
//   train     1 = random window + flip bit, 0 = center window
//   indices   n dataset indices (drive the deterministic RNG stream)
//   out       n*256*256*3 bytes
//   flips     n bytes (flip decisions; may be NULL for eval)
//   failed    n bytes: set to 1 where decode failed (caller falls back)
//
// Returns the number of failed images.
int srtpu_decode_window_batch(const char** paths, int n, int train,
                              uint64_t seed, uint64_t epoch,
                              const int64_t* indices, uint8_t* out,
                              uint8_t* flips, uint8_t* failed,
                              int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> nfail(0);
  num_threads = std::max(1, std::min(num_threads, n));

  auto worker = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < n) {
      uint8_t* dst = out + static_cast<size_t>(i) * kWindow * kWindow * 3;
      bool ok = make_window(paths[i], train != 0, seed, epoch, indices[i],
                            dst, flips ? flips + i : nullptr);
      failed[i] = ok ? 0 : 1;
      if (!ok) nfail.fetch_add(1);
    }
  };

  if (num_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return nfail.load();
}

}  // extern "C"
