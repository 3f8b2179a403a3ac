// vctdata — native data-plane for the vae_cyclegan_tpu_torch host pipeline
// (a copy of vae_cyclegan_tpu/data/native/vctdata.cpp).
//
// The reference trains through torch DataLoader workers doing PIL decode
// (reference train.py:225,283,342); this pipeline moves augmentation onto
// the device (data/device_aug.py) and caches decoded frames
// (data/cache.py), leaving decode and batch-gather as the host's hot
// loop. This extension does both outside the Python GIL with a small
// std::thread fan-out:
//
//   vct_probe_rgb    read only the header -> (w, h)
//   vct_decode_rgb   PNG (libpng) / JPEG (libjpeg-turbo) -> RGB8
//   vct_decode_many  threaded batch decode into caller buffers
//   vct_gather       threaded strided memcpy (cache-slice -> batch)
//
// Build: g++ -O3 -march=native -shared -fPIC vctdata.cpp -lpng -ljpeg -lz
// (driven by vae_cyclegan_tpu_torch/data/native/__init__.py into
// build/data/; pure fallback to PIL when the toolchain or libraries are
// absent).
#include <png.h>

#include <atomic>
#include <cstdio>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#include <csetjmp>
// jpeglib must come after stdio
#include <jpeglib.h>

namespace {

constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrDecode = -3;
constexpr int kErrCapacity = -4;

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool is_png(const unsigned char* sig) {
  return png_sig_cmp(sig, 0, 8) == 0;
}

bool is_jpeg(const unsigned char* sig) {
  return sig[0] == 0xFF && sig[1] == 0xD8;
}

int read_sig(FILE* f, unsigned char sig[8]) {
  if (fread(sig, 1, 8, f) != 8) return kErrFormat;
  rewind(f);
  return 0;
}

// ---- PNG ----------------------------------------------------------------

int decode_png(FILE* f, unsigned char* out, long cap, int* w, int* h,
               bool probe_only) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrDecode;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErrDecode;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrDecode;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  if (probe_only) {
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }
  long need = 3L * width * height;
  if (need > cap) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrCapacity;
  }
  // normalize everything to RGB8 (palette/gray/alpha). 16-bit PNGs are
  // REJECTED rather than stripped: png_set_strip_16 keeps the high byte,
  // while the PIL fallback's Image.convert("RGB") clamps I;16 values to
  // 255 — two silently different pixel semantics depending on whether the
  // native build succeeded. Returning kErrFormat routes every 16-bit file
  // through the single PIL path.
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrFormat;
  }
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color & PNG_COLOR_MASK_ALPHA || png_get_valid(png, info, PNG_INFO_tRNS))
    png_set_strip_alpha(png);
  png_read_update_info(png, info);
  std::vector<png_bytep> rows(height);
  for (png_uint_32 r = 0; r < height; ++r) rows[r] = out + 3L * width * r;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

// ---- JPEG ---------------------------------------------------------------

int decode_jpeg(FILE* f, unsigned char* out, long cap, int* w, int* h,
                bool probe_only) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrDecode;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  *w = static_cast<int>(cinfo.image_width);
  *h = static_cast<int>(cinfo.image_height);
  if (probe_only) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  long need = 3L * cinfo.output_width * cinfo.output_height;
  if (need > cap) {
    jpeg_destroy_decompress(&cinfo);
    return kErrCapacity;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + 3L * cinfo.output_width * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int decode_or_probe(const char* path, unsigned char* out, long cap, int* w,
                    int* h, bool probe_only) {
  FILE* f = fopen(path, "rb");
  if (!f) return kErrOpen;
  unsigned char sig[8];
  int rc = read_sig(f, sig);
  if (rc == 0) {
    if (is_png(sig)) {
      rc = decode_png(f, out, cap, w, h, probe_only);
    } else if (is_jpeg(sig)) {
      rc = decode_jpeg(f, out, cap, w, h, probe_only);
    } else {
      rc = kErrFormat;
    }
  }
  fclose(f);
  return rc;
}

void parallel_for(int n, int nthreads, const std::function<void(int)>& fn) {
  if (nthreads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  auto worker = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  int nt = std::min(nthreads, n);
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

int vct_probe_rgb(const char* path, int* w, int* h) {
  return decode_or_probe(path, nullptr, 0, w, h, true);
}

int vct_decode_rgb(const char* path, unsigned char* out, long cap, int* w,
                   int* h) {
  return decode_or_probe(path, out, cap, w, h, false);
}

// Decode n images into caller-provided buffers. outs[i] must hold caps[i]
// bytes; whs[2*i], whs[2*i+1] receive (w, h); rcs[i] the per-image status.
void vct_decode_many(const char** paths, int n, unsigned char** outs,
                     const long* caps, int* whs, int* rcs, int nthreads) {
  parallel_for(n, nthreads, [&](int i) {
    rcs[i] = decode_or_probe(paths[i], outs[i], caps[i], &whs[2 * i],
                             &whs[2 * i + 1], false);
  });
}

// Gather n variable-sized slices of `blob` into `out` back-to-back at
// the given destination offsets (threaded memcpy).
void vct_gather(const unsigned char* blob, const long* src_off,
                const long* sizes, const long* dst_off, int n,
                unsigned char* out, int nthreads) {
  parallel_for(n, nthreads, [&](int i) {
    memcpy(out + dst_off[i], blob + src_off[i],
           static_cast<size_t>(sizes[i]));
  });
}

}  // extern "C"

// ---- Resize (Pillow-compatible separable resampling) --------------------
//
// Mirrors Pillow's Resample.c: per-output-pixel weight windows with
// support scaled by max(in/out, 1), normalized, applied horizontally
// then vertically with an 8-bit intermediate (as Pillow does), float
// accumulation and round-half-away rounding. filter: 0 = bilinear
// (triangle, support 1), 1 = bicubic (Keys a=-0.5, support 2).

namespace {

double filt_bilinear(double x) {
  x = x < 0 ? -x : x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

double filt_bicubic(double x) {
  constexpr double a = -0.5;
  x = x < 0 ? -x : x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Weights {
  std::vector<float> w;     // bounds-normalized weights, kmax per pixel
  std::vector<int> lo;      // first source index per output pixel
  std::vector<int> cnt;     // window length per output pixel
  int kmax = 0;
};

Weights make_weights(int in_size, int out_size, int filter) {
  double support = filter == 1 ? 2.0 : 1.0;
  double (*fn)(double) = filter == 1 ? filt_bicubic : filt_bilinear;
  double scale = static_cast<double>(in_size) / out_size;
  double fscale = scale < 1.0 ? 1.0 : scale;
  double supp = support * fscale;
  Weights ws;
  ws.kmax = static_cast<int>(supp * 2.0 + 2.0);
  ws.w.assign(static_cast<size_t>(out_size) * ws.kmax, 0.0f);
  ws.lo.assign(out_size, 0);
  ws.cnt.assign(out_size, 0);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale;
    int xmin = static_cast<int>(center - supp + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + supp + 0.5);
    if (xmax > in_size) xmax = in_size;
    ws.lo[i] = xmin;
    ws.cnt[i] = xmax - xmin;
    double sum = 0.0;
    std::vector<double> tmp(xmax - xmin);
    for (int j = xmin; j < xmax; ++j) {
      double v = fn((j - center + 0.5) / fscale);
      tmp[j - xmin] = v;
      sum += v;
    }
    for (int j = 0; j < xmax - xmin; ++j) {
      ws.w[static_cast<size_t>(i) * ws.kmax + j] =
          sum != 0.0 ? static_cast<float>(tmp[j] / sum) : 0.0f;
    }
  }
  return ws;
}

inline unsigned char clip8(float v) {
  int iv = static_cast<int>(v + 0.5f);
  if (iv < 0) return 0;
  if (iv > 255) return 255;
  return static_cast<unsigned char>(iv);
}

}  // namespace

extern "C" {

// src points at the crop origin inside a larger image whose row pitch is
// src_stride bytes; (sh, sw) is the crop size. dst is (oh, ow, 3) packed.
void vct_resize_rgb8(const unsigned char* src, int sh, int sw,
                     long src_stride, unsigned char* dst, int oh, int ow,
                     int filter) {
  Weights wx = make_weights(sw, ow, filter);
  Weights wy = make_weights(sh, oh, filter);
  // horizontal pass: (sh, sw) -> (sh, ow), 8-bit intermediate (as PIL)
  std::vector<unsigned char> mid(static_cast<size_t>(sh) * ow * 3);
  for (int r = 0; r < sh; ++r) {
    const unsigned char* row = src + static_cast<size_t>(r) * src_stride;
    unsigned char* orow = mid.data() + static_cast<size_t>(r) * ow * 3;
    for (int i = 0; i < ow; ++i) {
      const float* w = &wx.w[static_cast<size_t>(i) * wx.kmax];
      const unsigned char* px = row + 3L * wx.lo[i];
      int n = wx.cnt[i];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      for (int j = 0; j < n; ++j) {
        float c = w[j];
        acc0 += c * px[3 * j];
        acc1 += c * px[3 * j + 1];
        acc2 += c * px[3 * j + 2];
      }
      orow[3 * i] = clip8(acc0);
      orow[3 * i + 1] = clip8(acc1);
      orow[3 * i + 2] = clip8(acc2);
    }
  }
  // vertical pass: (sh, ow) -> (oh, ow); accumulate whole rows so the
  // inner loops vectorize (axpy over contiguous ow*3 floats)
  std::vector<float> acc(static_cast<size_t>(ow) * 3);
  for (int r = 0; r < oh; ++r) {
    const float* w = &wy.w[static_cast<size_t>(r) * wy.kmax];
    int lo = wy.lo[r];
    int n = wy.cnt[r];
    float* a = acc.data();
    const int len = ow * 3;
    for (int i = 0; i < len; ++i) a[i] = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float c = w[j];
      const unsigned char* srow =
          mid.data() + static_cast<size_t>(lo + j) * len;
      for (int i = 0; i < len; ++i) a[i] += c * srow[i];
    }
    unsigned char* orow = dst + static_cast<size_t>(r) * len;
    for (int i = 0; i < len; ++i) orow[i] = clip8(a[i]);
  }
}

}  // extern "C"
