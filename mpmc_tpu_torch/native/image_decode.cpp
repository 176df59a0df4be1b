// JPEG/PNG decode + bilinear resize — the port's copy of
// native/image_decode.cpp, so that both packages feed a model the same
// pixels for the same file.
//
// Replaces the reference's per-__getitem__ PIL/torchvision decode path
// (Multimodal_example_task2C.py:269 PIL open+convert).  Decodes straight to a
// fixed-size uint8 RGB (or grayscale) buffer: libjpeg with ideal-scale
// prescaling (scale_denom — decodes Instagram-sized JPEGs at 1/2..1/8 cost),
// libpng for PNG, then separable bilinear resize.  Pure C++ (no Python
// state), so ctypes callers run it off the GIL across a thread pool.
//
// Build: mpmc_tpu_torch/native_lib.py compiles it with g++ at first use
// into mpmc_tpu_torch/_build/, against the system's libjpeg and libpng, or
// where their development files are missing, against the copies bundled
// with Pillow through the public headers in native/include/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Bilinear resize HWC uint8 (align-corners=false, matches PIL/our numpy ref).
void resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                     uint8_t* dst, int dh, int dw) {
  for (int y = 0; y < dh; ++y) {
    float sy = (y + 0.5f) * sh / dh - 0.5f;
    int y0 = std::max(0, std::min(sh - 1, static_cast<int>(std::floor(sy))));
    int y1 = std::min(sh - 1, y0 + 1);
    float wy = std::max(0.0f, std::min(1.0f, sy - y0));
    for (int x = 0; x < dw; ++x) {
      float sx = (x + 0.5f) * sw / dw - 0.5f;
      int x0 = std::max(0, std::min(sw - 1, static_cast<int>(std::floor(sx))));
      int x1 = std::min(sw - 1, x0 + 1);
      float wx = std::max(0.0f, std::min(1.0f, sx - x0));
      for (int ch = 0; ch < c; ++ch) {
        float top = src[(y0 * sw + x0) * c + ch] * (1 - wx) +
                    src[(y0 * sw + x1) * c + ch] * wx;
        float bot = src[(y1 * sw + x0) * c + ch] * (1 - wx) +
                    src[(y1 * sw + x1) * c + ch] * wx;
        float v = top * (1 - wy) + bot * wy;
        dst[(y * dw + x) * c + ch] =
            static_cast<uint8_t>(std::max(0.0f, std::min(255.0f, v + 0.5f)));
      }
    }
  }
}

bool decode_jpeg(FILE* f, int out_size, int gray, uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  // Prescale: pick the smallest 1/k (k in 1,2,4,8) that keeps both dims
  // >= out_size, cutting IDCT + memory cost for large photos.
  for (int denom = 8; denom >= 1; denom >>= 1) {
    if (static_cast<int>(cinfo.image_width) / denom >= out_size &&
        static_cast<int>(cinfo.image_height) / denom >= out_size) {
      cinfo.scale_num = 1;
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height,
      c = cinfo.output_components;
  std::vector<uint8_t> buf(static_cast<size_t>(w) * h * c);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + static_cast<size_t>(cinfo.output_scanline) * w * c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  int want_c = gray ? 1 : 3;
  if (c != want_c) return false;
  resize_bilinear(buf.data(), h, w, c, out, out_size, out_size);
  return true;
}

bool decode_png(FILE* f, int out_size, int gray, uint8_t* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) { png_destroy_read_struct(&png, nullptr, nullptr); return false; }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_strip_16(png);
  png_set_palette_to_rgb(png);
  png_set_expand_gray_1_2_4_to_8(png);
  png_set_strip_alpha(png);
  if (gray) {
    png_set_rgb_to_gray(png, 1, -1, -1);
  } else {
    png_set_gray_to_rgb(png);
  }
  png_read_update_info(png, info);
  int w = png_get_image_width(png, info);
  int h = png_get_image_height(png, info);
  int c = png_get_channels(png, info);
  int want_c = gray ? 1 : 3;
  if (c != want_c) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(w) * h * c);
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y)
    rows[y] = buf.data() + static_cast<size_t>(y) * w * c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  resize_bilinear(buf.data(), h, w, c, out, out_size, out_size);
  return true;
}

}  // namespace

extern "C" {

// Returns 1 on success. out: uint8 [out_size, out_size, gray?1:3].
int img_decode_resize(const char* path, int out_size, int gray, uint8_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  unsigned char magic[8] = {0};
  size_t got = fread(magic, 1, 8, f);
  rewind(f);
  int ok = 0;
  if (got >= 3 && magic[0] == 0xFF && magic[1] == 0xD8) {
    ok = decode_jpeg(f, out_size, gray, out) ? 1 : 0;
  } else if (got >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
    ok = decode_png(f, out_size, gray, out) ? 1 : 0;
  }
  fclose(f);
  return ok;
}

// The libjpeg API version compiled against (JPEG_LIB_VERSION), and the
// version string of the libpng loaded at run time.
int img_jpeg_lib_version() { return JPEG_LIB_VERSION; }
const char* img_png_version() { return png_get_libpng_ver(nullptr); }

}  // extern "C"
