// Native batched JPEG decode + resize for the host input pipeline (a copy of
// the JAX package's native/decode.cc).
//
// The reference decodes with cv2.imread (full-resolution libjpeg decode) and
// resizes afterwards (ultralytics/data/base.py:142-169) — per image, from
// Python. This core instead uses libjpeg's DCT-domain scaling
// (scale_num/scale_denom) to decode DIRECTLY at the smallest 1/8..8/8 scale
// that still covers the target size, then bilinear-resizes the remainder —
// on a 1080p JPEG headed for 640px that skips ~3/4 of the IDCT work. Whole
// batches run in a std::thread pool behind one ctypes call (GIL released).
//
// Entry points:
//   decode_maxside_batch:   decode + max-side resize, top-left placement in a
//                           fixed (n, size, size, 3) buffer (+ real h/w out)
//                           — feeds the train dataset's mosaic tiles.
//   decode_letterbox_batch: decode + letterbox (gray pad, center) — the whole
//                           predict/val preprocess in one call (+ orig h/w).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libdecode.so decode.cc -ljpeg -lpthread
// (native/__init__.py builds it at first use, apart from letterbox.cc, so that
// a host without jpeglib.h still letterboxes)

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

#include "resize.h"

namespace {

using dedark::resize_bilinear_u8;

struct JpegError {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegError*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one JPEG file at the cheapest DCT scale covering `target` max-side.
// Returns RGB pixels in `out` (resized so max side == target unless the image
// is smaller) and the ORIGINAL (h, w). false on any decode error.
bool decode_jpeg_maxside(const char* path, int target, bool swap_rb,
                         std::vector<uint8_t>* decode_buf,
                         std::vector<uint8_t>* out, int* out_h, int* out_w,
                         int* orig_h, int* orig_w) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  JpegError jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);

  const int h0 = static_cast<int>(cinfo.image_height);
  const int w0 = static_cast<int>(cinfo.image_width);
  *orig_h = h0;
  *orig_w = w0;
  const int max_side = std::max(h0, w0);

  // smallest power-of-two num/8 scale whose decoded max side still covers
  // `target` — libjpeg-turbo's SIMD IDCT only covers 1/8, 2/8, 4/8 and 8/8;
  // intermediate scales fall back to scalar C and are slower than full decode
  int num = 8;
  if (max_side > target) {
    for (int k : {1, 2, 4, 8}) {
      if (max_side * k / 8 >= target) { num = k; break; }
    }
  }
  cinfo.scale_num = static_cast<unsigned>(num);
  cinfo.scale_denom = 8;
  // libjpeg-turbo emits BGR/RGB directly — no post-hoc channel swap
#ifdef JCS_EXTENSIONS
  cinfo.out_color_space = swap_rb ? JCS_EXT_BGR : JCS_EXT_RGB;
#else
  cinfo.out_color_space = JCS_RGB;
#endif
  cinfo.dct_method = JDCT_IFAST;
  jpeg_start_decompress(&cinfo);

  const int dh = static_cast<int>(cinfo.output_height);
  const int dw = static_cast<int>(cinfo.output_width);
  decode_buf->resize(static_cast<size_t>(dh) * dw * 3);
  const size_t row_stride = static_cast<size_t>(dw) * 3;
  std::vector<JSAMPROW> rows(dh);
  for (int y = 0; y < dh; ++y) {
    rows[y] = decode_buf->data() + static_cast<size_t>(y) * row_stride;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_scanlines(&cinfo, rows.data() + cinfo.output_scanline,
                        cinfo.output_height - cinfo.output_scanline);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

#ifndef JCS_EXTENSIONS
  if (swap_rb) {  // plain libjpeg fallback: swap to BGR after the fact
    uint8_t* p = decode_buf->data();
    const size_t npix = static_cast<size_t>(dh) * dw;
    for (size_t i = 0; i < npix; ++i) std::swap(p[i * 3], p[i * 3 + 2]);
  }
#endif

  // final exact max-side resize (reference base.py:142-169 semantics)
  const float r = static_cast<float>(target) / std::max(dh, dw);
  int th = dh, tw = dw;
  if (std::max(h0, w0) > target || std::max(dh, dw) > target) {
    th = std::max(1, std::min(static_cast<int>(dh * r), target));
    tw = std::max(1, std::min(static_cast<int>(dw * r), target));
  }
  if (th == dh && tw == dw) {
    out->swap(*decode_buf);
  } else {
    out->resize(static_cast<size_t>(th) * tw * 3);
    resize_bilinear_u8(decode_buf->data(), dh, dw, out->data(), th, tw, 3,
                       static_cast<size_t>(tw) * 3);
  }
  *out_h = th;
  *out_w = tw;
  return true;
}

}  // namespace

extern "C" {

// Decode n JPEGs, max-side-resize to `size`, place top-left into
// dst (n, size, size, 3); shapes_out receives (loaded_h, loaded_w, orig_h,
// orig_w) per image, all zeros on decode failure. swap_rb!=0 -> BGR output.
void decode_maxside_batch(const char** paths, int32_t n, uint8_t* dst,
                          int32_t size, int32_t swap_rb, int32_t* shapes_out,
                          int32_t n_threads) {
  const size_t out_stride = static_cast<size_t>(size) * size * 3;
  int workers = n_threads > 0
      ? n_threads : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min<int>(workers, n));

  auto work = [&](int t) {
    std::vector<uint8_t> buf, img;
    for (int i = t; i < n; i += workers) {
      int h = 0, w = 0, h0 = 0, w0 = 0;
      uint8_t* slot = dst + out_stride * i;
      std::memset(slot, 0, out_stride);
      if (decode_jpeg_maxside(paths[i], size, swap_rb != 0, &buf, &img,
                              &h, &w, &h0, &w0)) {
        for (int y = 0; y < h; ++y) {
          std::memcpy(slot + (static_cast<size_t>(y) * size) * 3,
                      img.data() + static_cast<size_t>(y) * w * 3,
                      static_cast<size_t>(w) * 3);
        }
        shapes_out[i * 4] = h;
        shapes_out[i * 4 + 1] = w;
        shapes_out[i * 4 + 2] = h0;
        shapes_out[i * 4 + 3] = w0;
      } else {
        shapes_out[i * 4] = shapes_out[i * 4 + 1] = 0;
        shapes_out[i * 4 + 2] = shapes_out[i * 4 + 3] = 0;
      }
    }
  };
  if (workers == 1) { work(0); return; }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

// Decode n JPEGs and letterbox straight into dst (n, size, size, 3) RGB with
// gray `fill` centering (reference LetterBox, augment.py:540-605, incl. the
// round(x-0.1) pad convention); shapes_out receives (orig_h, orig_w).
void decode_letterbox_batch(const char** paths, int32_t n, uint8_t* dst,
                            int32_t size, uint8_t fill, int32_t* shapes_out,
                            int32_t n_threads) {
  const size_t out_stride = static_cast<size_t>(size) * size * 3;
  int workers = n_threads > 0
      ? n_threads : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min<int>(workers, n));

  auto work = [&](int t) {
    std::vector<uint8_t> buf, img, scaled;
    for (int i = t; i < n; i += workers) {
      int h = 0, w = 0, h0 = 0, w0 = 0;
      uint8_t* slot = dst + out_stride * i;
      std::memset(slot, fill, out_stride);
      shapes_out[i * 2] = shapes_out[i * 2 + 1] = 0;
      if (!decode_jpeg_maxside(paths[i], size, /*swap_rb=*/false, &buf, &img,
                               &h, &w, &h0, &w0)) {
        continue;
      }
      shapes_out[i * 2] = h0;
      shapes_out[i * 2 + 1] = w0;
      // letterbox the (h, w) max-side image into the square
      const float gain = std::min(static_cast<float>(size) / h,
                                  static_cast<float>(size) / w);
      const int uh = std::max(1, static_cast<int>(std::lround(h * gain)));
      const int uw = std::max(1, static_cast<int>(std::lround(w * gain)));
      const int top = static_cast<int>(std::lround((size - uh) / 2.0 - 0.1));
      const int left = static_cast<int>(std::lround((size - uw) / 2.0 - 0.1));
      const uint8_t* src = img.data();
      int sh = h, sw = w;
      if (uh != h || uw != w) {
        scaled.resize(static_cast<size_t>(uh) * uw * 3);
        resize_bilinear_u8(img.data(), h, w, scaled.data(), uh, uw, 3,
                           static_cast<size_t>(uw) * 3);
        src = scaled.data();
        sh = uh; sw = uw;
      }
      for (int y = 0; y < sh; ++y) {
        std::memcpy(slot + ((static_cast<size_t>(y + top)) * size + left) * 3,
                    src + static_cast<size_t>(y) * sw * 3,
                    static_cast<size_t>(sw) * 3);
      }
    }
  };
  if (workers == 1) { work(0); return; }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

}  // extern "C"
