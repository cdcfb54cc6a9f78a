// Native batched letterbox: bilinear resize + gray pad for uint8 HWC images.
//
// A copy of the JAX package's native/letterbox.cc. The reference delegates this
// hot host-side op to OpenCV's C++ through per-image Python calls
// (ultralytics/data/augment.py:540-605), serialized by the GIL. This core
// processes a whole batch with its own std::thread pool, called once per batch
// through ctypes (the GIL is released for the duration of the call).
//
// Bilinear convention matches cv2.INTER_LINEAR / jax.image.resize "linear":
// src coordinate = (dst + 0.5) * scale - 0.5, edge-clamped.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libletterbox.so letterbox.cc -lpthread
// (native/__init__.py builds it at first use)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "resize.h"  // fixed-point bilinear shared with decode.cc

namespace {

inline void resize_bilinear_u8(const uint8_t* src, int sh, int sw,
                               uint8_t* dst, int dh, int dw, int channels) {
  dedark::resize_bilinear_u8(src, sh, sw, dst, dh, dw, channels,
                             static_cast<size_t>(dw) * channels);
}

// One image: resize max-side to target keeping aspect, center-pad with `fill`,
// optionally swap BGR->RGB.
void letterbox_one(const uint8_t* src, int sh, int sw, uint8_t* dst, int size,
                   int channels, uint8_t fill, bool swap_rb,
                   std::vector<uint8_t>* scratch) {
  const float gain = std::min(static_cast<float>(size) / sh,
                              static_cast<float>(size) / sw);
  const int uh = std::max(1, static_cast<int>(std::lround(sh * gain)));
  const int uw = std::max(1, static_cast<int>(std::lround(sw * gain)));
  const int top = static_cast<int>(std::lround((size - uh) / 2.0 - 0.1));
  const int left = static_cast<int>(std::lround((size - uw) / 2.0 - 0.1));

  scratch->resize(static_cast<size_t>(uh) * uw * channels);
  resize_bilinear_u8(src, sh, sw, scratch->data(), uh, uw, channels);

  std::memset(dst, fill, static_cast<size_t>(size) * size * channels);
  for (int y = 0; y < uh; ++y) {
    const uint8_t* row = scratch->data() + static_cast<size_t>(y) * uw * channels;
    uint8_t* out = dst + (static_cast<size_t>(y + top) * size + left) * channels;
    if (swap_rb && channels == 3) {
      for (int x = 0; x < uw; ++x) {
        out[x * 3 + 0] = row[x * 3 + 2];
        out[x * 3 + 1] = row[x * 3 + 1];
        out[x * 3 + 2] = row[x * 3 + 0];
      }
    } else {
      std::memcpy(out, row, static_cast<size_t>(uw) * channels);
    }
  }
}

}  // namespace

extern "C" {

// Batched letterbox.
//   srcs:    array of n pointers to HWC uint8 images
//   shapes:  n * 2 ints (h, w) per image
//   dst:     n * size * size * 3 output buffer
//   swap_rb: nonzero -> BGR input to RGB output
//   n_threads: worker threads (<=0 -> hardware_concurrency)
void letterbox_batch(const uint8_t** srcs, const int32_t* shapes, int32_t n,
                     uint8_t* dst, int32_t size, uint8_t fill, int32_t swap_rb,
                     int32_t n_threads) {
  const int channels = 3;
  const size_t out_stride = static_cast<size_t>(size) * size * channels;
  int workers = n_threads > 0
      ? n_threads
      : static_cast<int>(std::thread::hardware_concurrency());
  workers = std::max(1, std::min<int>(workers, n));

  auto work = [&](int t) {
    std::vector<uint8_t> scratch;
    for (int i = t; i < n; i += workers) {
      letterbox_one(srcs[i], shapes[i * 2], shapes[i * 2 + 1],
                    dst + out_stride * i, size, channels, fill,
                    swap_rb != 0, &scratch);
    }
  };
  if (workers == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

}  // extern "C"
