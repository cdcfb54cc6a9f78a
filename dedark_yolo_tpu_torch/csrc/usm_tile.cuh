// The unsharp-mask stage shared by fused_enhance.cu and usm.cu: one block
// per TH x TW output tile of one image, whose (TH+24) x (TW+24) window of the
// blur's input y (all three channels, f32) the caller has already put in
// shared memory with numpy 'reflect' indexing. Per channel, a horizontal
// 25-tap pass into `hb`, a vertical pass, and out = (y - blur) * s + y,
// stored once in the output's dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace usm_tile {

constexpr int PAD = 12;
constexpr int TAPS = 2 * PAD + 1;
constexpr int TH = 32;
constexpr int TW = 32;
constexpr int WH = TH + 2 * PAD;
constexpr int WW = TW + 2 * PAD;
constexpr int NTHREADS = 256;

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even
}

// numpy 'reflect' (edge not repeated), one reflection; the clamp only guards
// window positions past a ragged last tile, whose outputs are never stored.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

// y: the tile's window [3][WH][WW]; hb: scratch [WH][TW]; g: the 25 taps, all
// in shared memory. o: this image's (H, W, 3) output; (oy, ox): the tile's
// first output pixel. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void blur_sharpen(float (*y)[WH][WW],
                                             float (*hb)[TW], const float* g,
                                             float usm_s, T* o, int oy, int ox,
                                             int H, int W) {
  const int tid = threadIdx.x;
  for (int ch = 0; ch < 3; ++ch) {
    for (int idx = tid; idx < WH * TW; idx += NTHREADS) {
      const int r = idx / TW, c = idx % TW;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) acc += g[k] * y[ch][r][c + k];
      hb[r][c] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < TH * TW; idx += NTHREADS) {
      const int r = idx / TW, c = idx % TW;
      const int gy = oy + r, gx = ox + c;
      if (gy < H && gx < W) {
        float blur = 0.0f;
#pragma unroll
        for (int k = 0; k < TAPS; ++k) blur += g[k] * hb[r + k][c];
        const float center = y[ch][r + PAD][c + PAD];
        store(o, ((long)gy * W + gx) * 3 + ch, (center - blur) * usm_s + center);
      }
    }
    __syncthreads();
  }
}

}  // namespace usm_tile
