// Unsharp mask for Hopper (sm_90a): reflect-padded separable 25-tap sigma-5
// Gaussian blur, then out = (y - blur) * s + y, on an image whose point chain
// is already done (the two-stage form of the low-light enhance layer).
//
// Replaces: dedark_yolo_tpu/ops/pallas/enhance_kernel.py::usm_pallas (kernel
// body _usm_kernel, _blur_sharpen). The TPU kernel takes an image that XLA
// has transposed to (3, H, W) planes and reflect-padded by 12, and blurs it
// as two banded matmuls on the MXU; here nothing is padded or transposed in
// device memory.
//
// Bound: per value (pixel and channel) the kernel must read y once and write
// out once, 2 * itemsize bytes; the blur is 2 * 25 multiply-adds and the
// sharpen 3 flops, ~103 flops a value. At 16 x 640 x 640 x 3 (19.66 M values)
// that is 157 MB, 0.047 ms at 3.35 TB/s, against 2.0 GFLOP, 0.030 ms at 67
// TFLOP/s f32: bytes bound it in f32; with bf16 staging (79 MB, 0.023 ms) the
// operations do.
//
// Design: the tile of fused_enhance.cu without its point chain. One block per
// 32x32 output tile of one image reads its 56x56 window of all three channels
// once, with numpy 'reflect' indexing of the unpadded image, into shared
// memory as f32, then blurs from there (usm_tile.cuh). Neighbouring tiles
// re-read each other's halos (3.1x the tile) through L2. Math is f32; with
// bf16 staging the loads and the store convert and the output is rounded once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast math).

#include "usm_tile.cuh"

namespace {

using namespace usm_tile;

// usm: (B,) f32 sharpen strengths; taps: (25,) f32 Gaussian.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
usm_kernel(const T* __restrict__ img, const float* __restrict__ usm,
           const float* __restrict__ taps, T* __restrict__ out, int H, int W) {
  __shared__ float y[3][WH][WW];
  __shared__ float hb[WH][TW];
  __shared__ float g[TAPS];

  const int b = blockIdx.z;
  const int oy = blockIdx.y * TH;
  const int ox = blockIdx.x * TW;
  const int tid = threadIdx.x;
  if (tid < TAPS) g[tid] = taps[tid];

  const long plane = (long)H * W;
  const T* im = img + (long)b * plane * 3;
  for (int idx = tid; idx < WH * WW; idx += NTHREADS) {
    const int r = idx / WW, c = idx % WW;
    const long pix = (long)reflect(oy - PAD + r, H) * W + reflect(ox - PAD + c, W);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) y[ch][r][c] = load(im, pix * 3 + ch);
  }
  __syncthreads();

  blur_sharpen(y, hb, g, usm[b], out + (long)b * plane * 3, oy, ox, H, W);
}

}  // namespace

// img, out: contiguous NHWC (B, H, W, 3) of one dtype (bf16 != 0:
// __nv_bfloat16, else float); usm: (B,) f32. Requires H, W >= 13 (one
// reflection covers the 12-pixel halo). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int usm_launch(const void* img, const void* usm, const void* taps,
                          void* out, int B, int H, int W, int bf16,
                          void* stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    usm_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(img), static_cast<const float*>(usm),
        static_cast<const float*>(taps), static_cast<__nv_bfloat16*>(out), H, W);
  } else {
    usm_kernel<float><<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(img), static_cast<const float*>(usm),
        static_cast<const float*>(taps), static_cast<float*>(out), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
