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
// Design: the strip walk of fused_enhance.cu (usm_tile.cuh) with a plain load
// in place of the point chain: each thread reads its window column's pixels
// once per segment (the 24-column strip halo and 24-row segment halo come
// from L2) one chunk of rows ahead, keeps the last 32 rows in registers for
// the vertical pass, and the block stores each output row segment
// contiguously, 16 bytes a thread where rows are 16-byte aligned. Math is
// f32; with bf16 staging the loads and the store convert and the output is
// rounded once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast math).

#include "usm_tile.cuh"

namespace {

using namespace usm_tile;

template <typename T>
struct RawPixel {
  const T* im;

  struct Raw {
    float x[3];
  };

  __device__ __forceinline__ void fetch(long pix, Raw& r) const {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) r.x[ch] = load(im, pix * 3 + ch);
  }

  __device__ __forceinline__ void finish(const Raw& r, float (&y)[3]) const {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) y[ch] = r.x[ch];
  }
};

// usm: (B,) f32 sharpen strengths.
template <typename T>
__global__ void __launch_bounds__(NT)
usm_kernel(const T* __restrict__ img, const float* __restrict__ usm,
           T* __restrict__ out, int H, int W, int seg_rows) {
  const int b = blockIdx.z;
  const long plane = (long)H * W;
  blur_sharpen_strip(RawPixel<T>{img + b * plane * 3}, usm[b],
                     out + b * plane * 3, H, W, seg_rows);
}

}  // namespace

// img, out: contiguous NHWC (B, H, W, 3) of one dtype (bf16 != 0:
// __nv_bfloat16, else float); usm: (B,) f32. Requires H, W >= 13 (one
// reflection covers the 12-pixel halo). seg_rows: output rows a block walks
// (ops/enhance_kernel.py::enhance_plan). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int usm_launch(const void* img, const void* usm, void* out, int B,
                          int H, int W, int bf16, void* stream, int seg_rows) {
  const dim3 grid((W + SW - 1) / SW, (H + seg_rows - 1) / seg_rows, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    usm_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(img), static_cast<const float*>(usm),
        static_cast<__nv_bfloat16*>(out), H, W, seg_rows);
  } else {
    usm_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(img), static_cast<const float*>(usm),
        static_cast<float*>(out), H, W, seg_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
