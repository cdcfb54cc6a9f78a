// Fused low-light enhance chain for Hopper (sm_90a): DeDark -> WhiteBalance
// -> Gamma -> Contrast -> 25-tap sigma-5 unsharp mask, in one pass per image.
//
// Replaces: dedark_yolo_tpu/ops/pallas/enhance_kernel.py::fused_enhance_pallas
// (kernel body _make_full_kernel). Same function, not the same blocking: the
// TPU kernel's transposed (W, H) planes, 128-lane padding and banded MXU
// matmuls were made for VMEM and the MXU.
//
// Bound: device memory. Per image the kernel must read img (3 values) and IcA
// (1 value) and write out (3 values) per pixel: H*W*(3*s_in + s_ica + 3*s_out)
// bytes, 11.5 MB at 640x640 f32, or 3.4 us at 3.35 TB/s. The separable blur is
// 2*25 multiply-adds per channel per pixel (150 FMA, ~350 flops a pixel with
// the point chain): 2.2 us of f32 work per 640x640 image at 67 TFLOP/s, so in
// f32 bytes set the floor; with bf16 staging (5.7 MB an image) the two floors
// are within 1.3x of each other and the operations bound it.
//
// Design: one block per 32x32 output tile of one image. The block reads its
// (32+24)x(32+24) halo window once, with numpy 'reflect' indexing, runs the
// per-pixel point chain and the contrast scale in f32, and keeps the result y
// for all three channels in shared memory. Because the point chain is per
// pixel, filtering the reflected window equals reflect-padding the filtered
// image (the TPU kernel relies on the same fact). The blur then runs per
// channel from shared memory: a horizontal 25-tap pass into a second buffer,
// a vertical pass, and out = (y - blur) * s + y, written once in the input's
// dtype. Nothing but the output touches device memory. Neighbouring tiles
// re-read each other's halos (56^2 / 32^2 = 3.1x the tile), which the design
// leaves to L2.
// Shared memory: 3*56*56*4 + 56*32*4 = 44,800 B, under the 48 KB static limit.
// The blur-and-sharpen stage lives in usm_tile.cuh, shared with usm.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast math: expf/logf/cosf keep full f32 accuracy).

#include "usm_tile.cuh"

namespace {

using namespace usm_tile;

constexpr float PI_F = 3.14159265358979f;

// params: (B, 16) f32, slots 0 dedark_w, 1-3 A, 4-6 wb, 7 gamma, 8 contrast,
// 9 usm (the JAX _param_vec order). taps: (25,) f32 Gaussian.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fused_enhance_kernel(const T* __restrict__ img, const T* __restrict__ ica,
                     const float* __restrict__ params,
                     const float* __restrict__ taps, T* __restrict__ out,
                     int H, int W) {
  __shared__ float y[3][WH][WW];
  __shared__ float hb[WH][TW];
  __shared__ float g[TAPS];
  __shared__ float p[16];

  const int b = blockIdx.z;
  const int oy = blockIdx.y * TH;
  const int ox = blockIdx.x * TW;
  const int tid = threadIdx.x;
  if (tid < TAPS) g[tid] = taps[tid];
  if (tid < 16) p[tid] = params[b * 16 + tid];
  __syncthreads();

  const long plane = (long)H * W;
  const T* im = img + (long)b * plane * 3;
  const T* ic = ica + (long)b * plane;
  const float dd_w = p[0], gamma = p[7], p_con = p[8];

  for (int idx = tid; idx < WH * WW; idx += NTHREADS) {
    const int r = idx / WW, c = idx % WW;
    const long pix = (long)reflect(oy - PAD + r, H) * W + reflect(ox - PAD + c, W);
    const float tx = fmaxf(1.0f - dd_w * load(ic, pix), 0.01f);
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float a = p[1 + ch];
      float t = ((load(im, pix * 3 + ch) - a) / tx + a) * p[4 + ch];
      v[ch] = expf(gamma * logf(fmaxf(t, 1e-4f)));
    }
    const float lum = fminf(fmaxf(0.27f * v[0] + 0.67f * v[1] + 0.06f * v[2], 0.0f), 1.0f);
    const float scale =
        (1.0f - p_con) + p_con * ((-cosf(PI_F * lum) * 0.5f + 0.5f) / (lum + 1e-6f));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) y[ch][r][c] = v[ch] * scale;
  }
  __syncthreads();

  blur_sharpen(y, hb, g, p[9], out + (long)b * plane * 3, oy, ox, H, W);
}

}  // namespace

// img, ica, out: contiguous NHWC (B, H, W, 3) / (B, H, W, 1) / (B, H, W, 3) of
// one dtype (bf16 != 0: __nv_bfloat16, else float). Requires H, W >= 13 (one
// reflection covers the 12-pixel halo). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int fused_enhance_launch(const void* img, const void* ica,
                                    const void* params, const void* taps,
                                    void* out, int B, int H, int W, int bf16,
                                    void* stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    fused_enhance_kernel<__nv_bfloat16><<<grid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(img), static_cast<const __nv_bfloat16*>(ica),
        static_cast<const float*>(params), static_cast<const float*>(taps),
        static_cast<__nv_bfloat16*>(out), H, W);
  } else {
    fused_enhance_kernel<float><<<grid, NTHREADS, 0, st>>>(
        static_cast<const float*>(img), static_cast<const float*>(ica),
        static_cast<const float*>(params), static_cast<const float*>(taps),
        static_cast<float*>(out), H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
