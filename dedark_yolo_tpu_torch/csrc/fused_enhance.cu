// Fused low-light enhance chain for Hopper (sm_90a): DeDark -> WhiteBalance
// -> Gamma -> Contrast -> 25-tap sigma-5 unsharp mask, in one pass per image.
//
// Replaces: dedark_yolo_tpu/ops/pallas/enhance_kernel.py::fused_enhance_pallas
// (kernel body _make_full_kernel). Same function, not the same blocking: the
// TPU kernel's transposed (W, H) planes, 128-lane padding and banded MXU
// matmuls were made for VMEM and the MXU. What carries over is its way of
// avoiding the vertical halo: it walks full-height column tiles and recomputes
// only the 2*12-column overlap; here a block walks a column strip down a
// segment of rows.
//
// Bound: device memory in f32. Per image the kernel must read img (3 values)
// and IcA (1 value) and write out (3 values) per pixel: H*W*(3*s_in + s_ica
// + 3*s_out) bytes, 11.5 MB at 640x640 f32, or 3.4 us at 3.35 TB/s. The
// separable blur is 2*25 multiply-adds per channel per pixel (150 FMA, ~355
// flops a pixel with the point chain): 2.2 us of f32 work per 640x640 image
// at 67 TFLOP/s. With bf16 staging (5.7 MB an image) the operations bound it.
// The point chain's logarithms, exponentials, cosine and divisions are not in
// that count; with the library's full-precision logf/expf/cosf and IEEE
// divisions they cost more issue slots than the blur.
//
// Design (usm_tile.cuh): one block per (image, 72-column strip, segment of
// rows); each thread owns one column of the strip's 96-column reflect window
// and runs the point chain and the contrast scale once per window pixel, in
// f32, walking down the rows with the last 32 rows of y in registers and the
// next 8 rows' loads in flight. The only repeated point-chain work is the
// 24-column strip halo (96/72) and the 24-row segment halo. Because the
// chain is per pixel, filtering the reflected window equals reflect-padding
// the filtered image (the TPU kernel relies on the same fact). The blur and
// sharpen then run from registers and one shared row buffer, and each output
// row segment is stored contiguously, once, in the input's dtype. Each block
// also regresses its image's ten filter parameters from the 15 features, so
// the wrapper launches this kernel and nothing else: made on the host by
// torch's elementwise ops (ops/enhance_kernel.py::param_vec, about 30
// launches), they took a call from 0.129 to 0.653 ms at 16x640x640 f32 on an
// H100 (chip_smoke.py's `ms_host_params`). Nothing but img, IcA, the
// features, A and out touches device memory.
//
// The chain's log, exp, cos and divisions use the card's fast intrinsics
// (__logf, __expf, __cosf, __fdividef): against the full-precision functions
// they took the kernel from 0.238 to 0.158 ms at 16x640x640 f32 on an H100,
// and the largest difference from the plain version stayed 4.9e-5 (5.0e-5
// with the full-precision functions) under the 1e-4 + 1e-4*|plain| bound.
// Their errors are a few ulps relative (log, exp) or ~2^-21 absolute (cos of
// pi*lum in [0, pi]), which gamma <= 3 and the contrast quotient leave far
// inside that bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no -use_fast_math: the intrinsics are written out where they are used).

#include "usm_tile.cuh"

namespace {

using namespace usm_tile;

constexpr float PI_F = 3.14159265358979f;

// The feature slots and tanh ranges of nn/enhance.py::regress_filter_params,
// each range as span = hi - lo and mid = (hi + lo) / 2, rounded to f32. The
// CPU test of the plan (tests/test_torch_enhance_plan.py) reads them from
// here, holds them to nn/enhance.py's constants and holds the regression
// they give to the plain one.
constexpr int DEDARK_SLOT = 0;
constexpr int WB_SLOT = 1;  // three slots; the first is masked to 0
constexpr int GAMMA_SLOT = 4;
constexpr int CONTRAST_SLOT = 13;
constexpr int USM_SLOT = 14;
constexpr float DEDARK_SPAN = 0.9f;
constexpr float DEDARK_MID = 0.55f;
constexpr float WB_SPAN = 1.0f;
constexpr float WB_MID = 0.0f;
constexpr float GAMMA_SPAN = 2.1972246f;  // 2 * log(3)
constexpr float GAMMA_MID = 0.0f;
constexpr float USM_SPAN = 5.0f;
constexpr float USM_MID = 2.5f;

// The point chain of one image: y of a pixel from img and IcA.
template <typename T>
struct PointChain {
  const T* im;
  const T* ic;
  float dd_w, a[3], wb[3], gamma, p_con;

  struct Raw {
    float x[3], ic;
  };

  __device__ __forceinline__ void fetch(long pix, Raw& r) const {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) r.x[ch] = load(im, pix * 3 + ch);
    r.ic = load(ic, pix);
  }

  __device__ __forceinline__ void finish(const Raw& r, float (&y)[3]) const {
    const float rtx = __fdividef(1.0f, fmaxf(1.0f - dd_w * r.ic, 0.01f));
    float v[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float t = ((r.x[ch] - a[ch]) * rtx + a[ch]) * wb[ch];
      v[ch] = __expf(gamma * __logf(fmaxf(t, 1e-4f)));
    }
    const float lum = fminf(fmaxf(0.27f * v[0] + 0.67f * v[1] + 0.06f * v[2], 0.0f), 1.0f);
    const float scale =
        (1.0f - p_con) +
        p_con * __fdividef(-__cosf(PI_F * lum) * 0.5f + 0.5f, lum + 1e-6f);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) y[ch] = v[ch] * scale;
  }
};

// tanh_range(x, lo, hi) of nn/enhance.py with span = hi - lo and
// mid = (hi + lo) / 2, each operation rounded on its own as torch's
// separate elementwise kernels round it (no contraction into an FMA)
__device__ __forceinline__ float tanh_range(float x, float span, float mid) {
  return __fadd_rn(__fdiv_rn(__fmul_rn(tanhf(x), span), 2.0f), mid);
}

// f: (B, 15) f32 regressor features; A: (B, 3) f32 atmospheric light. Each
// thread computes its image's filter parameters as
// nn/enhance.py::regress_filter_params does (the wrapper launches nothing
// else): dedark_w, the white balance normalised by its luminance, gamma,
// contrast and the sharpen strength.
template <typename T>
__global__ void __launch_bounds__(NT)
fused_enhance_kernel(const T* __restrict__ img, const T* __restrict__ ica,
                     const float* __restrict__ feats, const float* __restrict__ A,
                     T* __restrict__ out, int H, int W, int seg_rows) {
  const int b = blockIdx.z;
  const long plane = (long)H * W;
  const float* f = feats + b * 15;
  float s[3];
  s[0] = expf(tanh_range(__fmul_rn(f[WB_SLOT], 0.0f), WB_SPAN, WB_MID));
  s[1] = expf(tanh_range(f[WB_SLOT + 1], WB_SPAN, WB_MID));
  s[2] = expf(tanh_range(f[WB_SLOT + 2], WB_SPAN, WB_MID));
  const float lum = __fadd_rn(__fadd_rn(__fadd_rn(1e-5f, __fmul_rn(0.27f, s[0])),
                                        __fmul_rn(0.67f, s[1])),
                              __fmul_rn(0.06f, s[2]));
  PointChain<T> src{img + b * plane * 3, ica + b * plane,
                    tanh_range(f[DEDARK_SLOT], DEDARK_SPAN, DEDARK_MID),
                    {A[b * 3], A[b * 3 + 1], A[b * 3 + 2]},
                    {__fdiv_rn(s[0], lum), __fdiv_rn(s[1], lum), __fdiv_rn(s[2], lum)},
                    expf(tanh_range(f[GAMMA_SLOT], GAMMA_SPAN, GAMMA_MID)),
                    tanhf(f[CONTRAST_SLOT])};
  blur_sharpen_strip(src, tanh_range(f[USM_SLOT], USM_SPAN, USM_MID),
                     out + b * plane * 3, H, W, seg_rows);
}

}  // namespace

// img, ica, out: contiguous NHWC (B, H, W, 3) / (B, H, W, 1) / (B, H, W, 3) of
// one dtype (bf16 != 0: __nv_bfloat16, else float); feats (B, 15) and A
// (B, 3) contiguous f32. Requires H, W >= 13 (one reflection covers the
// 12-pixel halo). seg_rows: output rows a block walks
// (ops/enhance_kernel.py::enhance_plan). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int fused_enhance_launch(const void* img, const void* ica,
                                    const void* feats, const void* A, void* out,
                                    int B, int H, int W, int bf16, void* stream,
                                    int seg_rows) {
  const dim3 grid((W + SW - 1) / SW, (H + seg_rows - 1) / seg_rows, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    fused_enhance_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(img), static_cast<const __nv_bfloat16*>(ica),
        static_cast<const float*>(feats), static_cast<const float*>(A),
        static_cast<__nv_bfloat16*>(out), H, W, seg_rows);
  } else {
    fused_enhance_kernel<float><<<grid, NT, 0, st>>>(
        static_cast<const float*>(img), static_cast<const float*>(ica),
        static_cast<const float*>(feats), static_cast<const float*>(A),
        static_cast<float*>(out), H, W, seg_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
