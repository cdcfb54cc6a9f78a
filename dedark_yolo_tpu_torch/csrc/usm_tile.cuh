// The blur-and-sharpen stage shared by fused_enhance.cu and usm.cu: a
// reflect-padded separable 25-tap sigma-5 Gaussian blur of the image y the
// caller's source produces per pixel, then out = (y - blur) * s + y.
//
// Replaces: dedark_yolo_tpu/ops/pallas/enhance_kernel.py::_blur_sharpen, the
// stage both TPU kernels (fused_enhance_pallas, usm_pallas) share: two
// banded matmuls on the MXU over a reflect-padded, transposed plane.
//
// Bound: the stage itself moves no bytes beyond its caller's (y never
// leaves the chip); it does 2 * 25 FMA per value, 150 a pixel, 0.029 ms of
// f32 FMA issue at 16x640x640 on 132 SMs. Its caller's bytes (usm: y in,
// out; fused_enhance: img, IcA in, out) are the kernels' bound in f32.
//
// Design for Hopper: one block owns one image, one strip of SW output
// columns and one segment of `seg_rows` output rows, and walks down the
// segment RO rows (a chunk) at a time. Thread t owns window column
// x0 - PAD + t (NT = SW + 2*PAD threads), read with numpy 'reflect' indexing
// at the image edges; it runs the source (the point chain, or a plain load)
// once per window pixel, and keeps the last RO + 2*PAD rows of y for its
// column, all three channels, in registers (`yv`). So y is computed once per
// pixel of the window: the strip's 2*PAD-column halo and the segment's
// 2*PAD-row halo are the only repeats, no pixel halo is read back from
// device memory, and the vertical pass reads no shared memory at all.
// Per chunk:
//   1. shift `yv` up by RO rows and compute the chunk's RO new rows from the
//      loads issued a chunk earlier, then issue the next chunk's loads;
//   2. vertical 25-tap pass from registers into `vb` (one shared row of
//      (SW + 2*PAD) * 3 interleaved lanes, lane = column*3 + channel, per
//      chunk row), and the centre values y into `ob`;
//   3. horizontal pass: a task is CO outputs of one channel at lanes
//      s, s+3, ... of one row, reading the CO + 2*PAD lanes it needs from
//      `vb` once (stride 3 lanes, so a channel's taps) into registers; the
//      sharpen overwrites the centre in `ob`;
//   4. the chunk's RO output row segments (SW*3 contiguous values each) are
//      stored from `ob` with consecutive threads on consecutive addresses,
//      16 bytes a thread where the rows start on 16 bytes.
// The taps live in constant memory, read at uniform addresses as FMA
// operands: no registers and no load instructions. Shared memory per
// block: RO * (SW + 2*PAD) * 3 + RO * SW * 3 floats, 16,128 B.
// The launch plan (strip width, rows a segment, grid) is
// ops/enhance_kernel.py::enhance_plan, whose constants mirror these. At
// ~160 registers a thread, 4 blocks share an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace usm_tile {

constexpr int PAD = 12;
constexpr int TAPS = 2 * PAD + 1;
constexpr int SW = 72;               // output columns of a strip
constexpr int NT = SW + 2 * PAD;     // threads of a block: one a window column
constexpr int RO = 8;                // output rows of a chunk
constexpr int WIN = RO + 2 * PAD;    // rows of y a thread keeps
constexpr int CO = 9;                // outputs of one horizontal task
constexpr int VB_LANES = NT * 3;     // lanes of a vertically blurred row
constexpr int OB_LANES = SW * 3;     // lanes of an output row segment
constexpr int TASKS = RO * OB_LANES / CO;
static_assert(SW % CO == 0 && TASKS % NT == 0, "tasks must split evenly");
static_assert(2 * PAD % RO == 0, "the halo rows must fill whole chunks");

// gaussian_kernel_25() in float64, normalised, rounded to f32 (the CPU test
// test_torch_enhance_plan.py holds these to it bit for bit).
__constant__ float G[TAPS] = {
    0.0045345626f, 0.0071830824f, 0.010932376f, 0.015986243f, 0.022459835f,
    0.030317606f,  0.039319817f,  0.048995506f, 0.058658272f, 0.06747308f,
    0.07456928f,   0.07918038f,   0.08077993f,  0.07918038f,  0.07456928f,
    0.06747308f,   0.058658272f,  0.048995506f, 0.039319817f, 0.030317606f,
    0.022459835f,  0.015986243f,  0.010932376f, 0.0071830824f, 0.0045345626f};

__device__ __forceinline__ float load(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even
}

// 16 bytes of output from shared f32 values (4 floats, or 8 rounded to bf16)
__device__ __forceinline__ void store_vec(float* p, const float* s) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(s);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* s) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  const float4 b = *reinterpret_cast<const float4*>(s + 4);
  __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y), __floats2bfloat162_rn(a.z, a.w),
                         __floats2bfloat162_rn(b.x, b.y), __floats2bfloat162_rn(b.z, b.w)};
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

// numpy 'reflect' (edge not repeated), one reflection; the clamp only guards
// window positions past a ragged strip or segment, whose outputs are never
// stored.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

struct alignas(16) Smem {
  float vb[RO][VB_LANES];
  float ob[RO][OB_LANES];
};

// Src: src.fetch(pix, raw) loads what y of pixel `pix` (row * W + column of
// this image) needs into a `typename Src::Raw`; src.finish(raw, v) writes y
// for the three channels to v. o: this image's (H, W, 3) output; usm_s its
// sharpen strength. Every thread of the block calls it.
template <typename T, class Src>
__device__ __forceinline__ void blur_sharpen_strip(const Src& src, float usm_s,
                                                   T* __restrict__ o, int H,
                                                   int W, int seg_rows) {
  __shared__ Smem sm;
  const int t = threadIdx.x;
  const int x0 = blockIdx.x * SW;
  const int s0 = blockIdx.y * seg_rows;
  const int s1 = min(s0 + seg_rows, H);
  const int gx = reflect(x0 - PAD + t, W);
  const int out_lanes = min(SW, W - x0) * 3;
  const bool centre_col = t >= PAD && t < SW + PAD;
  // 16-byte stores where every row segment starts on 16 bytes: the image
  // does, and a row is a whole number of 16-byte vectors (x0 * 3 and the
  // last strip's width then are too, as SW is a multiple of 8)
  constexpr int VEC = 16 / sizeof(T), VEC_ROW = OB_LANES / VEC;
  static_assert(SW % 8 == 0 && OB_LANES % VEC == 0, "rows of whole vectors");
  const bool vec = W % VEC == 0 && reinterpret_cast<size_t>(o) % 16 == 0;

  // yv[c][i]: y of row r0 - PAD + i of this thread's column, channel c
  float yv[3][WIN];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < WIN; ++i) yv[c][i] = 0.0f;

  // the loads of a chunk's new rows are issued one chunk ahead, so they
  // arrive while the block blurs and stores the chunk before
  typename Src::Raw raw[RO];
#pragma unroll
  for (int j = 0; j < RO; ++j)
    src.fetch((long)reflect(s0 - PAD + j, H) * W + gx, raw[j]);

  // three chunks fill rows s0 - PAD .. s0 + PAD - 1 before the first output
  for (int r0 = s0 - 2 * PAD; r0 < s1; r0 += RO) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < 2 * PAD; ++i) yv[c][i] = yv[c][i + RO];
#pragma unroll
    for (int j = 0; j < RO; ++j) {
      float v[3];
      src.finish(raw[j], v);
#pragma unroll
      for (int c = 0; c < 3; ++c) yv[c][2 * PAD + j] = v[c];
    }
    if (r0 + RO < s1) {
#pragma unroll
      for (int j = 0; j < RO; ++j)
        src.fetch((long)reflect(r0 + RO + PAD + j, H) * W + gx, raw[j]);
    }
    if (r0 < s0) continue;

#pragma unroll
    for (int j = 0; j < RO; ++j) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < TAPS; ++k) acc = fmaf(G[k], yv[c][j + k], acc);
        sm.vb[j][t * 3 + c] = acc;
        if (centre_col) sm.ob[j][(t - PAD) * 3 + c] = yv[c][j + PAD];
      }
    }
    __syncthreads();

    // task q: row q / (OB_LANES / CO), lanes s + 3i (i < CO) with
    // s = (q % (SW / CO * 3)) / 3 * CO * 3 + channel
#pragma unroll
    for (int n = 0; n < TASKS / NT; ++n) {
      const int q = t + n * NT;
      const int r = q / (OB_LANES / CO), rem = q % (OB_LANES / CO);
      const int s = rem / 3 * (CO * 3) + rem % 3;
      float w[CO + 2 * PAD];
#pragma unroll
      for (int i = 0; i < CO + 2 * PAD; ++i) w[i] = sm.vb[r][s + 3 * i];
#pragma unroll
      for (int i = 0; i < CO; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < TAPS; ++k) acc = fmaf(G[k], w[i + k], acc);
        const float centre = sm.ob[r][s + 3 * i];
        sm.ob[r][s + 3 * i] = (centre - acc) * usm_s + centre;
      }
    }
    __syncthreads();

    const int rows = min(RO, s1 - r0);
    if (vec) {
      for (int idx = t; idx < rows * VEC_ROW; idx += NT) {
        const int r = idx / VEC_ROW, l = idx % VEC_ROW * VEC;
        if (l < out_lanes)
          store_vec(o + ((long)(r0 + r) * W + x0) * 3 + l, &sm.ob[r][l]);
      }
    } else {
      for (int idx = t; idx < rows * OB_LANES; idx += NT) {
        const int r = idx / OB_LANES, l = idx % OB_LANES;
        if (l < out_lanes) store(o, ((long)(r0 + r) * W + x0) * 3 + l, sm.ob[r][l]);
      }
    }
    __syncthreads();
  }
}

}  // namespace usm_tile

// Shared memory of one block, for the launch plan's mirror
// (ops/enhance_kernel.py::smem_bytes) to be checked against on the card.
extern "C" int enhance_smem_bytes() {
  return static_cast<int>(sizeof(usm_tile::Smem));
}
