// W8A8 3x3 stride-1 SAME convolution for Hopper (sm_90a) on the int8 tensor
// cores, int32 accumulation, per-output-channel requantisation.
//
// Replaces: dedark_yolo_tpu/ops/pallas/int8_conv.py::conv3x3_s1_w8a8 (kernel
// body _kernel, _slab_copy). The TPU kernel streams (TH+2)-row slabs through
// double-buffered VMEM and contracts nine shifted K=C slices on the MXU; its
// th/taps knobs are VMEM tilings with no counterpart here.
//
// Bound: operations. An implicit GEMM with M = B*H*W, N = Co, K = 9*C: 2*M*N*K
// int8 operations, 2.42e11 at (32, 80, 80, 256 -> 256), 0.122 ms at the dense
// 1,979 TOP/s; the bytes (the padded input and the output once, 0.11 GB)
// take 0.032 ms at 3.35 TB/s.
//
// Design: a plain implicit GEMM with mma.sync, not yet wgmma/TMA. One block of
// 8 warps computes a 128 (M) x 128 (N) tile; each warp 64 x 32 as 4 x 4
// m16n8k32 s8 MMAs per 32-deep K step. Because C % 32 == 0, a K step lies in
// one tap (dy, dx) and one run of 32 channels, so a row of the A tile is 32
// contiguous bytes of the caller-padded input at pixel (y+dy, x+dx): cp.async
// copies it (16 B per thread for A and for B) into a 4-stage ring of shared
// memory. Rows are padded to 48 B so the fragment loads hit 32 distinct banks.
// M and Co tails are clamped on load and masked on store; odd H and W need
// nothing else since the input is pre-padded.
// Epilogue, in the order of the TPU kernel (int8_conv.py:124-128):
// acc -> f32 (round to nearest), * scale[co], for silu y * (1 / (1 + e^-y))
// then * (1 / out_scale), round half to even, clamp to [-128, 127]; every
// step in IEEE f32 with no contraction.
// Shared memory: 4 * (128 + 128) * 48 = 49,152 B, the 48 KB static limit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast math: expf keeps full f32 accuracy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int LDS = BK + 16;  // shared row stride in bytes
constexpr int STAGES = 4;
constexpr int NTHREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;
constexpr int WN = 32;
constexpr int MI = WM / 16;
constexpr int NI = WN / 8;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x32, row) * b (32x8, col), s8 inputs, s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int requant(int acc, float scale, float inv_out,
                                       bool silu) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (silu) {
    y = __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
    y = __fmul_rn(y, inv_out);
  }
  return min(max(__float2int_rn(y), -128), 127);
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// x: (B, H+2, W+2, C) int8, pre-padded; wt: (Co, 9*C) int8, K index
// (dy*3 + dx)*C + c; scale: (Co,) f32; out: (B, H, W, Co) int8.
__global__ void __launch_bounds__(NTHREADS)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const float* __restrict__ scale, int8_t* __restrict__ out,
                 int B, int H, int W, int C, int Co, float inv_out, int silu) {
  __shared__ __align__(16) int8_t sA[STAGES][BM][LDS];
  __shared__ __align__(16) int8_t sB[STAGES][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int M = B * H * W, K = 9 * C, KT = K / BK;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int Wp = W + 2;

  // this thread's 16-byte piece of the A and B tiles: row lr, bytes lc..lc+15
  const int lr = tid >> 1, lc = (tid & 1) * 16;
  const int m = min(m0 + lr, M - 1);
  const int b = m / (H * W), rem = m - b * (H * W);
  const int yy = rem / W, xx = rem - yy * W;
  const int8_t* a_src = x + ((long)(b * (H + 2) + yy) * Wp + xx) * C + lc;
  const int8_t* b_src = wt + (long)min(n0 + lr, Co - 1) * K + lc;

  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    const int tap = k0 / C, c0 = k0 - tap * C;
    const int dy = tap / 3, dx = tap - dy * 3;
    cp_async16(&sA[stage][lr][lc], a_src + ((long)dy * Wp + dx) * C + c0);
    cp_async16(&sB[stage][lr][lc], b_src + k0);
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_tile(nk, nk % STAGES);
    cp_async_commit();

    const int st = kt % STAGES;
    unsigned af[MI][4], bf[NI][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int8_t* r0 = &sA[st][wm * WM + i * 16 + g][t * 4];
      const int8_t* r8 = r0 + 8 * LDS;
      af[i][0] = lds32(r0);
      af[i][1] = lds32(r8);
      af[i][2] = lds32(r0 + 16);
      af[i][3] = lds32(r8 + 16);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int8_t* c0 = &sB[st][wn * WN + j * 8 + g][t * 4];
      bf[j][0] = lds32(c0);
      bf[j][1] = lds32(c0 + 16);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
  cp_async_wait<0>();

  // accumulator (i, j, r): row g + 8*(r/2), column 2*t + r%2 of the 16x8 tile
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * WM + i * 16 + g + h * 8;
      if (row >= M) continue;
      int8_t* orow = out + (long)row * Co;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int col = n0 + wn * WN + j * 8 + t * 2;
        if (col >= Co) continue;  // Co % 8 == 0, so col + 1 < Co too
        char2 v;
        v.x = static_cast<signed char>(
            requant(acc[i][j][2 * h], scale[col], inv_out, silu));
        v.y = static_cast<signed char>(
            requant(acc[i][j][2 * h + 1], scale[col + 1], inv_out, silu));
        *reinterpret_cast<char2*>(orow + col) = v;
      }
    }
  }
}

}  // namespace

// x: contiguous (B, H+2, W+2, C) int8, 16-byte aligned; wt: contiguous
// (Co, 9*C) int8; scale: (Co,) f32; out: (B, H, W, Co) int8. Requires
// C % 32 == 0 and Co % 8 == 0. silu != 0 selects the fused SiLU tail with
// inv_out = 1 / out_scale. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int int8_conv_launch(const void* x, const void* wt, const void* scale,
                                void* out, int B, int H, int W, int C, int Co,
                                float inv_out, int silu, void* stream) {
  const long M = (long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (Co + BN - 1) / BN);
  int8_conv_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const float*>(scale), static_cast<int8_t*>(out), B, H, W, C,
      Co, inv_out, silu);
  return static_cast<int>(cudaGetLastError());
}
