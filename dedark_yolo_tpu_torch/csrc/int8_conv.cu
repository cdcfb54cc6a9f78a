// W8A8 3x3 stride-1 SAME convolution for Hopper (sm_90a): TMA tile loads into
// an mbarrier ring, s8 wgmma with int32 accumulators, per-output-channel
// requantisation.
//
// Replaces: dedark_yolo_tpu/ops/pallas/int8_conv.py::conv3x3_s1_w8a8 (:133;
// kernel body _kernel :68, _slab_copy :63). The TPU kernel streams (TH+2)-row
// slabs through double-buffered VMEM and contracts nine shifted K=C slices on
// the MXU; its th/taps knobs are VMEM tilings with no counterpart here.
//
// Bound: operations. An implicit GEMM with M = B*H*W, N = Co, K = 9*C: 2*M*N*K
// int8 operations, 2.42e11 at (32, 80, 80, 256 -> 256), 0.122 ms at the dense
// 1,979 TOP/s; the bytes (the padded input and the output once, 0.11 GB)
// take 0.032 ms at 3.35 TB/s.
//
// Design (ops/int8_conv.py::kernel_plan picks the K block and the ring's
// depth and mirrors the constants and layout owned here):
// - Tile: BM = 128 output pixels, 16 rows of 8 of one image (the probe's
//   80 x 80 tiles exactly), by BN = 128 output channels; tile row r is pixel
//   (y0 + r / 8, x0 + r % 8). Blocks run N-fastest, so the N tiles of one
//   M tile read its input together.
// - K = C/BK channel blocks x 9 taps, BK = 128, 64 or 32 (the largest that
//   divides C). Per channel block, A is one 4-D TMA box (BK, 10, 18, 1) of
//   the caller-padded input (B, H+2, W+2, C) at (c0, x0, y0, b): the tile's
//   halo, zero-filled past the padded edge (those rows are masked at the
//   store). Every tap reads it in place: for tap (dy, dx), the wgmma group
//   of output row i (8 rows, one per pixel) is halo row i + dy from column
//   dx, so the A descriptor starts at halo pixel dy*10 + dx with a stride of
//   one halo row (10 pixels) between groups; the swizzle follows absolute
//   shared addresses, so any start row works. The input crosses L2 once per
//   channel block instead of once per tap: a tile moves 334 KB through L2
//   at the probe's shape, not 576 KB, and L2 bounded the mainloop with a box
//   per tap. B is a 2-D box (BK, BN) of the (Co, 9C) K-contiguous weight
//   repack per tap; zero fill covers the Co tail. No im2col buffer.
// - Both operands are K-major with rows of BK bytes, swizzled by TMA in
//   spans of BK bytes (128/64/32 B), the layout the wgmma shared-memory
//   descriptors name; each 32-deep k step advances their start by 32 bytes.
// - Warp specialisation, 288 threads: warp 8's first lane issues the TMA
//   loads, the halo into one of two buffers and the weight blocks into a
//   ring of `stages`, each with a full mbarrier (expect_tx of the box's
//   bytes) and an empty one. Warpgroups 0 and 1 each own 8 rows of the tile
//   and run wgmma.m64n128k32.s32.s8.s8 on the shared B stage, keeping one
//   commit group in flight: a stage (or a halo) is released once the group
//   that read it last has retired (wgmma.wait_group 1).
// - Two blocks share an SM (at most 96 registers a thread, 113 KB of shared
//   memory a block), so one block's epilogue runs beside the other's
//   mainloop: the tensor cores idle through an epilogue otherwise.
// - Epilogue: the int32 tile is staged row-major over the ring (now free)
//   and requantised in runs of 8 channels, each thread on one run of every
//   16th row with its 8 scales in registers, each warp storing two whole
//   128-byte output rows. The requantisation is the TPU kernel's
//   (int8_conv.py:124-128), every step in IEEE f32 with no contraction:
//   acc -> f32 (round to nearest), * scale[co], for silu y * (1 / (1 +
//   e^-y)) then * (1 / out_scale); round half to even, clamp to [-128, 127].
//   For silu, while 1 / out_scale < 1e6, y is first raised to -20: that
//   changes no output (any y <= -20 gives |silu(y)| <= 20 * e^-20 = 4.2e-8,
//   which rounds to 0 either way) and keeps e^-y finite, where an infinite
//   divisor sent the IEEE division down its slow path. silu is a template
//   argument, so the requantisation carries no branch.
// - Tensor maps are encoded on the host for each call with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
//   library needs no link to libcuda, and passed as __grid_constant__.
// Shared memory: two halos of 180 x BK bytes, each rounded up to 1 KB, and
// stages x BN x BK of weights (or the staged int32 tile, 128 x 136 x 4 B, if
// larger), + 1 KB alignment slack + 16 B of mbarriers a stage and a halo;
// 2 x 23,552 + 4 x 16,384 + 1,120 = 113,760 B at BK = 128. ptxas: 90
// registers, no spills.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (no fast math: expf keeps full f32 accuracy).

#include <cuda.h>  // CUtensorMap and its enums; no link to the driver
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16, TW = 8;  // the tile's output pixels: 16 rows of 8
constexpr int BM = TH * TW;     // 128, 2 consumers x 64
constexpr int BN = 128;         // output channels per block
constexpr int HALO_ROWS = (TH + 2) * (TW + 2);  // pixels of the input box
constexpr int CONSUMERS = 2;    // warpgroups running wgmma
constexpr int NTHREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 115712;  // two blocks an SM
constexpr int LDC = BN + 8;  // ints per row of the staged int32 tile

// The shared-memory layout, owned here for the kernel's offsets and the
// launch's request: from a 1024-byte boundary, two input halos (each
// rounded up to 1024 B, where the 128-byte swizzle repeats), the ring of
// weight stages (the staged int32 tile reuses it once free), then a full
// and an empty mbarrier per stage and per halo; 1024 B of slack in front
// align the first halo.
__host__ __device__ constexpr uint32_t halo_bytes(int bk) {
  return (HALO_ROWS * bk + 1023) & ~1023u;
}
__host__ __device__ constexpr uint32_t ring_bytes(int bk, int stages) {
  return 2 * halo_bytes(bk) + stages * BN * bk > BM * LDC * 4
             ? 2 * halo_bytes(bk) + stages * BN * bk
             : BM * LDC * 4;
}
__host__ __device__ constexpr uint32_t smem_bytes(int bk, int stages) {
  return 1024 + ring_bytes(bk, stages) + 16 * (stages + 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
// Spin until the phase of `bar` with this parity has completed. A ring that
// never fills (a fault) traps after 2^26 polls, seconds, rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// One TMA tile load into shared memory `dst`, completing on `bar`;
// coordinates innermost first, in elements.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with rows of BK bytes,
// swizzled in spans of BK bytes: start >> 4 (bits 0-13), leading offset 1
// (unused when swizzled, bits 16-29), stride between 8-row groups `sbo`
// bytes >> 4 (bits 32-45), base offset 0 (bits 49-51), layout 1/2/3 =
// 128/64/32-byte swizzle (bits 62-63). The swizzle follows the absolute
// shared address, as TMA's does, so a group may start on any row of a
// 1024-byte-aligned box.
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo) {
  constexpr uint64_t layout = BK == 128 ? 1 : BK == 64 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, s32) += A (64 x 32, s8, K-major) * B (32 x 128, s8, K-major),
// both read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <bool SILU>
__device__ __forceinline__ uint32_t requant(int acc, float scale,
                                            float inv_out) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (SILU) {
    // the same output (see the header), with e^-y finite
    y = fmaxf(y, inv_out < 1e6f ? -20.0f : __int_as_float(0xff800000));
    y = __fmul_rn(y, 1.0f / (1.0f + expf(-y)));
    y = __fmul_rn(y, inv_out);
  }
  return static_cast<uint32_t>(min(max(__float2int_rn(y), -128), 127)) & 0xFF;
}

// Four requantised values packed as int8, lowest channel in the low byte.
template <bool SILU>
__device__ __forceinline__ uint32_t requant4(int4 a, float4 s, float inv_out) {
  return requant<SILU>(a.x, s.x, inv_out) |
         requant<SILU>(a.y, s.y, inv_out) << 8 |
         requant<SILU>(a.z, s.z, inv_out) << 16 |
         requant<SILU>(a.w, s.w, inv_out) << 24;
}

__device__ __forceinline__ void consumers_sync() {  // the 256 wgmma threads
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
}

// xmap: (B, H+2, W+2, C) int8 padded input; wmap: (Co, 9*C) int8, K index
// (dy*3 + dx)*C + c; scale: (Co,) f32; out: (B, H, W, Co) int8.
template <int BK, bool SILU>
__global__ void __launch_bounds__(NTHREADS, 2)
int8_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ scale, int8_t* __restrict__ out,
                 int H, int W, int C, int Co, int tiles_x, int tiles_y,
                 int tiles_n, int stages, float inv_out) {
  constexpr uint32_t HALO_TX = HALO_ROWS * BK;  // box bytes
  constexpr uint32_t HALO_BYTES = halo_bytes(BK);
  constexpr uint32_t B_BYTES = BN * BK;
  constexpr uint32_t SBO_A = (TW + 2) * BK;  // one halo row per 8-row group
  extern __shared__ uint8_t smem[];
  // every box on a 1024-byte boundary, where the swizzle pattern repeats
  const uint32_t pad = (1024 - (smem_u32(smem) & 1023)) & 1023;
  const uint32_t sa = smem_u32(smem) + pad;  // two halos
  const uint32_t sb = sa + 2 * HALO_BYTES;    // the ring of B stages
  // mbarriers: full and empty per B stage, then per halo
  const uint32_t full = sa + ring_bytes(BK, stages), empty = full + 8 * stages;
  const uint32_t hfull = empty + 8 * stages, hempty = hfull + 16;
  int* const staged = reinterpret_cast<int*>(smem + pad);  // over the ring

  const int tid = threadIdx.x, wg = tid / 128;  // wg == CONSUMERS: producer
  int tile = blockIdx.x;
  const int n0 = (tile % tiles_n) * BN;
  tile /= tiles_n;
  const int x0 = (tile % tiles_x) * TW;
  tile /= tiles_x;
  const int y0 = (tile % tiles_y) * TH;
  const int b = tile / tiles_y;
  const int cblocks = C / BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(hfull + 8 * h, 1);
      mbar_init(hempty + 8 * h, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    if (tid == 128 * CONSUMERS) {
      for (int cb = 0, s = 0, phase = 0; cb < cblocks; ++cb) {
        const int h = cb & 1;  // halo buffer; its use count is cb >> 1
        mbar_wait(hempty + 8 * h, ((cb >> 1) & 1) ^ 1);
        mbar_expect_tx(hfull + 8 * h, HALO_TX);
        tma_load_4d(sa + h * HALO_BYTES, &xmap, hfull + 8 * h, cb * BK, x0, y0,
                    b);
        for (int tap = 0; tap < 9; ++tap) {
          mbar_wait(empty + 8 * s, phase ^ 1);
          mbar_expect_tx(full + 8 * s, B_BYTES);
          tma_load_2d(sb + s * B_BYTES, &wmap, full + 8 * s,
                      tap * C + cb * BK, n0);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup wg owns output rows 8*wg .. 8*wg + 7
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int s = 0, phase = 0, prev = -1;
    for (int cb = 0; cb < cblocks; ++cb) {
      const int h = cb & 1;
      mbar_wait(hfull + 8 * h, (cb >> 1) & 1);
      const uint32_t halo = sa + h * HALO_BYTES + wg * 8 * (TW + 2) * BK;
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap - 3 * dy;
        mbar_wait(full + 8 * s, phase);
        // tap (dy, dx): group g (output row 8*wg + g) is halo row
        // 8*wg + g + dy from column dx
        const uint64_t da =
            smem_desc<BK>(halo + (dy * (TW + 2) + dx) * BK, SBO_A);
        const uint64_t db = smem_desc<BK>(sb + s * B_BYTES, 8 * BK);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < BK / 32; ++k)
          wgmma_m64n128k32(acc, da + 2 * k, db + 2 * k);  // +32 B per k step
        wgmma_commit();
        wgmma_wait<1>();  // the group before this one has read its operands
        if ((tid & 127) == 0) {
          if (prev >= 0) mbar_arrive(empty + 8 * prev);
          if (tap == 0 && cb > 0) mbar_arrive(hempty + 8 * (h ^ 1));
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    wgmma_wait<0>();

    // Stage the int32 tile row-major in the ring, now read by no one, so
    // the requantisation runs on 8-channel runs with independent work and
    // 8-byte stores that a warp writes as whole output rows.
    consumers_sync();  // both warpgroups' last wgmma has read its stage
    {
      const int lane = tid & 31, w = (tid & 127) >> 5;
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int* row = staged + (wg * 64 + w * 16 + h * 8 + g) * LDC + 2 * t;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<int2*>(row + 8 * j) =
              make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    consumers_sync();
    // thread tid takes channels c .. c+7 of rows tid / RUNS + k * ROW_STEP
    constexpr int RUNS = BN / 8, ROW_STEP = 128 * CONSUMERS / RUNS;
    const int c = (tid % RUNS) * 8, col = n0 + c;
    if (col < Co) {  // Co % 8 == 0: a run lies wholly inside Co or past it
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + col));
      const float4 s1 =
          __ldg(reinterpret_cast<const float4*>(scale + col + 4));
#pragma unroll
      for (int r = tid / RUNS; r < BM; r += ROW_STEP) {
        const int y = y0 + r / TW, x = x0 + r % TW;
        if (y >= H || x >= W) continue;
        const int* a = staged + r * LDC + c;
        const uint2 v = make_uint2(
            requant4<SILU>(*reinterpret_cast<const int4*>(a), s0, inv_out),
            requant4<SILU>(*reinterpret_cast<const int4*>(a + 4), s1,
                           inv_out));
        *reinterpret_cast<uint2*>(
            out + ((static_cast<long>(b) * H + y) * W + x) * Co + col) = v;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// uint8 tiled map, innermost dimension first, strides in bytes of dims 1..;
// elements outside the tensor read as zero.
bool encode(CUtensorMap* map, const void* base, cuuint32_t rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BK>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
           const float* scale, int8_t* out, int B, int H, int W, int C,
           int Co, int stages, float inv_out, int silu, cudaStream_t stream) {
  auto kernel =
      silu ? int8_conv_kernel<BK, true> : int8_conv_kernel<BK, false>;
  const int smem = smem_bytes(BK, stages);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_y = (H + TH - 1) / TH, tiles_x = (W + TW - 1) / TW;
  const int tiles_n = (Co + BN - 1) / BN;
  const long blocks = static_cast<long>(B) * tiles_y * tiles_x * tiles_n;
  if (blocks >= (1L << 31)) return -3;
  kernel<<<static_cast<unsigned>(blocks), NTHREADS, smem, stream>>>(
      xmap, wmap, scale, out, H, W, C, Co, tiles_x, tiles_y, tiles_n, stages,
      inv_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory a launch with this K block and ring depth
// requests; ops/int8_conv.py::smem_bytes mirrors it to plan the ring.
extern "C" int int8_conv_smem_bytes(int bk, int stages) {
  return static_cast<int>(smem_bytes(bk, stages));
}

// x: contiguous (B, H+2, W+2, C) int8, 16-byte aligned; wt: contiguous
// (Co, 9*C) int8; scale: (Co,) f32, 16-byte aligned; out: (B, H, W, Co)
// int8. silu != 0 selects the fused SiLU tail with inv_out = 1 / out_scale.
// bk (the K block) and stages (the weight ring's depth) are
// ops/int8_conv.py::kernel_plan's. Launches on `stream`, does not
// synchronise, and returns 0 on success, a CUDA error code, or -1 (no
// cuTensorMapEncodeTiled in the driver), -2 (a tensor map was refused) or
// -3 (bk or stages outside the compiled variants or shared memory).
extern "C" int int8_conv_launch(const void* x, const void* wt,
                                const void* scale, void* out, int B, int H,
                                int W, int C, int Co, float inv_out, int silu,
                                void* stream, int bk, int stages) {
  if (!(bk == 32 || bk == 64 || bk == 128) || C % bk || Co % 8 ||
      stages < 2 || stages > MAX_STAGES ||
      smem_bytes(bk, stages) > SMEM_LIMIT)
    return -3;
  if (encode_tiled() == nullptr) return -1;
  const cuuint64_t Hp = H + 2, Wp = W + 2, c = C;
  const cuuint64_t xdims[4] = {c, Wp, Hp, static_cast<cuuint64_t>(B)};
  const cuuint64_t xstrides[3] = {c, Wp * c, Hp * Wp * c};
  const cuuint32_t xbox[4] = {static_cast<cuuint32_t>(bk), TW + 2, TH + 2, 1};
  const cuuint64_t wdims[2] = {9 * c, static_cast<cuuint64_t>(Co)};
  const cuuint64_t wstrides[1] = {9 * c};
  const cuuint32_t wbox[2] = {static_cast<cuuint32_t>(bk), BN};
  const CUtensorMapSwizzle swizzle =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                 : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap xmap, wmap;
  if (!encode(&xmap, x, 4, xdims, xstrides, xbox, swizzle) ||
      !encode(&wmap, wt, 2, wdims, wstrides, wbox, swizzle))
    return -2;
  const float* s = static_cast<const float*>(scale);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bk) {
    case 128:
      return launch<128>(xmap, wmap, s, o, B, H, W, C, Co, stages, inv_out,
                         silu, st);
    case 64:
      return launch<64>(xmap, wmap, s, o, B, H, W, C, Co, stages, inv_out,
                        silu, st);
    default:
      return launch<32>(xmap, wmap, s, o, B, H, W, C, Co, stages, inv_out,
                        silu, st);
  }
}
