// Greedy non-maximum suppression for Hopper (sm_90a): an IoU bitmask
// computed across all SMs, then one warp an image walks it in score order.
//
// Replaces: the greedy loop of dedark_yolo_tpu/ops/nms.py::_nms_single :28,
// which the JAX package runs as a lax.while_loop inside one jit (XLA
// compiles it; it is not a Pallas kernel), and the port's plain `_greedy`
// (ops/nms.py), which asks the host after every step whether any image still
// has a candidate.
//
// Computes what `_greedy(boxes, scores, iou_thres, max_det)` computes: up to
// max_det times, take the candidate with the highest live score (the lowest
// index on ties); stop the image once that score is <= 0; else keep it and
// suppress every candidate whose IoU with it exceeds iou_thres.
//
// Contract: every image's scores are non-increasing along K, with the zeros
// after every positive score. `ops/nms.py::nms_candidates` hands over exactly
// that (a stable descending sort), and it is the only producer of this
// kernel's input. Then "the highest live score, lower index first" is "the
// first live candidate in order", and greedy NMS is a walk: candidate i is
// kept unless a kept candidate before it overlaps it, until the first score
// <= 0 or max_det kept. Nothing here checks the order (a check would need a
// host sync); `_greedy`, the plain version, is right for any order.
//
// Bound: the function's yardstick stays the greedy loop's (chip_smoke.py
// `nms_bound`: boxes and scores read once, ~16 flops a candidate a step over
// the steps the data needs). The design adds work to that: the mask pass
// takes the IoU of every pair i < j of candidates whose row may be reached
// (16 x 2048 candidates: ~33.5 M pairs, 8.4 MB of mask, which stays in the
// 50 MB L2), and the walk reads, for each chunk it reaches, the words of
// that chunk's rows and one word of each row kept so far.
//
// Design: the old kernel ran one block an image, a chain of up to max_det
// dependent block-wide argmax reductions (~1.7 us a step) on 16 of 132 SMs.
// Here the dependent chain is bit operations on one warp:
//   nms_mask: a block of CHUNK threads per (image, 64-row chunk r, 64-column
//     chunk c >= r; the pairs (r, c) of the upper triangle numbered row by
//     row); the column chunk's boxes and areas are staged in shared memory,
//     each thread owns one row i and writes one 64-bit word mask[b, i, c]:
//     bit t set iff j = 64c + t > i, j < K and IoU(i, j) > iou_thres. The
//     IoU is `_greedy`'s expression with round-to-nearest intrinsics (nvcc
//     would otherwise contract a multiply and an add into an FMA and flip
//     `iou > iou_thres` at the boundary). A warp pays for a division when
//     any of its lanes needs one, so a thread first marks the columns whose
//     boxes meet its row's box (four comparisons: each box's right side
//     past the other's left, and so for y; a box without positive width and
//     height meets none), then divides for those alone, bit by bit: where
//     boxes do not meet, the intersection is 0 and IoU = 0 / den = 0 is not
//     above a threshold >= 0 (most pairs; a negative threshold divides for
//     all). Words below the diagonal, and the rows of candidates whose score
//     is <= 0 (the walk stops there), are never written or read.
//   nms_scan: one warp an image, the indices of the candidates kept so far
//     in shared memory. Per chunk c: the lanes hold the chunk's 64 diagonal
//     words, their next words (c + 1) and the scores, two rows a lane,
//     loaded a chunk ahead, and start loading word c + 1 of the rows kept
//     before the chunk (GATHER a lane); a ballot gives the candidates
//     before the first score <= 0; the chunk is resolved on the warp-uniform
//     word `alive = valid & ~removed` in 64 unrolled bit steps (a live
//     candidate is kept and clears the bits its diagonal word sets; the
//     shuffles that fetch the words do not wait on the walk); the kept ones
//     past max_det are dropped, the rest written out in parallel and added
//     to the list. `removed` for chunk c + 1 is then the OR across the warp
//     of the gathered words and of the next words of the rows just kept: no
//     load the walk waits for is issued after the resolve it follows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast math).

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 64;              // candidates a mask word covers
// candidates an image (the gate's default max_nms): the scan's list of kept
// candidates lives in shared memory, and the mask takes K * K / 8 bytes
constexpr int MAX_K = 2048;
constexpr int GATHER = 16;             // kept rows a lane reads ahead
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

// (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0), each step rounded once
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// (min(x2) - max(x1)).clamp(min=0) * (min(y2) - max(y1)).clamp(min=0) of a
// candidate o and a winner m, in `_greedy`'s order
__device__ __forceinline__ float intersection(float4 o, float4 m) {
  const float iw = fmaxf(__fsub_rn(fminf(o.z, m.z), fmaxf(o.x, m.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(o.w, m.w), fmaxf(o.y, m.y)), 0.f);
  return __fmul_rn(iw, ih);
}

// First block of row r in the upper triangle (r, c >= r) of W x W chunk
// pairs, walked row by row
__device__ __forceinline__ int tri_start(int r, int W) {
  return r * W - r * (r - 1) / 2;
}

// blockIdx.x is the image; blockIdx.y the block's place in the triangle
template <bool NONNEG_THRES>
__global__ void __launch_bounds__(CHUNK)
nms_mask(const float4* __restrict__ boxes, const float* __restrict__ scores,
         u64* __restrict__ mask, int K, float iou_thres) {
  __shared__ float4 col_box[CHUNK];
  __shared__ float4 col_meet[CHUNK];   // col_box, or a box that meets none
  __shared__ float col_area[CHUNK];
  const int W = (K + CHUNK - 1) / CHUNK;
  const int at = blockIdx.y;
  const float b = 2 * W + 1;
  int r = min(W - 1, max(0, static_cast<int>(
                                (b - sqrtf(b * b - 8.f * at)) * 0.5f)));
  while (tri_start(r, W) > at) --r;
  while (r + 1 < W && tri_start(r + 1, W) <= at) ++r;
  const int c = r + at - tri_start(r, W);
  const long img = blockIdx.x;
  const float4* bx = boxes + img * K;
  const int t = threadIdx.x;
  const int j = c * CHUNK + t;
  const float4 cb = j < K ? bx[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  col_box[t] = cb;
  col_area[t] = box_area(cb);
  // a box without positive width and height intersects nothing: inf
  // sides that no comparison passes (NaN sides too)
  col_meet[t] = cb.z > cb.x && cb.w > cb.y
                    ? cb : make_float4(INFINITY, INFINITY, -INFINITY, -INFINITY);
  __syncthreads();

  const int i = r * CHUNK + t;
  if (i >= K || !(scores[img * K + i] > 0.f)) return;   // never reached
  const float4 m = bx[i];
  const float area_i = box_area(m);
  // only j > i (the diagonal word) and j < K (the last chunk)
  const int lo = c == r ? t + 1 : 0, hi = min(CHUNK, K - c * CHUNK);
  u64 todo = (hi == CHUNK ? ~0ull : (1ull << hi) - 1)
             & (lo == CHUNK ? 0ull : ~0ull << lo);
  if (NONNEG_THRES) {          // 0 / den = 0 is not above the threshold
    u64 meets = 0;             // the intersection has positive sides
    if (m.z > m.x && m.w > m.y) {
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const float4 o = col_meet[u];
        if (o.z > m.x && m.z > o.x && o.w > m.y && m.w > o.y)
          meets |= 1ull << u;
      }
    }
    todo &= meets;
  }
  u64 word = 0;
  while (todo) {                // the division only where it may matter
    const int u = __ffsll((long long)todo) - 1;
    todo &= todo - 1;
    const float inter = intersection(col_box[u], m);
    const float den =
        __fadd_rn(__fsub_rn(__fadd_rn(col_area[u], area_i), inter), 1e-7f);
    if (__fdiv_rn(inter, den) > iou_thres) word |= 1ull << u;
  }
  mask[(img * K + i) * W + c] = word;
}

__global__ void __launch_bounds__(32)
nms_scan(const u64* __restrict__ mask, const float* __restrict__ scores,
         long long* __restrict__ keep_idx, float* __restrict__ keep_scores,
         int K, int max_det) {
  __shared__ int kept_rows[MAX_K];     // the candidates kept so far, in order
  const int lane = threadIdx.x;
  const long img = blockIdx.x;
  const int W = (K + CHUNK - 1) / CHUNK;
  const u64* mk = mask + img * K * W;
  const float* sc = scores + img * K;
  long long* out_i = keep_idx + img * max_det;
  float* out_s = keep_scores + img * max_det;

  // word w of chunk c's row c*64 + half*32 + lane, and that row's score
  auto word = [&](int c, int half, int w) {
    const int i = c * CHUNK + half * 32 + lane;
    return c < W && w < W && i < K ? mk[(long)i * W + w] : 0ull;
  };
  auto score = [&](int c, int half) {
    const int i = c * CHUNK + half * 32 + lane;
    return c < W && i < K ? sc[i] : 0.f;
  };

  int kept = 0;
  u64 removed = 0;    // what the rows kept so far suppress in this chunk
  // this chunk's rows: diagonal words, next words, scores (one chunk ahead)
  u64 d0 = word(0, 0, 0), d1 = word(0, 1, 0);
  u64 n0 = word(0, 0, 1), n1 = word(0, 1, 1);
  float s0 = score(0, 0), s1 = score(0, 1);
  for (int c = 0; c < W; ++c) {
    const u64 nd0 = word(c + 1, 0, c + 1), nd1 = word(c + 1, 1, c + 1);
    const u64 nn0 = word(c + 1, 0, c + 2), nn1 = word(c + 1, 1, c + 2);
    const float ns0 = score(c + 1, 0), ns1 = score(c + 1, 1);
    // word c + 1 of the rows kept before this chunk, in flight while the
    // chunk is resolved
    u64 gather[GATHER];
#pragma unroll
    for (int u = 0; u < GATHER; ++u) {
      const int k = lane + 32 * u;
      gather[u] = c + 1 < W && k < kept
                      ? mk[(long)kept_rows[k] * W + c + 1] : 0ull;
    }
    // the walk stops at the first score <= 0 (rows past K read as 0)
    const u64 stop = (u64)__ballot_sync(FULL, !(s0 > 0.f))
                     | (u64)__ballot_sync(FULL, !(s1 > 0.f)) << 32;
    const int first_stop = stop ? __ffsll((long long)stop) - 1 : CHUNK;
    const u64 valid = first_stop == CHUNK ? ~0ull : (1ull << first_stop) - 1;
    const u64 alive = valid & ~removed;
    // one bit step a candidate, in order: a live one is kept and clears the
    // bits its diagonal word sets (the shuffles do not wait on the walk).
    // Rows of the second half set no bit of the first (j > i).
    unsigned a_lo = static_cast<unsigned>(alive);
    unsigned a_hi = static_cast<unsigned>(alive >> 32);
    unsigned k_lo = 0, k_hi = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned dl = __shfl_sync(FULL, static_cast<unsigned>(d0), t);
      const unsigned dh = __shfl_sync(FULL, static_cast<unsigned>(d0 >> 32), t);
      if (a_lo >> t & 1) {
        k_lo |= 1u << t;
        a_lo &= ~dl;
        a_hi &= ~dh;
      }
    }
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned dh = __shfl_sync(FULL, static_cast<unsigned>(d1 >> 32), t);
      if (a_hi >> t & 1) {
        k_hi |= 1u << t;
        a_hi &= ~dh;
      }
    }
    u64 kept_here = (u64)k_hi << 32 | k_lo;
    // past max_det the walk ends; later kept ones suppressed only later ones
    const int kept_before = kept;
    while (__popcll(kept_here) > max_det - kept_before)
      kept_here ^= 1ull << (63 - __clzll((long long)kept_here));
    kept += __popcll(kept_here);
    // write the chunk's kept candidates, in order
    if (kept_here >> lane & 1) {
      const int at = kept_before + __popcll(kept_here & ((1ull << lane) - 1));
      out_i[at] = c * CHUNK + lane;
      out_s[at] = s0;
      kept_rows[at] = c * CHUNK + lane;
    }
    if (kept_here >> (lane + 32) & 1) {
      const int at =
          kept_before + __popcll(kept_here & ((1ull << (lane + 32)) - 1));
      out_i[at] = c * CHUNK + 32 + lane;
      out_s[at] = s1;
      kept_rows[at] = c * CHUNK + 32 + lane;
    }
    if (stop || kept == max_det) break;
    // what every kept row suppresses in chunk c + 1: this chunk's from the
    // next words in registers, the earlier ones' from the gather, ORed
    // across the warp
    u64 next = (kept_here >> lane & 1 ? n0 : 0ull)
               | (kept_here >> (lane + 32) & 1 ? n1 : 0ull);
#pragma unroll
    for (int u = 0; u < GATHER; ++u) next |= gather[u];
    for (int k = lane + 32 * GATHER; k < kept_before; k += 32)
      next |= mk[(long)kept_rows[k] * W + c + 1];   // max_det > 32 * GATHER
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) next |= __shfl_xor_sync(FULL, next, o);
    removed = next;
    __syncwarp();       // kept_rows written above, read by the next gather
    d0 = nd0;
    d1 = nd1;
    n0 = nn0;
    n1 = nn1;
    s0 = ns0;
    s1 = ns1;
  }
  for (int s = kept + lane; s < max_det; s += 32) {
    out_i[s] = -1;
    out_s[s] = 0.f;
  }
}

}  // namespace

// The mask's chunk, the most candidates an image may have, and the bytes of
// the (B, K, ceil(K / CHUNK)) u64 mask (ops/nms.py mirrors all three).
extern "C" int nms_chunk() { return CHUNK; }
extern "C" int nms_max_k() { return MAX_K; }
extern "C" long long nms_mask_bytes(int B, int K) {
  return 8LL * B * K * ((K + CHUNK - 1) / CHUNK);
}

// The two passes on their own (chip_smoke.py times them apart); nms_launch
// runs both. Each launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int nms_mask_launch(const void* boxes, const void* scores,
                               void* mask, int B, int K, float iou_thres,
                               void* stream) {
  const int W = (K + CHUNK - 1) / CHUNK;
  const dim3 grid(B, W * (W + 1) / 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  u64* mk = static_cast<u64*>(mask);
  if (iou_thres >= 0.f)
    nms_mask<true><<<grid, CHUNK, 0, s>>>(bx, sc, mk, K, iou_thres);
  else
    nms_mask<false><<<grid, CHUNK, 0, s>>>(bx, sc, mk, K, iou_thres);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_scan_launch(const void* mask, const void* scores,
                               void* keep_idx, void* keep_scores, int B, int K,
                               int max_det, void* stream) {
  nms_scan<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(mask), static_cast<const float*>(scores),
      static_cast<long long*>(keep_idx), static_cast<float*>(keep_scores), K,
      max_det);
  return static_cast<int>(cudaGetLastError());
}

// boxes (B, K, 4) f32 xyxy, class-offset; scores (B, K) f32, non-increasing
// along K with the zeros last (the contract above); keep_idx (B, max_det)
// int64 and keep_scores (B, max_det) f32 are written whole (-1 and 0 after an
// image stops); mask is scratch of nms_mask_bytes(B, K) bytes, 8-byte
// aligned. Requires B >= 1, 1 <= K <= MAX_K, max_det >= 1 and
// 16-byte aligned boxes. Launches both passes on `stream`, does not
// synchronise, and returns the first nonzero cudaGetLastError() (0 on
// success).
extern "C" int nms_launch(const void* boxes, const void* scores, void* keep_idx,
                          void* keep_scores, int B, int K, int max_det,
                          float iou_thres, void* stream, void* mask) {
  const int rc = nms_mask_launch(boxes, scores, mask, B, K, iou_thres, stream);
  if (rc) return rc;
  return nms_scan_launch(mask, scores, keep_idx, keep_scores, B, K, max_det,
                         stream);
}
