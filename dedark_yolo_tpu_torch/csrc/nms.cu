// Greedy non-maximum suppression for Hopper (sm_90a): the whole loop of every
// image on the device, one block per image.
//
// Replaces: the greedy loop of dedark_yolo_tpu/ops/nms.py::_nms_single, which
// the JAX package runs as a lax.while_loop inside one jit (XLA compiles it;
// it is not a Pallas kernel), and the port's plain `_greedy`
// (ops/nms.py), which asks the host after every step whether any image still
// has a candidate.
//
// Computes what `_greedy(boxes, scores, iou_thres, max_det)` computes: up to
// max_det times, take the candidate with the highest live score (the lowest
// index on ties, as torch.argmax and jnp.argmax do); stop the image once
// that score is <= 0; else keep it and zero its own score and that of every
// candidate whose IoU with it exceeds iou_thres. The IoU is written with
// round-to-nearest intrinsics in `_greedy`'s order, (inter / (((area_i +
// area_w) - inter) + 1e-7)), each step rounded once: nvcc would otherwise
// contract a multiply and an add into one FMA and could flip `iou >
// iou_thres` at the boundary.
//
// Bound: not bytes (16 x 2048 candidates are 655 KB, 0.2 us at 3.35 TB/s)
// and hardly operations (~20 flops per candidate and step, 2.5 us at 67
// TFLOP/s for 300 steps of 16 x 2048): each step needs the winner of the one
// before, so an image is a chain of up to max_det dependent block-wide
// argmax reductions, and the time is that chain's latency.
//
// Design: each of the block's 256 threads owns the candidates t, t + 256,
// ... (at most PER = 8 of them): their boxes, areas and live scores stay in
// registers for the whole loop. The boxes also go to shared memory once, so
// that every thread reads the winner's box there. A step is a thread-local
// argmax, a warp butterfly of (score, index) pairs, one barrier, then every
// warp reduces the eight warp winners itself (a second butterfly), so a step
// has one barrier; the warp winners are double-buffered by step parity so
// that the next step's writes cannot meet this step's reads. The 16 images of
// a predict batch run on 16 SMs side by side.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast math).

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER = 8;                 // candidates a thread owns
constexpr int MAX_K = THREADS * PER;   // candidates an image may have
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float4 box[MAX_K];        // every candidate's box, read for the winner's
  float win_s[2][WARPS];    // warp winners, double-buffered by step parity
  int win_i[2][WARPS];
};

// (s, i) beats (bs, bi): a higher score, or the same score at a lower index
__device__ __forceinline__ bool beats(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

template <int WIDTH>
__device__ __forceinline__ void butterfly(float& s, int& i) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) {
    const float os = __shfl_xor_sync(FULL, s, o);
    const int oi = __shfl_xor_sync(FULL, i, o);
    if (beats(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0), each step rounded once
__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__global__ void __launch_bounds__(THREADS)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           long long* __restrict__ keep_idx, float* __restrict__ keep_scores,
           int K, int max_det, float iou_thres) {
  __shared__ Smem sm;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long img = blockIdx.x;
  const float4* bx = boxes + img * K;
  const float* sc = scores + img * K;
  long long* out_i = keep_idx + img * max_det;
  float* out_s = keep_scores + img * max_det;

  float4 mine[PER];
  float area[PER], live[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = t + j * THREADS;
    if (i < K) {
      mine[j] = bx[i];
      sm.box[i] = mine[j];
      live[j] = sc[i];
    } else {
      mine[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      live[j] = 0.f;        // never wins: the image stops at a best of 0
    }
    area[j] = box_area(mine[j]);
  }
  __syncthreads();

  int step = 0;
  for (; step < max_det; ++step) {
    float bs = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PER; ++j) {   // ascending index: the first max stays
      if (live[j] > bs) {
        bs = live[j];
        bi = t + j * THREADS;
      }
    }
    butterfly<32>(bs, bi);
    const int par = step & 1;
    if (lane == 0) {
      sm.win_s[par][warp] = bs;
      sm.win_i[par][warp] = bi;
    }
    __syncthreads();
    bs = lane < WARPS ? sm.win_s[par][lane] : -INFINITY;
    bi = lane < WARPS ? sm.win_i[par][lane] : INT_MAX;
    butterfly<WARPS>(bs, bi);         // lanes 0..WARPS-1 agree; lane 0 tells all
    bs = __shfl_sync(FULL, bs, 0);
    bi = __shfl_sync(FULL, bi, 0);
    if (!(bs > 0.f)) break;           // the same decision in every thread
    if (t == 0) {
      out_i[step] = bi;
      out_s[step] = bs;
    }
    const float4 w = sm.box[bi];
    const float warea = box_area(w);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const float4 m = mine[j];
      const float iw = fmaxf(__fsub_rn(fminf(m.z, w.z), fmaxf(m.x, w.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(m.w, w.w), fmaxf(m.y, w.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float den =
          __fadd_rn(__fsub_rn(__fadd_rn(area[j], warea), inter), 1e-7f);
      if (__fdiv_rn(inter, den) > iou_thres || t + j * THREADS == bi)
        live[j] = 0.f;
    }
  }
  for (int s = step + t; s < max_det; s += THREADS) {
    out_i[s] = -1;
    out_s[s] = 0.f;
  }
}

}  // namespace

// Shared memory of a block and the most candidates an image may have
// (ops/nms.py mirrors both).
extern "C" int nms_smem_bytes() { return static_cast<int>(sizeof(Smem)); }
extern "C" int nms_max_k() { return MAX_K; }

// boxes (B, K, 4) f32 xyxy, class-offset; scores (B, K) f32, 0 = no
// candidate; keep_idx (B, max_det) int64 and keep_scores (B, max_det) f32 are
// written whole (-1 and 0 after an image stops). Requires 1 <= K <= MAX_K and
// 16-byte aligned boxes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int nms_launch(const void* boxes, const void* scores, void* keep_idx,
                          void* keep_scores, int B, int K, int max_det,
                          float iou_thres, void* stream) {
  nms_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores),
      static_cast<long long*>(keep_idx), static_cast<float*>(keep_scores), K,
      max_det, iou_thres);
  return static_cast<int>(cudaGetLastError());
}
