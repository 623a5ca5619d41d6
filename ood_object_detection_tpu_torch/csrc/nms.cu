// K1: batched greedy (soft-)NMS for a fixed number of picks, one block per
// image.
//
// Replaces the Pallas TPU kernel `_nms_kernel` / `pallas_batched_nms`
// (ood_object_detection_tpu/ops/pallas_nms.py:26-127). The plain PyTorch
// version is `batched_nms_plain` in ood_object_detection_tpu_torch/ops/nms.py;
// the wrapper is ood_object_detection_tpu_torch/ops/cuda_nms.py.
//
// What bounds it on an H100: not bytes (an image's candidates are 20 B each,
// 100 KB at N = 5000) and not arithmetic (about 20 operations per candidate
// and pick), but latency: every pick depends on the one before it, so each
// of the `max_out` iterations is a block-wide argmax and an IoU pass
// separated by barriers. The design keeps the whole working set of an
// image (scores, the four coordinate planes, the areas: 24 B a candidate,
// 120 KB at N = 5000) in shared memory, so an iteration touches device
// memory only to write its pick, and it stops at the first iteration that
// finds no positive score: from there on no score can become positive
// again, so every later pick is (-1, 0) and is written without the loop.
// Images are independent blocks; at batch 128 they fill the 132 SMs.
//
// Exactness against the plain version:
//  - the argmax takes the lowest index among equal maxima, explicitly in
//    the per-thread scan, the warp shuffle and the cross-warp combine;
//  - this file is built with -fmad=false, so `(x2-x1)*(y2-y1)` and
//    `barea + area - inter` round like the plain version's separate
//    multiply and add, and the IoU compares with the threshold the same way;
//  - division is IEEE (no --use_fast_math) and the decay uses expf, not
//    __expf; expf may still differ from the CPU's exp in the last bit, so
//    soft-NMS scores are held to a relative tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           int n, int max_out, float iou_threshold, int soft, float sigma,
           float score_threshold, int* __restrict__ keep_idx,
           float* __restrict__ keep_scores) {
  extern __shared__ float smem[];
  float* s = smem;
  float* x1 = s + n;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ float pick_v;
  __shared__ int pick_i;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const float* bx = boxes + b * n * 4;
  for (int i = tid; i < n; i += kThreads) {
    const float a = bx[4 * i], c = bx[4 * i + 1];
    const float d = bx[4 * i + 2], e = bx[4 * i + 3];
    x1[i] = a;
    y1[i] = c;
    x2[i] = d;
    y2[i] = e;
    area[i] = (d - a) * (e - c);
    s[i] = scores[b * n + i];
  }
  __syncthreads();

  int* out_i = keep_idx + b * max_out;
  float* out_s = keep_scores + b * max_out;
  for (int m = 0; m < max_out; ++m) {
    // 1. block-wide (max, argmax); each thread scans its candidates in
    //    increasing index order, so a strict > keeps the lowest index
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      if (beats(s[i], i, bv, bi)) {
        bv = s[i];
        bi = i;
      }
    }
    warp_argmax(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = warp_v[lane];
      bi = warp_i[lane];
      warp_argmax(bv, bi);
      if (lane == 0) {
        pick_v = bv;
        pick_i = bi;
      }
    }
    __syncthreads();
    const float top_v = pick_v;
    const int top = pick_i;

    // 2. record the pick; once no score is positive, none can become
    //    positive again, and every remaining pick is (-1, 0)
    if (!(top_v > 0.0f)) {
      for (int j = m + tid; j < max_out; j += kThreads) {
        out_i[j] = -1;
        out_s[j] = 0.0f;
      }
      return;
    }
    if (tid == 0) {
      out_i[m] = top;
      out_s[m] = top_v;
    }

    // 3-5. IoU against the pick (0 where the boxes do not intersect),
    //      suppress or decay-and-prune, and zero the pick itself. Each
    //      thread writes only its own candidates, so the next scan needs
    //      no barrier; the two barriers above order pick_v / pick_i.
    const float px1 = x1[top], py1 = y1[top], px2 = x2[top], py2 = y2[top];
    const float parea = area[top];
    for (int i = tid; i < n; i += kThreads) {
      const float iw = fmaxf(fminf(px2, x2[i]) - fmaxf(px1, x1[i]), 0.0f);
      const float ih = fmaxf(fminf(py2, y2[i]) - fmaxf(py1, y1[i]), 0.0f);
      const float inter = iw * ih;
      const float uni = parea + area[i] - inter;
      const float iou = inter > 0.0f ? inter / uni : 0.0f;
      float v = s[i];
      if (soft) {
        v = v * expf(-(iou * iou) / sigma);
        v = v > score_threshold ? v : 0.0f;
      } else if (iou > iou_threshold) {
        v = 0.0f;
      }
      s[i] = i == top ? 0.0f : v;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory an image of n candidates needs.
int nms_smem_bytes(int n) { return 6 * n * (int)sizeof(float); }

// boxes [batch, n, 4] f32 xyxy, scores [batch, n] f32, both contiguous;
// keep_idx [batch, max_out] i32 and keep_scores [batch, max_out] f32 are
// written. Returns cudaGetLastError() after the launch.
int nms_launch(const void* boxes, const void* scores, int batch, int n,
               int max_out, float iou_threshold, int soft, float sigma,
               float score_threshold, void* keep_idx, void* keep_scores,
               void* stream) {
  const int smem = nms_smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  nms_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const float*)scores, n, max_out, iou_threshold,
      soft, sigma, score_threshold, (int*)keep_idx, (float*)keep_scores);
  return (int)cudaGetLastError();
}

}  // extern "C"
