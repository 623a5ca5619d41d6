// K3: the anchor match of the train-step labeler. For every image, the IoU
// of every ground-truth row against every anchor, reduced two ways: per
// anchor, the max IoU and the lowest row that reaches it; per row, the
// lowest anchor that reaches the row's max. Invalid rows score -1.
//
// Replaces the Pallas TPU kernel `_match_kernel` / `pallas_batch_match`
// (ood_object_detection_tpu/ops/pallas_labeler.py:40-83, :146-197). The
// plain PyTorch version is `batch_match_plain` in
// ood_object_detection_tpu_torch/ops/cuda_labeler.py, which also wraps this
// kernel (`batch_match`).
//
// What bounds it on an H100: operations. At D0@512 an image has 49,104
// anchors and 100 rows: 4.9 M IoU pairs of about 17 f32 operations each
// (min, max, sub, clamp, mul, add, compare, one IEEE division), against
// only 21 bytes of output an anchor (value, row) and 4 a row.
//
// Design. The TPU kernel computed an [M, 4096] tile in VMEM and combined
// per-block row maxima afterwards, earliest block first. Here:
//  - grid = (anchor tiles of kTile, batch); a block stages its image's rows
//    (four coordinates, area, valid) in shared memory, 24 B a row;
//  - each thread owns kPerThread anchors (strided by the block width, so
//    loads coalesce) and walks the rows in order; a strict > keeps the
//    lowest row among equal maxima;
//  - per row, each thread has the best of its anchors (lowest anchor among
//    equals, as it walks them in increasing order); the warp takes the max
//    of the order-preserving u32 image of the IoU (__reduce_max_sync), then
//    the lowest anchor among the lanes that reach it (__reduce_min_sync),
//    and lane 0 folds (iou, ~anchor) as one u64 key into the block's
//    shared-memory key of the row with atomicMax. After the last row the
//    block folds its keys into the image's keys in device memory with one
//    64-bit atomicMax a row. The key puts the IoU in the high word and
//    ~anchor in the low word, so the max is the highest IoU at the lowest
//    anchor whatever order the atomics run in;
//  - a second, tiny launch turns each row's key into its anchor index.
// The wrapper zeroes the key buffer (0 is below every key) and allocates
// the outputs; the kernels allocate nothing.
//
// Exactness against the plain version: the IoU is computed with the plain
// version's operations in its order, `(area_g + area_a) - inter` included,
// 0 where the boxes do not intersect, IEEE division; this file is built
// with -fmad=false so no multiply and add contract into an FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;

// order-preserving map of a float onto u32 (larger float, larger image);
// 0 is below the image of every float
__device__ __forceinline__ unsigned int mono(float v) {
  const unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
match_kernel(const float4* __restrict__ anchors, int num_anchors,
             const float4* __restrict__ gt, const unsigned char* __restrict__ valid,
             int m, float* __restrict__ vals, int* __restrict__ rows,
             unsigned long long* __restrict__ row_keys) {
  extern __shared__ float smem[];
  float* gy1 = smem;
  float* gx1 = gy1 + m;
  float* gy2 = gx1 + m;
  float* gx2 = gy2 + m;
  float* garea = gx2 + m;
  float* gvalid = garea + m;
  // 24 B a row above: the u64 keys start 8-byte aligned
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(gvalid + m);

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  for (int i = tid; i < m; i += kThreads) {
    const float4 g = gt[b * m + i];
    gy1[i] = g.x;
    gx1[i] = g.y;
    gy2[i] = g.z;
    gx2[i] = g.w;
    garea[i] = (g.z - g.x) * (g.w - g.y);
    gvalid[i] = valid[b * m + i] ? 1.0f : 0.0f;
    keys[i] = 0ull;
  }
  __syncthreads();

  float ay1[kPerThread], ax1[kPerThread], ay2[kPerThread], ax2[kPerThread];
  float aarea[kPerThread], best_v[kPerThread];
  int best_r[kPerThread];
  const int base = blockIdx.x * kTile + tid;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = base + k * kThreads;
    float4 an = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a < num_anchors) an = anchors[a];
    ay1[k] = an.x;
    ax1[k] = an.y;
    ay2[k] = an.z;
    ax2[k] = an.w;
    aarea[k] = (an.z - an.x) * (an.w - an.y);
    best_v[k] = -INFINITY;
    best_r[k] = 0;
  }

  for (int r = 0; r < m; ++r) {
    const bool ok = gvalid[r] != 0.0f;
    const float py1 = gy1[r], px1 = gx1[r], py2 = gy2[r], px2 = gx2[r];
    const float parea = garea[r];
    unsigned int tkey = 0u;            // best IoU image of this thread's anchors
    unsigned int tanchor = 0xffffffffu;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int a = base + k * kThreads;
      if (a >= num_anchors) continue;
      float v = -1.0f;
      if (ok) {
        const float ih = fmaxf(fminf(py2, ay2[k]) - fmaxf(py1, ay1[k]), 0.0f);
        const float iw = fmaxf(fminf(px2, ax2[k]) - fmaxf(px1, ax1[k]), 0.0f);
        const float inter = ih * iw;
        const float uni = parea + aarea[k] - inter;
        v = inter == 0.0f ? 0.0f : inter / uni;
      }
      if (v > best_v[k]) {
        best_v[k] = v;
        best_r[k] = r;
      }
      const unsigned int key = mono(v);
      if (key > tkey) {                // anchors rise with k: lowest wins
        tkey = key;
        tanchor = (unsigned int)a;
      }
    }
    const unsigned int wkey = __reduce_max_sync(0xffffffffu, tkey);
    const unsigned int wanchor =
        __reduce_min_sync(0xffffffffu, tkey == wkey ? tanchor : 0xffffffffu);
    if ((tid & 31) == 0 && wkey != 0u) {
      atomicMax(&keys[r], ((unsigned long long)wkey << 32) | (unsigned long long)(~wanchor));
    }
  }

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = base + k * kThreads;
    if (a < num_anchors) {
      vals[b * num_anchors + a] = best_v[k];
      rows[b * num_anchors + a] = best_r[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) {
    if (keys[i] != 0ull) atomicMax(&row_keys[b * m + i], keys[i]);
  }
}

__global__ void row_anchor_kernel(const unsigned long long* __restrict__ row_keys,
                                  int n, int* __restrict__ best_anchor) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) best_anchor[i] = (int)(~(unsigned int)(row_keys[i] & 0xffffffffull));
}

}  // namespace

extern "C" {

// anchors [num_anchors, 4] f32 yxyx, gt [batch, m, 4] f32 yxyx, valid
// [batch, m] bool (one byte each), all contiguous. Writes vals [batch,
// num_anchors] f32, rows [batch, num_anchors] i32 and best_anchor [batch,
// m] i32; row_keys [batch, m] u64 is scratch the caller zeroes. Returns
// cudaGetLastError() after the launches.
int match_launch(const void* anchors, int num_anchors, const void* gt,
                 const void* valid, int batch, int m, void* vals, void* rows,
                 void* row_keys, void* best_anchor, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int smem = m * (6 * (int)sizeof(float) + (int)sizeof(unsigned long long));
  const dim3 grid((num_anchors + kTile - 1) / kTile, batch);
  match_kernel<<<grid, kThreads, smem, s>>>(
      (const float4*)anchors, num_anchors, (const float4*)gt,
      (const unsigned char*)valid, m, (float*)vals, (int*)rows,
      (unsigned long long*)row_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = batch * m;
  row_anchor_kernel<<<(n + 255) / 256, 256, 0, s>>>(
      (const unsigned long long*)row_keys, n, (int*)best_anchor);
  return (int)cudaGetLastError();
}

}  // extern "C"
