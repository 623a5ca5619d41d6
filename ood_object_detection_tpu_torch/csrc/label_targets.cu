// K4: the match codes and targets of the train-step labeler, from K3's
// outputs. For every (image, anchor): the final match code (>= 0 the
// matched ground-truth row, -1 background, -2 ignored) from the
// thresholds and the force-match, the class target (class - 1, -1
// background, -2 ignored) and the Faster-RCNN box encoding (ty, tx, th, tw)
// of the matched row against the anchor, zeros where the anchor has no
// match; and each image's count of positives.
//
// Replaces the Pallas TPU kernel `_targets_kernel` / `pallas_batch_targets`
// (ood_object_detection_tpu/ops/pallas_labeler.py:86-133, :201-246) and the
// XLA step before it, the thresholds and force-match of
// `pallas_label_match` (:249-280). The plain PyTorch version is
// `batch_codes_targets_plain` (`label_match`, then `batch_targets_plain`) in
// ood_object_detection_tpu_torch/ops/cuda_labeler.py, which also wraps this
// kernel (`batch_codes_targets`).
//
// What bounds it on an H100: bytes. Each (image, anchor) reads 8 B (K3's
// IoU and row) and writes 24 B (code, class, box); the anchors (16 B each)
// are read for the positives only, the rows (25 B each) once a block and
// then hit in L2. A handful of operations an anchor, about 20 a positive.
//
// Design: a block a (tile of kTile anchors, image), one kernel launch:
//  - each thread first issues the loads of its kPerThread anchors' IoU and
//    row (strided by the block width, coalesced), so they are in flight
//    while the block stages its image's rows in shared memory (box, class,
//    and the best anchor of each valid row, -1 for a padded one, by row
//    index) and builds the tile's force-match claims there: each valid row
//    whose best anchor lies in the tile takes an atomicMin of its index on
//    that anchor's slot, so the lowest row wins a contested anchor (the
//    scatter-min of `label_match`);
//  - each thread thresholds its IoUs in f32 with strict < (below
//    `unmatched_threshold`: -1; below `matched_threshold`: -2; else K3's
//    row), lets a claim override, and writes the code, the class and the
//    box as one 16-byte store;
//  - the block adds its count of positives to its image's with one f32
//    atomicAdd; the launch function zeroes the counts first
//    (cudaMemsetAsync). The counts are whole numbers below 2^24, so the
//    sum is exact in any order.
// Many small blocks (24 a D0@512 image) rather than a cluster of 8 CTAs an
// image, which added the counts in distributed shared memory with no
// memset but reached 63 % of the bytes bound at batch 128: its 1024 CTAs
// fill the card only if every cluster is resident at once.
//
// The encoding follows box_coder.encode_boxes operation for operation:
// centres from the raw heights and widths, EPS added after the centres,
// IEEE division and logf (not __logf); this file is built with
// -fmad=false, so `y1 + 0.5 * h` rounds like the plain version's separate
// multiply and add.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr float kEps = 1e-8f;  // box_coder.EPS

__global__ void __launch_bounds__(kThreads)
codes_targets_kernel(const float4* __restrict__ anchors, int num_anchors,
                     const float4* __restrict__ gt,
                     const int* __restrict__ gt_classes,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ vals,
                     const int* __restrict__ rows,
                     const int* __restrict__ best_anchor, int m,
                     float matched_threshold, float unmatched_threshold,
                     int* __restrict__ codes_out, int* __restrict__ cls_out,
                     float4* __restrict__ box_out,
                     float* __restrict__ num_positives) {
  // the image's rows by row index: [m] each, 24 B a row
  extern __shared__ float4 sbox[];
  int* scls = reinterpret_cast<int*>(sbox + m);
  int* sbest = scls + m;  // best anchor of a valid row, -1 for a padded one
  __shared__ int claim[kTile];
  __shared__ int warp_pos[kWarps];

  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int lo = blockIdx.x * kTile;
  const long long out0 = b * num_anchors;

  float v[kPerThread];
  int r[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = lo + k * kThreads + tid;
    v[k] = 0.0f;
    r[k] = 0;
    if (a < num_anchors) {
      v[k] = vals[out0 + a];
      r[k] = rows[out0 + a];
    }
  }
  for (int i = tid; i < kTile; i += kThreads) claim[i] = m;
  for (int i = tid; i < m; i += kThreads) {
    sbox[i] = gt[b * m + i];
    scls[i] = gt_classes[b * m + i];
    sbest[i] = valid[b * m + i] != 0 ? best_anchor[b * m + i] : -1;
  }
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) {
    const int t = sbest[i] - lo;
    if (t >= 0 && t < kTile) atomicMin(&claim[t], i);
  }
  __syncthreads();

  int positives = 0;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int a = lo + k * kThreads + tid;
    if (a >= num_anchors) continue;
    int code = r[k];
    if (v[k] < unmatched_threshold) {
      code = -1;
    } else if (v[k] < matched_threshold) {
      code = -2;
    }
    const int c = claim[k * kThreads + tid];
    if (c < m) code = c;
    float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
    int cls;
    if (code >= 0) {
      ++positives;
      const float4 g = sbox[code];
      cls = scls[code] - 1;
      const float4 an = anchors[a];
      const float ha_r = an.z - an.x;
      const float wa_r = an.w - an.y;
      const float yca = an.x + 0.5f * ha_r;
      const float xca = an.y + 0.5f * wa_r;
      const float ha = ha_r + kEps;
      const float wa = wa_r + kEps;
      const float h_r = g.z - g.x;
      const float w_r = g.w - g.y;
      const float yc = g.x + 0.5f * h_r;
      const float xc = g.y + 0.5f * w_r;
      const float h = h_r + kEps;
      const float w = w_r + kEps;
      out.x = (yc - yca) / ha;
      out.y = (xc - xca) / wa;
      out.z = logf(h / ha);
      out.w = logf(w / wa);
    } else {
      cls = code == -2 ? -2 : -1;
    }
    codes_out[out0 + a] = code;
    cls_out[out0 + a] = cls;
    box_out[out0 + a] = out;
  }

  positives = __reduce_add_sync(0xffffffffu, positives);
  if ((tid & 31) == 0) warp_pos[tid >> 5] = positives;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_pos[w];
    if (total != 0) atomicAdd(&num_positives[b], (float)total);
  }
}

}  // namespace

extern "C" {

// anchors [num_anchors, 4] f32 yxyx, gt [batch, m, 4] f32 yxyx, gt_classes
// [batch, m] i32, valid [batch, m] bool, and K3's outputs vals [batch,
// num_anchors] f32, rows [batch, num_anchors] i32 (each < m) and
// best_anchor [batch, m] i32, all contiguous; batch at most 65535. Zeroes
// num_positives [batch] f32, then writes it, codes_out and cls_out [batch,
// num_anchors] i32 and box_out [batch, num_anchors, 4] f32. Needs 24 * m
// bytes of dynamic shared memory a block, at most 40 KB. Returns the first
// CUDA error of the two operations.
int codes_targets_launch(const void* anchors, int num_anchors, const void* gt,
                         const void* gt_classes, const void* valid,
                         const void* vals, const void* rows,
                         const void* best_anchor, int batch, int m,
                         float matched_threshold, float unmatched_threshold,
                         void* codes_out, void* cls_out, void* box_out,
                         void* num_positives, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(num_positives, 0, (size_t)batch * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_anchors + kTile - 1) / kTile, batch);
  const int smem = m * (int)(sizeof(float4) + 2 * sizeof(int));
  codes_targets_kernel<<<grid, kThreads, smem, s>>>(
      (const float4*)anchors, num_anchors, (const float4*)gt,
      (const int*)gt_classes, (const unsigned char*)valid,
      (const float*)vals, (const int*)rows, (const int*)best_anchor, m,
      matched_threshold, unmatched_threshold, (int*)codes_out, (int*)cls_out,
      (float4*)box_out, (float*)num_positives);
  return (int)cudaGetLastError();
}

}  // extern "C"
