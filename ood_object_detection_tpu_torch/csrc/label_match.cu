// K3: the anchor match of the train-step labeler. For every image, the IoU
// of every ground-truth row against every anchor, reduced two ways: per
// anchor, the max IoU and the lowest row that reaches it; per row, the
// lowest anchor that reaches the row's max. Invalid rows score -1.
//
// Replaces the Pallas TPU kernel `_match_kernel` / `pallas_batch_match`
// (ood_object_detection_tpu/ops/pallas_labeler.py:40-83, :146-197). The
// plain PyTorch version is `batch_match_plain` in
// ood_object_detection_tpu_torch/ops/cuda_labeler.py, which also wraps this
// kernel (`batch_match`) and chooses the split of the anchors
// (`match_share`).
//
// What bounds it on an H100: operations. At D0@512 an image has 49,104
// anchors; the train path's images have 16 valid rows of 100, so 0.79 M
// valid IoU pairs an image. Each needs about 10 f32 operations (min, max,
// sub and clamp on each axis, the product, its zero test), and the few
// percent of pairs whose boxes meet about 7 more (the union, one IEEE
// division, the compares, the key), against 8 bytes of output an anchor
// (value, row) and 4 a row. A padded row costs no IoU.
//
// Design: one thread block cluster of kCluster CTAs an image, one launch,
// no scratch in device memory.
//  - Each CTA compacts its image's valid rows into shared memory, in row
//    order (a warp ballot and popc, then a prefix over the warps' counts):
//    box, area, row index and a u64 key a row, 32 B. The hot loop runs
//    over the nv valid rows only; rows in increasing order and a strict >
//    keep the lowest row among an anchor's equal maxima.
//  - CTA r of the cluster owns the anchors [r * share, (r + 1) * share)
//    (`share` from the host) and walks them in chunks of kThreads x
//    kPerThread, each thread kPerThread anchors strided by the block width
//    (coalesced loads), held in registers, so any anchor count works.
//  - Only where the boxes meet (inter != 0) does a pair take the union and
//    the division, and update the anchor's best and the thread's best for
//    the row. Every valid row scores at least 0, so an anchor starts at
//    (0, the first valid row) and a zero IoU changes nothing.
//  - Per row, the CTA's key (IoU image in the high word, ~anchor in the
//    low) starts at (0, ~first anchor of the share): exactly what its
//    zero-IoU anchors would give. A warp where no lane met the row
//    (__any_sync) skips the two warp reductions and the shared atomicMax;
//    a row that meets no anchor thus ends at anchor 0.
//  - After its last chunk the cluster syncs; CTA 0 folds the partners'
//    keys through distributed shared memory, writes each valid row's
//    anchor and 0 for each padded row (what the plain version gives for an
//    all-(-1) row), and a second cluster barrier keeps every CTA's shared
//    memory alive until CTA 0 has read it.
//
// Exactness against the plain version: the IoU is computed with the plain
// version's operations in its order, `(area_g + area_a) - inter` included,
// 0 where the boxes do not intersect, IEEE division; this file is built
// with -fmad=false so no multiply and add contract into an FMA. A slot past
// the share's end holds the box (0, 0, 0, 0), whose intersection with any
// box is 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // CTAs an image: the portable cluster size
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 8;
constexpr int kChunk = kThreads * kPerThread;
constexpr unsigned int kFull = 0xffffffffu;
// dynamic shared memory a launch may take without opting in (48 KB in all,
// less this kernel's static arrays)
constexpr int kSmemNoOptIn = 47 * 1024;

// order-preserving map of a float onto u32 (larger float, larger image);
// 0 is below the image of every float
__device__ __forceinline__ unsigned int mono(float v) {
  const unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
match_kernel(const float4* __restrict__ anchors, int num_anchors, int share,
             const float4* __restrict__ gt,
             const unsigned char* __restrict__ valid, int m,
             float* __restrict__ vals, int* __restrict__ rows,
             int* __restrict__ best_anchor) {
  // the image's valid rows, compacted in order: [m] each, 32 B a row
  extern __shared__ float4 sbox[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(sbox + m);
  float* sarea = reinterpret_cast<float*>(keys + m);
  int* srow = reinterpret_cast<int*>(sarea + m);
  __shared__ int warp_count[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x / kCluster;
  const int lo = min(num_anchors, rank * share);
  const int hi = min(num_anchors, lo + share);
  const unsigned long long seed =
      lo < hi ? ((unsigned long long)mono(0.0f) << 32) | (unsigned int)~lo
              : 0ull;

  // 1. compact the valid rows, keeping their order
  int nv = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + tid;
    const bool ok = i < m && valid[b * m + i] != 0;
    const unsigned int ballot = __ballot_sync(kFull, ok);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = nv, total = nv;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_count[w];
      if (w < warp) before += c;
      total += c;
    }
    if (ok) {
      const int j = before + __popc(ballot & ((1u << lane) - 1u));
      const float4 g = gt[b * m + i];
      sbox[j] = g;
      sarea[j] = (g.z - g.x) * (g.w - g.y);
      srow[j] = i;
      keys[j] = seed;
    }
    nv = total;
    __syncthreads();  // the rows are in place; warp_count is free again
  }

  // 2. the share, a chunk at a time
  for (int c0 = lo; c0 < hi; c0 += kChunk) {
    float ay1[kPerThread], ax1[kPerThread], ay2[kPerThread], ax2[kPerThread];
    float aarea[kPerThread], best_v[kPerThread];
    int best_j[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int a = c0 + k * kThreads + tid;
      const float4 an = a < hi ? anchors[a] : make_float4(0.f, 0.f, 0.f, 0.f);
      ay1[k] = an.x;
      ax1[k] = an.y;
      ay2[k] = an.z;
      ax2[k] = an.w;
      aarea[k] = (an.z - an.x) * (an.w - an.y);
      best_v[k] = nv > 0 ? 0.0f : -1.0f;
      best_j[k] = 0;
    }
    for (int j = 0; j < nv; ++j) {
      const float4 g = sbox[j];
      const float parea = sarea[j];
      unsigned int tkey = 0u;  // this thread's best IoU image for row j
      unsigned int tanchor = 0xffffffffu;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float ih = fmaxf(fminf(g.z, ay2[k]) - fmaxf(g.x, ay1[k]), 0.0f);
        const float iw = fmaxf(fminf(g.w, ax2[k]) - fmaxf(g.y, ax1[k]), 0.0f);
        const float inter = ih * iw;
        if (inter != 0.0f) {
          const float v = inter / ((parea + aarea[k]) - inter);
          if (v > best_v[k]) {
            best_v[k] = v;
            best_j[k] = j;
          }
          const unsigned int key = mono(v);
          if (key > tkey) {  // anchors rise with k: the lowest wins
            tkey = key;
            tanchor = (unsigned int)(c0 + k * kThreads + tid);
          }
        }
      }
      if (__any_sync(kFull, tkey != 0u)) {
        const unsigned int wkey = __reduce_max_sync(kFull, tkey);
        const unsigned int wanchor =
            __reduce_min_sync(kFull, tkey == wkey ? tanchor : 0xffffffffu);
        if (lane == 0) {
          atomicMax(&keys[j], ((unsigned long long)wkey << 32) |
                                  (unsigned long long)(~wanchor));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int a = c0 + k * kThreads + tid;
      if (a < hi) {
        vals[b * num_anchors + a] = best_v[k];
        rows[b * num_anchors + a] = nv > 0 ? srow[best_j[k]] : 0;
      }
    }
  }

  // 3. CTA 0 folds the cluster's keys of each row
  cluster.sync();
  if (rank == 0) {
    for (int i = tid; i < m; i += kThreads) {
      if (valid[b * m + i] == 0) best_anchor[b * m + i] = 0;
    }
    for (int j = tid; j < nv; j += kThreads) {
      unsigned long long key = 0ull;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const unsigned long long k = cluster.map_shared_rank(keys, r)[j];
        key = k > key ? k : key;
      }
      best_anchor[b * m + srow[j]] = (int)~(unsigned int)(key & 0xffffffffull);
    }
  }
  // no CTA leaves while CTA 0 may still read its keys
  cluster.sync();
}

}  // namespace

extern "C" {

// anchors [num_anchors, 4] f32 yxyx, gt [batch, m, 4] f32 yxyx, valid
// [batch, m] bool (one byte each), all contiguous; CTA r of an image's
// cluster takes the anchors [r * share, (r + 1) * share), so share * 8 must
// reach num_anchors. Writes vals [batch, num_anchors] f32, rows [batch,
// num_anchors] i32 and best_anchor [batch, m] i32. Needs 32 * m bytes of
// shared memory a CTA. Returns the launch's CUDA error, or
// cudaGetLastError() after it.
int match_launch(const void* anchors, int num_anchors, int share,
                 const void* gt, const void* valid, int batch, int m,
                 void* vals, void* rows, void* best_anchor, void* stream) {
  const int smem = m * (int)(sizeof(float4) + sizeof(unsigned long long) +
                             sizeof(float) + sizeof(int));
  cudaError_t err;
  if (smem > kSmemNoOptIn) {
    err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, match_kernel, (const float4*)anchors,
                           num_anchors, share, (const float4*)gt,
                           (const unsigned char*)valid, m, (float*)vals,
                           (int*)rows, (int*)best_anchor);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
