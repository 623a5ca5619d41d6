// K1: batched greedy (soft-)NMS for a fixed number of picks: one pass a
// pick over candidates held in registers, and a thread block cluster an
// image when the batch leaves SMs idle.
//
// Replaces the Pallas TPU kernel `_nms_kernel` / `pallas_batched_nms`
// (ood_object_detection_tpu/ops/pallas_nms.py:26-127). The plain PyTorch
// version is `batched_nms_plain` in ood_object_detection_tpu_torch/ops/nms.py;
// the wrapper, and the choice of the cluster size, are in
// ood_object_detection_tpu_torch/ops/cuda_nms.py.
//
// What bounds it on an H100: not bytes (an image's candidates are 20 B each,
// 100 KB at N = 5000) and not arithmetic (about 10-20 operations per
// candidate and pick), but the chain of `max_out` dependent picks: each
// needs the argmax over all candidates of the scores the previous pick
// left. A pick costs the issue of its update on the SM's four schedulers
// plus the latency of its barriers. The levers are what one pick costs and
// how many SMs share an image.
//
// The design:
//  - An image is spread over C CTAs (C = 1, 2, 4 or 8, chosen by the
//    wrapper so that the batch's clusters fill the SMs and are all
//    resident at once, `nms_resident_images`), each of
//    `block_threads(n, C)` threads (at most 1024). CTA r owns the
//    contiguous slice [r * ceil(N/C), ...) of the candidates, K a thread,
//    and keeps their scores and coordinates in registers; every CTA holds
//    all N boxes in shared memory (16 B each), so the pick's box is local.
//  - One pass a pick: each thread applies pick m's suppression or decay to
//    its candidates and, in the same loop, tracks their new (max, lowest
//    index). A candidate whose score is <= 0 is skipped: it can never
//    become positive and never be picked. A candidate whose box cannot
//    intersect the pick's (four compares; other classes never do, as the
//    boxes are class-offset) keeps its score: its IoU is exactly 0, so its
//    decay is exactly 1, and soft-NMS's prune already took every score at
//    or below the threshold (at load, and at each earlier pick). The rest
//    take the IoU division and the exp, a thread's first one after the
//    loop, so that a warp pays for them about once a pick.
//  - Two CTA barriers a pick: every warp reduces its (max, lowest index)
//    with two warp reductions (redux.sync) and writes it to a slot; after
//    __syncthreads warp 0 alone combines the slots (the other warps do not
//    repeat the combine and its reductions), writes the pick to shared
//    memory and the output, and a second __syncthreads hands the pick to
//    every warp. (One barrier a pick, with every warp combining the slots
//    itself, was measured too and was no faster: the combine's reductions
//    then issue on every warp of the CTA instead of one.)
//  - In a cluster, warp 0 also exchanges the CTA's best with the other
//    CTAs: lane r stores it into its slot in CTA r by an asynchronous
//    remote store (`st.async ... mbarrier::complete_tx::bytes`), which
//    counts its 8 bytes on CTA r's barrier; warp 0 waits on its own CTA's
//    barrier until all C slots have landed and combines them with the same
//    rule. No cluster-wide barrier a pick: a CTA can run at most one pick
//    ahead of a partner (it needs the partner's push to finish a pick), so
//    slots and barriers double-buffered by pick parity are enough, each
//    barrier armed for its next phase as soon as its phase is read.
//  - It stops at the first pick that finds no positive score: from there
//    on no score can become positive again, so every later pick is (-1, 0).
//    CTA 0 of the cluster writes the output.
//
// Exactness against the plain version:
//  - the argmax takes the lowest index among equal maxima, explicitly in
//    the per-thread scan, the warp reduction and the slot combines;
//  - this file is built with -fmad=false, so `(x2-x1)*(y2-y1)` and
//    `parea + area - inter` round like the plain version's separate
//    multiply and add, and the IoU compares with the threshold the same way;
//  - the four compares only select which candidates take the exact IoU:
//    a box that passes them but whose intersection rounds to 0 is left as
//    the plain version leaves it;
//  - division is IEEE (no --use_fast_math) and the decay uses expf, not
//    __expf; expf may still differ from the CPU's exp in the last bit, so
//    soft-NMS scores are held to a relative tolerance, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;  // threads a CTA
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of the variable at `local` in CTA `rank`.
__device__ __forceinline__ uint32_t remote(uint32_t local, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(local), "r"(rank));
  return addr;
}

// Expect `bytes` more on the barrier this phase, and one arrival.
__device__ __forceinline__ void arm(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// This CTA's best of a pick, (score bits, index), into the slot at `slot`
// of CTA `dst` by an asynchronous remote store, which counts its 8 bytes
// on the barrier at `bar` of that CTA when it lands.
__device__ __forceinline__ void push(uint32_t slot, uint32_t bar, int dst,
                                     float v, int i) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(remote(slot, dst)),
      "r"(__float_as_uint(v)), "r"(i), "r"(remote(bar, dst))
      : "memory");
}

// Wait (acquire, cluster scope) for the completion of the barrier's phase
// of parity `parity`. A wait of over 2^36 clocks (tens of seconds) can only
// be a fault: trap, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void wait_cluster(uint64_t* bar, unsigned parity) {
  unsigned done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    if (now - start > (1LL << 36)) __trap();
  }
}

__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// (max, lowest index) over the warp, in every lane, by two warp reductions
// (redux.sync): v >= +0 (a lane with no positive score passes (0, INT_MAX)),
// so its bits order as its value; the index is the lowest of the lanes
// holding the maximum.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  const unsigned bits = __float_as_uint(v);
  const unsigned best = __reduce_max_sync(0xffffffffu, bits);
  i = (int)__reduce_min_sync(0xffffffffu,
                             bits == best ? (unsigned)i : 0xFFFFFFFFu);
  v = __uint_as_float(best);
}

// The score v of candidate idx, box b, after pick `top` (box pb, area
// parea), as the plain version computes it: zero for the pick itself; for
// an intersection > 0 the IoU, then gaussian decay and prune (soft) or
// suppression; for none, v as it was (soft: already above the threshold)
// or zero when an IoU of 0 suppresses (hard NMS at a threshold below 0).
__device__ __forceinline__ float after_pick(float v, int idx, int top,
                                            float4 b, float4 pb, float parea,
                                            int soft, float iou_threshold,
                                            float sigma,
                                            float score_threshold) {
  if (idx == top) return 0.0f;
  const float iw = fmaxf(fminf(pb.z, b.z) - fmaxf(pb.x, b.x), 0.0f);
  const float ih = fmaxf(fminf(pb.w, b.w) - fmaxf(pb.y, b.y), 0.0f);
  const float inter = iw * ih;
  if (!(inter > 0.0f)) {
    return !soft && 0.0f > iou_threshold ? 0.0f : v;
  }
  const float area = (b.z - b.x) * (b.w - b.y);
  const float iou = inter / (parea + area - inter);
  if (soft) {
    v = v * expf(-(iou * iou) / sigma);
    return v > score_threshold ? v : 0.0f;
  }
  return iou > iou_threshold ? 0.0f : v;
}

template <int K, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           int n, int max_out, float iou_threshold, int soft, float sigma,
           float score_threshold, int* __restrict__ keep_idx,
           float* __restrict__ keep_scores) {
  extern __shared__ float4 sbox[];  // all n boxes of the image
  __shared__ float slot_v[kMaxWarps];  // each warp's (max, lowest index)
  __shared__ int slot_i[kMaxWarps];
  __shared__ float pick_v;              // the pick, from warp 0 to all
  __shared__ int pick_i;
  // in a cluster: each CTA's best of a pick, (score bits, index), pushed
  // by that CTA into every CTA's slot [pick parity][its rank], and a
  // barrier a parity that completes when all C slots have landed
  __shared__ int2 cta_best[2][kMaxCluster];
  __shared__ __align__(8) uint64_t cta_full[2];

  int csize = 1, rank = 0;
  if (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    csize = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
  }
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warps = nthreads >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long image = blockIdx.x / csize;

  const float* bx = boxes + image * n * 4;
  if ((reinterpret_cast<uintptr_t>(bx) & 15) == 0) {
    const float4* b4 = reinterpret_cast<const float4*>(bx);
    for (int i = tid; i < n; i += nthreads) sbox[i] = b4[i];
  } else {
    for (int i = tid; i < n; i += nthreads) {
      sbox[i] = make_float4(bx[4 * i], bx[4 * i + 1], bx[4 * i + 2],
                            bx[4 * i + 3]);
    }
  }
  if (kCluster) {
    if (tid == 0) {
      for (int q = 0; q < 2; ++q) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(&cta_full[q]))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      // picks 0 and 1 expect C slots of 8 bytes each
      for (int q = 0; q < 2; ++q) arm(&cta_full[q], 8 * csize);
    }
    // every CTA's barriers are initialised and armed before any partner
    // pushes to them
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  // this thread's candidates: lo + tid + k * nthreads, k < K, below hi;
  // slots past hi hold score 0 and are never touched again. Soft-NMS's
  // prune (score > threshold) is applied at load: the first pick's update
  // would apply it to every candidate, and the first pick itself comes
  // from the raw scores (bv, bi).
  const int slice = (n + csize - 1) / csize;
  const int lo = rank * slice;
  const int hi = min(n, lo + slice);
  float s[K], x1[K], y1[K], x2[K], y2[K];
  float bv = 0.0f;  // a thread's best positive score and its lowest index
  int bi = INT_MAX;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int idx = lo + tid + k * nthreads;
    s[k] = 0.0f;
    x1[k] = y1[k] = x2[k] = y2[k] = 0.0f;
    if (idx < hi) {
      const float4 b = sbox[idx];
      x1[k] = b.x;
      y1[k] = b.y;
      x2[k] = b.z;
      y2[k] = b.w;
      const float v = scores[image * n + idx];
      if (v > bv) {  // idx grows with k: a strict > keeps the lowest
        bv = v;
        bi = idx;
      }
      s[k] = !soft || v > score_threshold ? v : 0.0f;
    }
  }

  const bool zero_iou_suppresses = !soft && 0.0f > iou_threshold;
  int* out_i = keep_idx + image * max_out;
  float* out_s = keep_scores + image * max_out;
  for (int m = 0; m < max_out; ++m) {
    // 1. the image's (max, lowest index): each warp's, then warp 0 combines
    //    the warps' (and in a cluster the CTAs') and hands the pick to all
    warp_argmax(bv, bi);
    if (lane == 0) {
      slot_v[warp] = bv;
      slot_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      float v = lane < warps ? slot_v[lane] : 0.0f;
      int i = lane < warps ? slot_i[lane] : INT_MAX;
      warp_argmax(v, i);
      if (kCluster) {
        const int p = m & 1;
        if (lane < csize) {  // lane r pushes to CTA r
          push(smem_addr(&cta_best[p][rank]), smem_addr(&cta_full[p]), lane,
               v, i);
        }
        wait_cluster(&cta_full[p], (m >> 1) & 1);
        const int2 b = lane < csize ? cta_best[p][lane] : make_int2(0, INT_MAX);
        // pick m + 2 takes this barrier's next phase: a partner can push to
        // it only after this CTA's push of pick m + 1, which comes later
        if (lane == 0) arm(&cta_full[p], 8 * csize);
        v = __int_as_float(b.x);
        i = b.y;
        warp_argmax(v, i);
      }
      if (lane == 0) {
        pick_v = v;
        pick_i = i;
        // 2. record the pick; once no score is positive, none can become
        //    positive again, and every remaining pick is (-1, 0)
        if (rank == 0) {
          const bool live = v > 0.0f;
          out_i[m] = live ? i : -1;
          out_s[m] = live ? v : 0.0f;
        }
      }
    }
    __syncthreads();
    const float top_v = pick_v;
    const int top = pick_i;
    if (!(top_v > 0.0f)) {
      if (rank == 0) {
        for (int j = m + 1 + tid; j < max_out; j += nthreads) {
          out_i[j] = -1;
          out_s[j] = 0.0f;
        }
      }
      break;
    }

    // 3. the update, and the new (max, lowest index) of this thread's
    //    candidates. A candidate that is not the pick and whose box cannot
    //    intersect the pick's keeps its score; the others take after_pick,
    //    a thread's first one after the loop.
    const float4 pb = sbox[top];
    const float parea = (pb.z - pb.x) * (pb.w - pb.y);
    bv = 0.0f;
    bi = INT_MAX;
    int pend = -1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = s[k];
      if (v > 0.0f) {
        const int idx = lo + tid + k * nthreads;
        const bool touch = idx == top || (x1[k] < pb.z && pb.x < x2[k] &&
                                          y1[k] < pb.w && pb.y < y2[k]);
        if (touch) {
          if (pend < 0) {
            pend = k;
            continue;
          }
          v = after_pick(v, idx, top, make_float4(x1[k], y1[k], x2[k], y2[k]),
                         pb, parea, soft, iou_threshold, sigma,
                         score_threshold);
          s[k] = v;
        } else if (zero_iou_suppresses) {
          v = 0.0f;
          s[k] = v;
        }
        if (v > bv) {  // idx grows with k: a strict > keeps the lowest
          bv = v;
          bi = idx;
        }
      }
    }
    if (pend >= 0) {
      const int idx = lo + tid + pend * nthreads;
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == pend) v = s[k];
      }
      v = after_pick(v, idx, top, sbox[idx], pb, parea, soft, iou_threshold,
                     sigma, score_threshold);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k == pend) s[k] = v;
      }
      if (v > 0.0f && beats(v, idx, bv, bi)) {
        bv = v;
        bi = idx;
      }
    }
  }
  // no CTA leaves while a partner may still push to it
  if (kCluster) cg::this_cluster().sync();
}

// Threads a CTA for a slice of ceil(n / cluster) candidates: one candidate
// a thread up to 1024 threads (whole warps), more a thread beyond.
int block_threads(int n, int cluster) {
  const int slice = (n + cluster - 1) / cluster;
  return std::min(kMaxThreads, std::max(32, (slice + 31) / 32 * 32));
}

// With `fit` set, only the number of images the card holds at once is
// written to it (resident clusters, or blocks at cluster 1), and nothing
// is launched.
template <int K, bool kCluster>
cudaError_t launch(const float* boxes, const float* scores, int batch, int n,
                   int max_out, float iou_threshold, int soft, float sigma,
                   float score_threshold, int cluster,
                   int threads, int* keep_idx, float* keep_scores,
                   cudaStream_t stream, int* fit) {
  auto kernel = nms_kernel<K, kCluster>;
  const int smem = n * (int)sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit != nullptr) {
      *fit = active;
      return cudaSuccess;
    }
    if (active < 1) return cudaErrorInvalidClusterSize;
  } else if (fit != nullptr) {
    int blocks = 0, sms = 0, dev = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    *fit = blocks * sms;
    return err;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, boxes, scores, n, max_out,
                           iou_threshold, soft, sigma, score_threshold,
                           keep_idx, keep_scores);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kCluster>
cudaError_t dispatch(int k, const float* boxes, const float* scores,
                     int batch, int n, int max_out, float iou_threshold,
                     int soft, float sigma, float score_threshold,
                     int cluster, int threads, int* keep_idx,
                     float* keep_scores, cudaStream_t stream, int* fit) {
#define NMS_K(KK)                                                          \
  if (k <= KK)                                                             \
    return launch<KK, kCluster>(boxes, scores, batch, n, max_out,          \
                                iou_threshold, soft, sigma,                \
                                score_threshold, cluster, threads,         \
                                keep_idx, keep_scores, stream, fit);
  NMS_K(1) NMS_K(2) NMS_K(3) NMS_K(4) NMS_K(5) NMS_K(8) NMS_K(12) NMS_K(16)
#undef NMS_K
  return cudaErrorInvalidValue;
}

// Launches the kernel, or with `fit` set writes how many images the card
// holds at once and launches nothing; see nms_launch.
int run(const void* boxes, const void* scores, int batch, int n, int max_out,
        float iou_threshold, int soft, float sigma, float score_threshold,
        int cluster, void* keep_idx, void* keep_scores, void* stream,
        int* fit) {
  if (!(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8)) {
    return (int)cudaErrorInvalidClusterSize;
  }
  const int threads = block_threads(n, cluster);
  const int slice = (n + cluster - 1) / cluster;
  const int k = (slice + threads - 1) / threads;
  auto go = cluster == 1 ? &dispatch<false> : &dispatch<true>;
  return (int)go(k, (const float*)boxes, (const float*)scores, batch, n,
                 max_out, iou_threshold, soft, sigma, score_threshold,
                 cluster, threads, (int*)keep_idx,
                 (float*)keep_scores, (cudaStream_t)stream, fit);
}

}  // namespace

extern "C" {

// boxes [batch, n, 4] f32 xyxy, scores [batch, n] f32, both contiguous;
// keep_idx [batch, max_out] i32 and keep_scores [batch, max_out] f32 are
// written. cluster is the CTAs an image (1, 2, 4 or 8); n at most 16
// candidates a thread of 1024 a CTA, and n boxes (16 n bytes) must fit a
// CTA's shared memory. Returns the launch's CUDA error
// (cudaErrorInvalidClusterSize where no cluster of that size fits an SM
// group), or cudaGetLastError() after it.
int nms_launch(const void* boxes, const void* scores, int batch, int n,
               int max_out, float iou_threshold, int soft, float sigma,
               float score_threshold, int cluster, void* keep_idx,
               void* keep_scores, void* stream) {
  return run(boxes, scores, batch, n, max_out, iou_threshold, soft, sigma,
             score_threshold, cluster, keep_idx, keep_scores, stream,
             nullptr);
}

// How many images of n candidates, at `cluster` CTAs an image, the current
// card holds at once (resident clusters, or blocks at cluster 1), into
// *fit. Returns the CUDA error of the occupancy query.
int nms_resident_images(int n, int cluster, int* fit) {
  return run(nullptr, nullptr, 1, n, 1, 0.5f, 0, 0.5f, 0.0f, cluster,
             nullptr, nullptr, nullptr, fit);
}

}  // extern "C"
