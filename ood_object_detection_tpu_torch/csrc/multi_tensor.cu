// Multi-tensor kernels of the optimizer update: the global norm of a list of
// f32 tensors, the clip that scales them by it in place, and the EMA of one
// list of tensors toward another, each walking every tensor of its list in
// one launch (one more for each further table, below).
//
// Replaces no Pallas kernel: on the TPU the update is part of one jitted XLA
// program (optax's `clip_by_global_norm` and the EMA's `tree_map` in
// ood_object_detection_tpu/train/train_state.py), which XLA fuses. Run
// eagerly, the port's per-tensor loops launched 7 kernels a tensor for the
// clip and 4 for the EMA: 4,664 launches a D0 step (424 tensors) for 6.6 ms
// of device work, the host's launch rate setting the update's time. The
// plain PyTorch versions (`global_norm_plain`, `clip_scale_plain_`,
// `ema_update_plain_`) and the wrappers (`global_norm_clip_`, `ema_update_`)
// are in ood_object_detection_tpu_torch/ops/cuda_update.py.
//
// What bounds it on an H100: bytes. The norm reads each value once (4 B),
// the clip reads and writes it when the norm reaches the limit (8 B, else
// nothing), the EMA reads two values and writes one (12 B): 15.5, 31 and
// 46.5 MB at D0's 3,877,763 values, 4.6-13.9 us at 3.35 TB/s. At that size
// a launch's fixed cost is of the same order.
//
// Design:
//  - The wrapper passes each tensor's address and size; the launch functions
//    pack them into tables passed by value as the kernel's parameters (4 KB
//    a launch: 239 tensors with one list, 159 with two) and launch once a
//    table. Each tensor is cut into chunks of kChunk values, a block a
//    chunk, found by a binary search over the table's first chunk of each
//    tensor. float4 loads and stores where the chunk's address is 16-byte
//    aligned (the caching allocator's blocks are), a scalar loop for the
//    rest and for an unaligned chunk.
//  - The sum of squares is deterministic: each thread sums its values in a
//    fixed order, the block adds its threads' sums in a fixed tree and writes
//    one partial a chunk; one block of a second launch adds the partials in
//    index order the same way and writes the square root to a device scalar.
//    No float atomics: the same inputs give the same bits.
//  - The clip reads that scalar on the device (no sync with the host) and
//    computes `norm < max_norm ? g : g / norm * max_norm`, the plain path's
//    `where`; the EMA `e * d + p * (1 - d)`. This file is built with
//    -fmad=false, so each product and sum rounds like the plain path's
//    separate PyTorch operations: the clip (given the same norm) and the EMA
//    are bit-equal to them, and the norm differs from theirs by the order of
//    its sum alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 16384;  // values a block: 8 float4 a thread
constexpr int kNormThreads = 1024;
// a table's bytes, within the 4,096 bytes of a launch's parameters beside
// the kernel's other arguments (at most 16 bytes)
constexpr int kTableBytes = 3840;

template <int kLists>
struct Table {
  static constexpr int kMax = (kTableBytes - 16) / (8 * kLists + 8);
  float* ptr[kLists][kMax];
  int numel[kMax];
  int first[kMax + 1];  // tensor i's chunks: [first[i], first[i + 1])
  int n;                // tensors in the table
  int chunk_base;       // the table's first chunk in the whole list
};
static_assert(sizeof(Table<1>) <= kTableBytes, "one-list table too large");
static_assert(sizeof(Table<2>) <= kTableBytes, "two-list table too large");

// The tensor of the table that holds the launch's chunk c: the last one
// whose first chunk is at most c (the table holds no empty tensor).
template <int kLists>
__device__ __forceinline__ int tensor_of(const Table<kLists>& t, int c) {
  int lo = 0, hi = t.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The sum of v over the block's kBlock threads in a fixed order: within each
// warp by shuffles, then over the warps' sums. Valid in thread 0.
template <int kBlock>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    v = threadIdx.x < kBlock / 32 ? warp_sums[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One partial sum of squares a chunk, at partials[chunk_base + chunk].
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const __grid_constant__ Table<1> t, float* __restrict__ partials) {
  const int c = blockIdx.x;
  const int i = tensor_of(t, c);
  const int start = (c - t.first[i]) * kChunk;
  const int len = min(kChunk, t.numel[i] - start);
  const float* x = t.ptr[0][i] + start;
  float acc = 0.f;
  int tail = 0;
  if (aligned16(x)) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (int k = threadIdx.x; k < len / 4; k += kThreads) {
      const float4 v = x4[k];
      acc += v.x * v.x;
      acc += v.y * v.y;
      acc += v.z * v.z;
      acc += v.w * v.w;
    }
    tail = len / 4 * 4;
  }
  for (int k = tail + threadIdx.x; k < len; k += kThreads) acc += x[k] * x[k];
  acc = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partials[t.chunk_base + c] = acc;
}

// *norm = sqrt of the sum of the first `count` partials.
__global__ void __launch_bounds__(kNormThreads)
norm_kernel(const float* __restrict__ partials, int count,
            float* __restrict__ norm) {
  float acc = 0.f;
  for (int k = threadIdx.x; k < count; k += kNormThreads) acc += partials[k];
  acc = block_sum<kNormThreads>(acc);
  if (threadIdx.x == 0) *norm = sqrtf(acc);
}

__global__ void __launch_bounds__(kThreads)
scale_kernel(const __grid_constant__ Table<1> t, const float* __restrict__ norm,
             float max_norm) {
  const float s = *norm;
  if (s < max_norm) return;  // the plain path keeps g (a NaN norm scales)
  const int c = blockIdx.x;
  const int i = tensor_of(t, c);
  const int start = (c - t.first[i]) * kChunk;
  const int len = min(kChunk, t.numel[i] - start);
  float* g = t.ptr[0][i] + start;
  int tail = 0;
  if (aligned16(g)) {
    float4* g4 = reinterpret_cast<float4*>(g);
    for (int k = threadIdx.x; k < len / 4; k += kThreads) {
      float4 v = g4[k];
      v.x = v.x / s * max_norm;
      v.y = v.y / s * max_norm;
      v.z = v.z / s * max_norm;
      v.w = v.w / s * max_norm;
      g4[k] = v;
    }
    tail = len / 4 * 4;
  }
  for (int k = tail + threadIdx.x; k < len; k += kThreads) {
    g[k] = g[k] / s * max_norm;
  }
}

__global__ void __launch_bounds__(kThreads)
ema_kernel(const __grid_constant__ Table<2> t, float d, float one_minus) {
  const int c = blockIdx.x;
  const int i = tensor_of(t, c);
  const int start = (c - t.first[i]) * kChunk;
  const int len = min(kChunk, t.numel[i] - start);
  float* e = t.ptr[0][i] + start;
  const float* p = t.ptr[1][i] + start;
  int tail = 0;
  if (aligned16(e) && aligned16(p)) {
    float4* e4 = reinterpret_cast<float4*>(e);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    for (int k = threadIdx.x; k < len / 4; k += kThreads) {
      float4 a = e4[k];
      const float4 b = p4[k];
      a.x = a.x * d + b.x * one_minus;
      a.y = a.y * d + b.y * one_minus;
      a.z = a.z * d + b.z * one_minus;
      a.w = a.w * d + b.w * one_minus;
      e4[k] = a;
    }
    tail = len / 4 * 4;
  }
  for (int k = tail + threadIdx.x; k < len; k += kThreads) {
    e[k] = e[k] * d + p[k] * one_minus;
  }
}

// Packs the non-empty tensors of kLists lists (addresses lists[l][i], sizes
// numel[i]) into tables and calls launch(table, chunks) for each, in order.
// Returns the first error.
template <int kLists, typename Launch>
cudaError_t for_each_table(const int64_t* const* lists, const int64_t* numel,
                           int n, Launch launch) {
  Table<kLists> t{};
  for (int i = 0; i < n; ++i) {
    if (numel[i] == 0) continue;
    if (t.n == Table<kLists>::kMax) {
      const cudaError_t err = launch(t, t.first[t.n]);
      if (err != cudaSuccess) return err;
      t.chunk_base += t.first[t.n];
      t.n = 0;
    }
    for (int l = 0; l < kLists; ++l) {
      t.ptr[l][t.n] = reinterpret_cast<float*>(lists[l][i]);
    }
    t.numel[t.n] = (int)numel[i];
    t.first[t.n + 1] = t.first[t.n] + (int)((numel[i] + kChunk - 1) / kChunk);
    ++t.n;
  }
  return t.n ? launch(t, t.first[t.n]) : cudaSuccess;
}

}  // namespace

extern "C" {

// The values of a chunk (a block's share of a tensor).
int multi_tensor_chunk(void) { return kChunk; }

// In every function: n tensors of f32, each dense in memory (its values at
// consecutive addresses in any order of indices), at the addresses `ptrs`
// with the sizes `numel` (each below 2^31); the work is queued on `stream`.
// Each returns the first CUDA error.

// *norm (a device f32) = sqrt(sum of x * x over every value), through
// `partials`, device f32 scratch of `capacity` values: at least the number
// of chunks, sum(ceil(numel / kChunk)), else cudaErrorInvalidValue and
// nothing is queued.
int global_norm_launch(const int64_t* ptrs, const int64_t* numel, int n,
                       void* partials, int capacity, void* norm,
                       void* stream) {
  int64_t chunks = 0;
  for (int i = 0; i < n; ++i) chunks += (numel[i] + kChunk - 1) / kChunk;
  if (chunks > capacity) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* out = (float*)partials;
  const int64_t* lists[1] = {ptrs};
  const cudaError_t err = for_each_table<1>(
      lists, numel, n, [&](const Table<1>& t, int grid) {
        sumsq_kernel<<<grid, kThreads, 0, s>>>(t, out);
        return cudaGetLastError();
      });
  if (err != cudaSuccess) return (int)err;
  norm_kernel<<<1, kNormThreads, 0, s>>>(out, (int)chunks, (float*)norm);
  return (int)cudaGetLastError();
}

// x = x / norm * max_norm in place, unless *norm (a device f32) < max_norm.
int clip_scale_launch(const int64_t* ptrs, const int64_t* numel, int n,
                      const void* norm, float max_norm, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* nv = (const float*)norm;
  const int64_t* lists[1] = {ptrs};
  return (int)for_each_table<1>(
      lists, numel, n, [&](const Table<1>& t, int grid) {
        scale_kernel<<<grid, kThreads, 0, s>>>(t, nv, max_norm);
        return cudaGetLastError();
      });
}

// e = e * d + p * one_minus in place, e at `ema`, p at `params`, the two
// tensors of a pair laid out alike.
int ema_launch(const int64_t* ema, const int64_t* params,
               const int64_t* numel, int n, float d, float one_minus,
               void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t* lists[2] = {ema, params};
  return (int)for_each_table<2>(
      lists, numel, n, [&](const Table<2>& t, int grid) {
        ema_kernel<<<grid, kThreads, 0, s>>>(t, d, one_minus);
        return cudaGetLastError();
      });
}

}  // extern "C"
