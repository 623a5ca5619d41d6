// K2: per-anchor packed (logit, class) key and energy over bf16 class logits,
// one pass over one pyramid level.
//
// Replaces the Pallas TPU kernel `_reduce_kernel` / `fused_key_ood_reduce`
// (ood_object_detection_tpu/ops/pallas_reduce.py:41-146), which computes
// the same function as the XLA-fused `_packed_f32_key_reduce`
// (ood_object_detection_tpu/ops/post_process.py:95-148). The plain PyTorch
// version is `key_energy_reduce_plain` in
// ood_object_detection_tpu_torch/ops/cuda_reduce.py, which also holds the
// wrapper.
//
// Per anchor, over its C class logits (bf16 bits `u`, class `c`):
//   mono = u >= 0x8000 ? 0xFFFF - u : u | 0x8000   (order-preserving u16)
//   key  = max_c(mono * 256 + (255 - c))           (exact in f32: < 2^24)
//   energy = m + log(sum_c exp(f_c - m)),  m = max_c f_c  (f32 logsumexp)
//
// What bounds it on an H100: bytes. Each logit is read once and used for
// about nine integer and float operations; at D0@512 an image has
// 8,838,720 B of logits against 392,832 B of output, so device memory
// (3.35 TB/s, 2.75 us an image) is the limit, about 5x above the f32 rate
// (67 TFLOP/s, 0.59 us). The design reads every logit once from device
// memory: one warp owns one anchor's C contiguous values (180 B at
// C = 90), its lanes stride over the classes so each load instruction of
// a warp covers 64 contiguous bytes, and the anchors of consecutive warps
// are contiguous. The energy loop reads the row a second time, from the
// L1 cache that the key loop has just filled. Keys and energies go
// straight to their slots of the [B, A_total] outputs (row stride
// A_total, level offset), so no concatenation follows. Not done yet:
// 16-byte vector loads and several anchors a warp, which would cut the
// instructions per byte; it runs at about a sixth of the memory bound.
//
// Exactness: the key is integer arithmetic, bit-equal to the plain
// version. The energy uses expf / logf (no --use_fast_math) and sums in a
// different order from the plain version, so it agrees to f32 round-off.

#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
key_energy_kernel(const uint16_t* __restrict__ logits, long long anchors,
                  int anchors_per_image, int num_classes, int a_total,
                  int offset, float* __restrict__ key_out,
                  float* __restrict__ energy_out) {
  const long long g =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= anchors) return;  // whole warps leave together
  const int lane = threadIdx.x & 31;
  const uint16_t* row = logits + g * num_classes;

  int key = INT_MIN;
  float m = -INFINITY;
  for (int c = lane; c < num_classes; c += 32) {
    const unsigned u = row[c];
    const int mono = u >= 0x8000u ? 0xFFFF - (int)u : (int)(u | 0x8000u);
    key = max(key, mono * 256 + (255 - c));
    m = fmaxf(m, __uint_as_float(u << 16));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    key = max(key, __shfl_xor_sync(0xffffffffu, key, off));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }

  const long long b = g / anchors_per_image;
  const long long out = b * a_total + offset + (g - b * anchors_per_image);
  if (energy_out != nullptr) {
    // logsumexp with a non-finite max replaced by 0 (as jax's logsumexp)
    const float shift = isfinite(m) ? m : 0.0f;
    float sum = 0.0f;
    for (int c = lane; c < num_classes; c += 32) {
      sum += expf(__uint_as_float((unsigned)row[c] << 16) - shift);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) energy_out[out] = logf(sum) + shift;
  }
  if (lane == 0) key_out[out] = (float)key;
}

}  // namespace

extern "C" {

// logits: one level's [B, H, W, A*C] bf16, contiguous (anchors = B*H*W*A
// rows of C values). Writes key_out / energy_out [B, a_total] f32 at
// columns [offset, offset + anchors_per_image); energy_out may be null.
// Returns cudaGetLastError() after the launch.
int key_energy_launch(const void* logits, long long anchors,
                      int anchors_per_image, int num_classes, int a_total,
                      int offset, void* key_out, void* energy_out,
                      void* stream) {
  const long long blocks = (anchors + kWarpsPerBlock - 1) / kWarpsPerBlock;
  key_energy_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)logits, anchors, anchors_per_image, num_classes,
      a_total, offset, (float*)key_out, (float*)energy_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
