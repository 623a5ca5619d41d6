// K4: the targets of the train-step labeler. From the final match code of
// every (image, anchor) (>= 0 the matched ground-truth row, -1 background,
// -2 ignored): the class target (class - 1, -1 background, -2 ignored) and
// the Faster-RCNN box encoding (ty, tx, th, tw) of the matched row against
// the anchor, zeros where the anchor has no match.
//
// Replaces the Pallas TPU kernel `_targets_kernel` / `pallas_batch_targets`
// (ood_object_detection_tpu/ops/pallas_labeler.py:86-133, :201-246). The
// plain PyTorch version is `batch_targets_plain` in
// ood_object_detection_tpu_torch/ops/cuda_labeler.py, which also wraps this
// kernel (`batch_targets`).
//
// What bounds it on an H100: bytes. Each (image, anchor) reads a 4 B code
// and writes 4 B of class and 16 B of box; the anchors (16 B each) and the
// rows (20 B each) are read once and then hit in L2. A handful of
// operations an output.
//
// Design. One thread an (image, anchor): it reads its code, gathers the
// matched row and class directly (the TPU kernel's one-hot reduce over the
// rows only avoided slow TPU gathers, pallas_labeler.py:8-10) and writes
// the class and one 16-byte box store. The encoding follows
// box_coder.encode_boxes operation for operation: centres from the raw
// heights and widths, EPS added after the centres, IEEE division and logf
// (not __logf); this file is built with -fmad=false, so `y1 + 0.5 * h`
// rounds like the plain version's separate multiply and add.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;   // box_coder.EPS

__global__ void __launch_bounds__(kThreads)
targets_kernel(const float4* __restrict__ anchors, int num_anchors,
               const float4* __restrict__ gt, const int* __restrict__ gt_classes,
               const int* __restrict__ matches, int m, long long total,
               int* __restrict__ cls_out, float4* __restrict__ box_out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long b = i / num_anchors;
  const int a = (int)(i - b * num_anchors);
  const int code = matches[i];
  float4 out = make_float4(0.f, 0.f, 0.f, 0.f);
  int cls;
  if (code >= 0) {
    const float4 g = gt[b * m + code];
    cls = gt_classes[b * m + code] - 1;
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
  cls_out[i] = cls;
  box_out[i] = out;
}

}  // namespace

extern "C" {

// anchors [num_anchors, 4] f32 yxyx, gt [batch, m, 4] f32 yxyx, gt_classes
// [batch, m] i32, matches [batch, num_anchors] i32 codes (each < m), all
// contiguous. Writes cls_out [batch, num_anchors] i32 and box_out [batch,
// num_anchors, 4] f32. Returns cudaGetLastError() after the launch.
int targets_launch(const void* anchors, int num_anchors, const void* gt,
                   const void* gt_classes, const void* matches, int batch,
                   int m, void* cls_out, void* box_out, void* stream) {
  const long long total = (long long)batch * num_anchors;
  const long long blocks = (total + kThreads - 1) / kThreads;
  targets_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)anchors, num_anchors, (const float4*)gt,
      (const int*)gt_classes, (const int*)matches, m, total, (int*)cls_out,
      (float4*)box_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
