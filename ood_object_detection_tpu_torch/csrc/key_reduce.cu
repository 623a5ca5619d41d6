// K2: per-anchor packed (logit, class) key and energy over bf16 class logits,
// all pyramid levels in one persistent launch fed by bulk asynchronous copies.
//
// Replaces the Pallas TPU kernel `_reduce_kernel` / `_level_reduce` /
// `fused_key_ood_reduce` (ood_object_detection_tpu/ops/pallas_reduce.py:
// 41-146), which computes the same function as the XLA-fused
// `_packed_f32_key_reduce` (ood_object_detection_tpu/ops/post_process.py:
// 95-148). The plain PyTorch version is `key_energy_reduce_plain` in
// ood_object_detection_tpu_torch/ops/cuda_reduce.py, which also holds the
// wrapper and the tile plan (`tile_plan`).
//
// Per anchor, over its C class logits (bf16 bits `u`, class `c`):
//   mono = u >= 0x8000 ? 0xFFFF - u : u | 0x8000   (order-preserving u16)
//   key  = max_c(mono * 256 + (255 - c))           (exact in f32: < 2^24)
//   energy = m + log(sum_c exp(f_c - m)),  m = max_c f_c  (f32 logsumexp)
//
// What bounds it on an H100: bytes. Each logit is read once and used for
// about ten integer and float operations and one exp; at D0@512 an image
// has 8,838,720 B of logits against 392,832 B of output, so device memory
// (3.35 TB/s, 2.75 us an image) is the limit, far beyond the 50 MB L2 at
// any serving batch. The issue is close behind: the first design (one warp
// an anchor, 2-byte loads, a launch a level) reached 15-17 % of the bytes
// bound, and a design with 8 lanes an anchor, shuffles to combine them and
// a separate pass for the key's tie rule about 50 %.
//
// The design streams the logits through shared memory at the memory rate
// and spends as few instructions a logit as it can:
//  - One launch for all levels. The wrapper passes a by-value table of up to
//    8 level descriptors (pointer, anchor rows B*H*W*A, rows per image,
//    column offset into [B, A_total], first tile). Each level's rows of
//    2*C bytes are cut into tiles of 32 rows (5,760 B at C = 90), so every
//    tile starts 16-byte aligned. A persistent grid of blocks walks the
//    tiles of all levels, each warp its own share.
//  - Each warp keeps its own ring of kDepth stages in shared memory, filled
//    by 1-D bulk copies (`cp.async.bulk ... mbarrier::complete_tx::bytes`,
//    the copy engine of TMA without a tensor map), one mbarrier a stage:
//    lane 0 issues the copy of the warp's tile i + kDepth as soon as the
//    warp has reduced tile i, so kDepth - 1 tiles a warp are in flight while
//    it reduces one, and no warp waits on another. (These bulk copies are
//    what was measured; `cp.async` with 16-byte vectors was not tried.)
//    The last tile of a level
//    whose size is not a multiple of 16 bytes is not copied: the warp reads
//    it from device memory with plain loads, never past the tensor.
//  - One lane an anchor. At even C a lane reads its row's bf16 pairs as
//    32-bit words (45 words at C = 90, an odd stride, so the 32 rows of a
//    warp fall in 32 different banks). Pass 1 builds the packed key of both
//    halves of each word and keeps the maximum, so the key's tie rule (the
//    lowest class) comes with it; its mono16 decodes to the maximum logit
//    m. Pass 2, over the same shared memory, sums exp(f - m) for the
//    energy. No shuffles; 32 consecutive keys and energies a warp are
//    stored straight into their [B, A_total] slots. C is a run-time bound
//    (C = 90 as a compile-time constant was measured no faster); an odd C
//    takes 16-bit reads. `energy_out == nullptr` skips pass 2.
//
// Exactness: the key is integer arithmetic, bit-equal to the plain
// version. The energy takes exp(f - m) as ex2.approx.ftz of (f - m) *
// log2(e) (f - m is exact for bf16 f and m; each term is off by a few ulp,
// and a term below 2^-126 of the largest, which is 1, is flushed to 0) and
// logf, and sums in another order than the plain version: it agrees to
// about 1e-6, inside the rtol 1e-5 / atol 1e-5 it is held to.

#include <cuda_runtime.h>
#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTileRows = 32;  // one row a lane
constexpr int kDepth = 2;      // stages a warp: one reduced, one in flight
constexpr int kMaxWarps = 8;   // warps a block
constexpr int kBlocksPerSM = 2;
// shared memory of an sm_90 SM, and what each resident block reserves
constexpr int kSMSmem = 233472;
constexpr int kBlockReservedSmem = 1024;

struct Levels {
  const unsigned char* ptr[kMaxLevels];
  long long rows[kMaxLevels];      // B*H*W*A rows of 2*C bytes
  int rows_per_image[kMaxLevels];  // H*W*A
  int col_offset[kMaxLevels];      // first column in [B, A_total]
  int first_tile[kMaxLevels + 1];  // prefix sums of the tile counts
  int n;
};

struct Tile {
  const unsigned char* src;  // first byte in device memory
  int level;
  int row0;  // first row within the level
  int rows;
  int bytes;
  bool bulk;  // a multiple of 16 bytes: copied to shared memory
};

__device__ __forceinline__ Tile locate(const Levels& L, int t, int row_bytes) {
  int l = 0;
  while (l + 1 < L.n && t >= L.first_tile[l + 1]) ++l;
  Tile tile;
  tile.level = l;
  tile.row0 = (t - L.first_tile[l]) * kTileRows;
  const long long left = L.rows[l] - tile.row0;
  tile.rows = left < kTileRows ? (int)left : kTileRows;
  tile.bytes = tile.rows * row_bytes;
  tile.bulk = (tile.bytes & 15) == 0;
  tile.src = L.ptr[l] + (long long)tile.row0 * row_bytes;
  return tile;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait of over 2^36 clocks (tens of seconds) can only be a fault: trap, so
// that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The order-preserving mono16 of both bf16 halves of a word: xor 0xFFFF
// where the sign bit is set, 0x8000 where it is not.
__device__ __forceinline__ uint32_t mono2(uint32_t x) {
  return x ^ ((((x & 0x80008000u) >> 15) * 0x7FFFu) | 0x80008000u);
}

// The larger packed key of word w's two classes 2w (low half) and 2w + 1.
__device__ __forceinline__ uint32_t word_key(uint32_t x, int w) {
  const uint32_t m2 = mono2(x);
  const uint32_t k0 = ((m2 << 8) & 0xFFFF00u) | (uint32_t)(255 - 2 * w);
  const uint32_t k1 = ((m2 >> 8) & 0xFFFF00u) | (uint32_t)(254 - 2 * w);
  return max(k0, k1);
}

// 2^x, flushing a result below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// exp(f - shift) for the bf16 f whose bits are the high half of `bits`
__device__ __forceinline__ float exp_shifted(uint32_t bits, float shift) {
  return ex2((__uint_as_float(bits) - shift) * 1.4426950408889634f);
}

// Key (and energy) of the `rows` rows of C logits starting at `base`
// (shared or device memory), row `lane` on this lane; an odd C (kEven
// false) is read 16 bits at a time.
template <bool kEnergy, bool kEven>
__device__ __forceinline__ void reduce_rows(const unsigned char* base,
                                            int C, int row_bytes,
                                            const Tile& tile, const Levels& L,
                                            int a_total,
                                            float* __restrict__ key_out,
                                            float* __restrict__ energy_out) {
  const int lane = threadIdx.x & 31;
  if (lane >= tile.rows) return;
  const unsigned char* row = base + lane * row_bytes;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(row);
  const uint16_t* h16 = reinterpret_cast<const uint16_t*>(row);
  const int words = C / 2;

  // 1. the packed key; its mono16 is the maximum logit's
  uint32_t key = 0u;
  if (kEven) {
#pragma unroll
    for (int w = 0; w < words; ++w) key = max(key, word_key(w32[w], w));
  } else {
    for (int c = 0; c < C; ++c) {
      const uint32_t u = h16[c];
      const uint32_t mono = u ^ (u >= 0x8000u ? 0xFFFFu : 0x8000u);
      key = max(key, (mono << 8) | (uint32_t)(255 - c));
    }
  }

  // 2. sum_c exp(f_c - m), with a non-finite max m replaced by 0 (as jax's
  //    logsumexp)
  float energy = 0.0f;
  if (kEnergy) {
    const uint32_t mono = key >> 8;
    const uint32_t umax = mono >= 0x8000u ? mono & 0x7FFFu : 0xFFFFu - mono;
    const float m = __uint_as_float(umax << 16);
    const float shift = isfinite(m) ? m : 0.0f;
    float s0 = 0.0f, s1 = 0.0f;
    if (kEven) {
#pragma unroll
      for (int w = 0; w < words; ++w) {
        const uint32_t x = w32[w];
        s0 += exp_shifted(x << 16, shift);
        s1 += exp_shifted(x & 0xFFFF0000u, shift);
      }
    } else {
      for (int c = 0; c < C; ++c) s0 += exp_shifted((uint32_t)h16[c] << 16,
                                                    shift);
    }
    energy = logf(s0 + s1) + shift;
  }

  const unsigned g = (unsigned)(tile.row0 + lane);
  const unsigned rpi = (unsigned)L.rows_per_image[tile.level];
  const unsigned b = g / rpi;
  const long long out = (long long)b * a_total + L.col_offset[tile.level] +
                        (g - b * rpi);
  key_out[out] = (float)key;
  if (kEnergy) energy_out[out] = energy;
}

template <bool kEnergy, bool kEven>
__global__ void __launch_bounds__(kMaxWarps * 32)
key_energy_kernel(const __grid_constant__ Levels L, int num_classes,
                  int a_total, float* __restrict__ key_out,
                  float* __restrict__ energy_out) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kMaxWarps * kDepth];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int row_bytes = 2 * num_classes;
  const int stage_bytes = kTileRows * row_bytes;
  unsigned char* stages = ring + warp * kDepth * stage_bytes;
  uint64_t* bars = full + warp * kDepth;
  if (lane == 0) {
    for (int s = 0; s < kDepth; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // this warp's tiles: first + i * stride, i = 0, 1, ...
  const int total = L.first_tile[L.n];
  const int first = blockIdx.x * warps + warp;
  const int stride = gridDim.x * warps;
  auto issue = [&](int i) {
    const int t = first + i * stride;
    if (t >= total) return;
    const int s = i % kDepth;
    const Tile tile = locate(L, t, row_bytes);
    if (tile.bulk) {
      mbar_arrive_tx(&bars[s], (unsigned)tile.bytes);
      bulk_copy(stages + s * stage_bytes, tile.src, (unsigned)tile.bytes,
                &bars[s]);
    } else {
      mbar_arrive(&bars[s]);  // ragged: the warp reads it in place
    }
  };
  if (lane == 0) {
    for (int i = 0; i < kDepth; ++i) issue(i);
  }
  for (int i = 0; first + i * stride < total; ++i) {
    const int s = i % kDepth;
    mbar_wait(&bars[s], (i / kDepth) & 1);
    const Tile tile = locate(L, first + i * stride, row_bytes);
    if (tile.bulk) {
      reduce_rows<kEnergy, kEven>(stages + s * stage_bytes, num_classes,
                               row_bytes, tile, L, a_total, key_out,
                               energy_out);
    } else {
      reduce_rows<kEnergy, kEven>(tile.src, num_classes, row_bytes, tile, L,
                               a_total, key_out, energy_out);
    }
    // the stage is free once every lane has read it: order those reads
    // before the next bulk copy writes it
    __syncwarp();
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + kDepth);
    }
  }
}

// The persistent grid: kBlocksPerSM blocks an SM, each of as many warps
// (up to kMaxWarps) as their rings' shared memory allows, and no more warps
// than tiles.
template <bool kEnergy, bool kEven>
cudaError_t launch(const Levels& L, int num_classes, int sms, int a_total,
                   float* key_out, float* energy_out, cudaStream_t stream) {
  const int stage_bytes = kTileRows * 2 * num_classes;
  const int per_block = kSMSmem / kBlocksPerSM - kBlockReservedSmem;
  const int warps =
      std::max(1, std::min(kMaxWarps, per_block / (kDepth * stage_bytes)));
  const int tiles = L.first_tile[L.n];
  const int grid = std::min(sms * kBlocksPerSM, (tiles + warps - 1) / warps);
  const int smem = warps * kDepth * stage_bytes;
  auto kernel = key_energy_kernel<kEnergy, kEven>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, warps * 32, smem, stream>>>(L, num_classes, a_total,
                                             key_out, energy_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// n_levels <= 8 levels, level l: ptrs[l] its [B, H, W, A*C] bf16 logits,
// contiguous and 16-byte aligned, rows[l] = B*H*W*A (< 2^31), rows of
// rows_per_image[l] an image written to columns col_offset[l] + j of the
// [B, a_total] f32 outputs; first_tile has n_levels + 1 prefix sums of the
// tile counts (ceil(rows / tile_rows), tile_rows 32, at least one tile),
// walked by a persistent grid on the `sms` SMs of the card. energy_out may
// be null (keys only). Returns cudaGetLastError() after the launch.
int key_energy_launch(const void* const* ptrs, const long long* rows,
                      const int* rows_per_image, const int* col_offset,
                      const int* first_tile, int n_levels, int num_classes,
                      int tile_rows, int sms, int a_total, void* key_out,
                      void* energy_out, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || tile_rows != kTileRows ||
      sms < 1 || first_tile[n_levels] < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Levels L = {};
  L.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    L.ptr[l] = (const unsigned char*)ptrs[l];
    L.rows[l] = rows[l];
    L.rows_per_image[l] = rows_per_image[l];
    L.col_offset[l] = col_offset[l];
    L.first_tile[l] = first_tile[l];
  }
  L.first_tile[n_levels] = first_tile[n_levels];
  float* k = (float*)key_out;
  float* e = (float*)energy_out;
  cudaStream_t s = (cudaStream_t)stream;
  const int C = num_classes;
#define KEY_ENERGY(EVEN)                                             \
  (e != nullptr ? launch<true, EVEN>(L, C, sms, a_total, k, e, s)    \
                : launch<false, EVEN>(L, C, sms, a_total, k, e, s))
  const cudaError_t err = C % 2 == 0 ? KEY_ENERGY(true) : KEY_ENERGY(false);
#undef KEY_ENERGY
  return (int)err;
}

}  // extern "C"
