// Shared device helpers for the port's GLM kernels (fused_value_grad.cu,
// fused_hvp.cu, newton_system.cu): element conversion, the four pointwise
// losses, tile staging into shared memory, the deterministic cross-block
// column reduction (one level or a fixed two-level tree), and the sm_90
// mbarrier and 1-D bulk-copy wrappers of an async tile ring.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Each thread owns columns j = tid + k * kThreads, k < kMaxColsPerThread, so
// the fused row-tile kernels take d <= kThreads * kMaxColsPerThread = 4096.
constexpr int kMaxColsPerThread = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Round an f32 vector entry to X's element type (the Pallas wrappers cast the
// coefficient vector to X's dtype before the margin dot).
template <typename T>
__device__ __forceinline__ float round_like(float x);
template <>
__device__ __forceinline__ float round_like<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Loss ids match photon_tpu_torch.ops.losses.PointwiseLoss.kernel_id.
enum LossId { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

template <int L>
__device__ __forceinline__ float loss_value(float z, float y) {
  if (L == kLogistic) {
    // softplus(z) - y z, in the overflow-free form.
    return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))) - y * z;
  } else if (L == kSquared) {
    float r = z - y;
    return 0.5f * r * r;
  } else if (L == kPoisson) {
    return expf(z) - y * z;
  } else {
    float t = (y > 0.f ? 1.f : -1.f) * z;
    if (t <= 0.f) return 0.5f - t;
    if (t < 1.f) return 0.5f * (1.f - t) * (1.f - t);
    return 0.f;
  }
}

template <int L>
__device__ __forceinline__ float loss_dz(float z, float y) {
  if (L == kLogistic) {
    return 1.f / (1.f + expf(-z)) - y;
  } else if (L == kSquared) {
    return z - y;
  } else if (L == kPoisson) {
    return expf(z) - y;
  } else {
    float s = y > 0.f ? 1.f : -1.f;
    float t = s * z;
    float dt = t <= 0.f ? -1.f : (t < 1.f ? t - 1.f : 0.f);
    return s * dt;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  // Fixed butterfly order: the same inputs always give the same sum.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// Copy `count` contiguous elements from global to shared memory, as 16-byte
// vectors when `vec` (source 16-byte aligned) and element-wise otherwise.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, long count, bool vec) {
  long head = 0;
  if (vec) {
    constexpr int per = 16 / sizeof(T);
    const long nv = count / per;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (long i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
    head = nv * per;
  }
  for (long i = head + threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

// out[g * width + j] = sum over the parts c of group g (c in [g * group,
// min(num_parts, (g + 1) * group))) of parts[c * width + j]; blockIdx.y is
// the group. Each block takes 32 columns; its 8 thread rows sum strided part
// subsets in a fixed order and thread row 0 adds the 8 subtotals in order, so
// the result is reproducible run to run (no atomics). A launch whose
// `enable` flag (device memory, may be null) is 0 writes nothing.
constexpr int kReduceRows = 8;

// The launch flag of K1 and K2: null, or a device int that a launch reads
// first and returns at once on when it is 0 (a masked step of a captured
// solve, optim/program.py). Uniform over the grid, so no barrier is split.
__device__ __forceinline__ bool launch_disabled(const int* enable) {
  return enable != nullptr && __ldg(enable) == 0;
}

__global__ void __launch_bounds__(32 * kReduceRows)
    reduce_parts(const float* __restrict__ parts, int num_parts, int width, int group,
                 float* __restrict__ out, const int* __restrict__ enable) {
  if (launch_disabled(enable)) return;
  __shared__ float sub[kReduceRows][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int c0 = blockIdx.y * group, c1 = min(num_parts, c0 + group);
  float acc = 0.f;
  if (j < width) {
    for (int c = c0 + threadIdx.y; c < c1; c += kReduceRows) acc += parts[(long)c * width + j];
  }
  sub[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kReduceRows; ++r) s += sub[r][threadIdx.x];
    out[(long)blockIdx.y * width + j] = s;
  }
}

// out[j] = sum over all num_parts rows of parts, in one group.
inline cudaError_t launch_reduce(const float* parts, int num_parts, int width, float* out,
                                 cudaStream_t stream, const int* enable = nullptr) {
  dim3 block(32, kReduceRows);
  dim3 grid((width + 31) / 32);
  reduce_parts<<<grid, block, 0, stream>>>(parts, num_parts, width, num_parts, out, enable);
  return cudaGetLastError();
}

// The same sum as a fixed two-level tree, for thousands of parts: groups of
// kTreeGroup consecutive parts into `mid` (ceil(num_parts / kTreeGroup) rows
// of width), then the group sums into out. The tree depends only on
// num_parts, so the result does too.
constexpr int kTreeGroup = 64;

inline int tree_groups(int num_parts) { return (num_parts + kTreeGroup - 1) / kTreeGroup; }

inline cudaError_t launch_reduce_tree(const float* parts, int num_parts, int width, float* mid,
                                      float* out, cudaStream_t stream,
                                      const int* enable = nullptr) {
  const int groups = tree_groups(num_parts);
  if (groups == 1) return launch_reduce(parts, num_parts, width, out, stream, enable);
  dim3 block(32, kReduceRows);
  dim3 grid((width + 31) / 32, groups);
  reduce_parts<<<grid, block, 0, stream>>>(parts, num_parts, width, kTreeGroup, mid, enable);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(mid, groups, width, out, stream, enable);
}

// ---- mbarriers and the 1-D bulk copy (TMA without a tensor map), sm_90 ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (copy) proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// One arrival that also adds `bytes` to the phase's expected transaction count.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Blocks until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Copies `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Barrier over the first `threads` threads of the block (a multiple of 32),
// leaving the others free to run on.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace pt
