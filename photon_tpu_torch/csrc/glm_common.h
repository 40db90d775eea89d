// Shared device helpers for the port's GLM kernels (fused_value_grad.cu,
// fused_hvp.cu, newton_system.cu): element conversion, the four pointwise
// losses, tile staging into shared memory and the deterministic
// cross-block column reduction.
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

// out[j] = sum over c < num_parts of parts[c * width + j]. Each block takes 32
// columns; its 8 thread rows sum strided part subsets in a fixed order and
// thread row 0 adds the 8 subtotals in order, so the result is reproducible
// run to run (no atomics).
constexpr int kReduceRows = 8;

__global__ void __launch_bounds__(32 * kReduceRows)
    reduce_parts(const float* __restrict__ parts, int num_parts, int width, float* __restrict__ out) {
  __shared__ float sub[kReduceRows][32];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (j < width) {
    for (int c = threadIdx.y; c < num_parts; c += kReduceRows) acc += parts[(long)c * width + j];
  }
  sub[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kReduceRows; ++r) s += sub[r][threadIdx.x];
    out[j] = s;
  }
}

inline cudaError_t launch_reduce(const float* parts, int num_parts, int width, float* out,
                                 cudaStream_t stream) {
  dim3 block(32, kReduceRows);
  dim3 grid((width + 31) / 32);
  reduce_parts<<<grid, block, 0, stream>>>(parts, num_parts, width, out);
  return cudaGetLastError();
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace pt
