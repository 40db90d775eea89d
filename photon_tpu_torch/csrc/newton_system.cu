// Batched per-entity Newton system: for each entity e,
//   H_e = X_e^T diag(d2_e) X_e   (d x d)   and   g_e = X_e^T dz_e   (d),
// from one read of the entity's (n_max, d) slab.
//
// Replaces: photon_tpu/ops/pallas_newton.py::fused_newton_system (kernel
// bodies _system_kernel and _system_kernel_tiled, vmapped over entities),
// run once per random-effect Newton iteration.
//
// Bound on the H100: bytes. Each slab element is read once; the work is
// 2*d*d + 2*d flops per row, which at d <= 64 stays below the ridge.
//
// Design: one CTA per entity (vmap's batch axis becomes the grid). The slab
// streams through shared memory in chunks of kChunk rows, upcast to f32 as it
// lands; each thread owns up to kMaxEntries entries of H (and threads
// tid < d one entry of g) and keeps them in registers for the whole slab,
// so H and g are written to device memory once. d2 * (x_a * x_b) is the same
// number for (a, b) and (b, a), so H comes out exactly symmetric. The limit
// is d <= kMaxDim = 64 (d*d entries over 256 threads), matching the random
// effect solver's intended range (photon_tpu/optim/newton.py:9).
#include "glm_common.h"

namespace pt {

constexpr int kMaxDim = 64;
constexpr int kMaxEntries = kMaxDim * kMaxDim / kThreads;  // 16
constexpr int kChunk = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    newton_system_kernel(const T* __restrict__ X, const float* __restrict__ d2,
                         const float* __restrict__ dz, float* __restrict__ H,
                         float* __restrict__ g, int n_max, int d) {
  extern __shared__ __align__(16) float sm[];
  float* xs = sm;                   // kChunk * d
  float* d2s = xs + kChunk * d;     // kChunk
  float* dzs = d2s + kChunk;        // kChunk

  const long e = blockIdx.x;
  const T* Xe = X + e * (long)n_max * d;
  const float* d2e = d2 + e * (long)n_max;
  const float* dze = dz + e * (long)n_max;
  const int dd = d * d;

  float hacc[kMaxEntries];
#pragma unroll
  for (int k = 0; k < kMaxEntries; ++k) hacc[k] = 0.f;
  float gacc = 0.f;

  for (int r0 = 0; r0 < n_max; r0 += kChunk) {
    const int rows = min(kChunk, n_max - r0);
    __syncthreads();
    const T* src = Xe + (long)r0 * d;
    for (int i = threadIdx.x; i < rows * d; i += kThreads) xs[i] = to_f32(src[i]);
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      d2s[i] = d2e[r0 + i];
      dzs[i] = dze[r0 + i];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxEntries; ++k) {
      const int idx = threadIdx.x + k * kThreads;
      if (idx < dd) {
        const int a = idx / d, b = idx - a * d;
        float h = hacc[k];
        for (int r = 0; r < rows; ++r) h = fmaf(d2s[r], xs[r * d + a] * xs[r * d + b], h);
        hacc[k] = h;
      }
    }
    if (threadIdx.x < d) {
      for (int r = 0; r < rows; ++r) gacc = fmaf(xs[r * d + threadIdx.x], dzs[r], gacc);
    }
  }

  float* He = H + e * (long)dd;
#pragma unroll
  for (int k = 0; k < kMaxEntries; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    if (idx < dd) He[idx] = hacc[k];
  }
  if (threadIdx.x < d) g[e * (long)d + threadIdx.x] = gacc;
}

template <typename T>
cudaError_t launch(const void* X, const void* d2, const void* dz, void* H, void* g, int E,
                   int n_max, int d, cudaStream_t stream) {
  if (d < 1 || d > kMaxDim) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(kChunk * d + 2 * kChunk) * sizeof(float);
  auto kernel = newton_system_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<E, kThreads, smem, stream>>>(static_cast<const T*>(X), static_cast<const float*>(d2),
                                        static_cast<const float*>(dz), static_cast<float*>(H),
                                        static_cast<float*>(g), n_max, d);
  return cudaGetLastError();
}

}  // namespace pt

// X: (E, n_max, d) f32 or bf16; d2, dz: (E, n_max) f32; H: (E, d, d); g: (E, d).
extern "C" int pt_newton_system(const void* X, int x_is_bf16, const void* d2, const void* dz,
                                void* H, void* g, int E, int n_max, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return (int)pt::launch<__nv_bfloat16>(X, d2, dz, H, g, E, n_max, d, s);
  return (int)pt::launch<float>(X, d2, dz, H, g, E, n_max, d, s);
}
