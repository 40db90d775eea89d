// Fused GLM data-Hessian product X^T diag(d2) X v in one read of X.
//
// Replaces: photon_tpu/ops/pallas_glm.py::fused_data_hvp (kernel body
// _hvp_kernel), the product behind every TRON conjugate-gradient step.
//
// Bound on the H100: bytes (n*d elements of X and one f32 vector read for
// 4*n*d flops).
//
// Design: the same row-tile walk as fused_value_grad.cu. Each CTA stages a
// tile in shared memory, one warp per row forms u = x_r.v, t_r = d2_r u_r,
// and every thread adds X_tile^T t into registers for its columns. One
// partial (d) per CTA; reduce_parts sums the partials in a fixed order.
// v is rounded to X's dtype before the dot (pallas_glm.py:224); all
// arithmetic is f32.
#include "glm_common.h"

namespace pt {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hvp_kernel(const T* __restrict__ X, const float* __restrict__ v, const float* __restrict__ d2,
               float* __restrict__ parts, int n, int d, int tile_n, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* vs = reinterpret_cast<float*>(smem + align16((size_t)tile_n * d * sizeof(T)));
  float* ts = vs + d;

  for (int j = threadIdx.x; j < d; j += kThreads) vs[j] = round_like<T>(v[j]);

  float acc[kMaxColsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxColsPerThread; ++k) acc[k] = 0.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int num_tiles = (n + tile_n - 1) / tile_n;
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long r0 = (long)t * tile_n;
    const int rows = (int)min((long)tile_n, (long)n - r0);
    __syncthreads();
    stage(xs, X + r0 * d, (long)rows * d, vec != 0);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      const T* xr = xs + (long)r * d;
      float s = 0.f;
      for (int j = lane; j < d; j += 32) s = fmaf(to_f32(xr[j]), vs[j], s);
      s = warp_sum(s);
      if (lane == 0) ts[r] = d2[r0 + r] * s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxColsPerThread; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < d) {
        float a = acc[k];
        for (int r = 0; r < rows; ++r) a = fmaf(to_f32(xs[(long)r * d + j]), ts[r], a);
        acc[k] = a;
      }
    }
  }

  float* part = parts + (long)blockIdx.x * d;
#pragma unroll
  for (int k = 0; k < kMaxColsPerThread; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < d) part[j] = acc[k];
  }
}

template <typename T>
cudaError_t launch(const void* X, const void* v, const void* d2, void* parts, void* out, int n,
                   int d, int tile_n, int grid, int vec, cudaStream_t stream) {
  const size_t smem = align16((size_t)tile_n * d * sizeof(T)) + (size_t)(d + tile_n) * sizeof(float);
  auto kernel = hvp_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(X), static_cast<const float*>(v),
                                           static_cast<const float*>(d2),
                                           static_cast<float*>(parts), n, d, tile_n, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(static_cast<const float*>(parts), grid, d, static_cast<float*>(out), stream);
}

}  // namespace pt

// parts: (grid, d) f32 scratch. out: (d) f32.
extern "C" int pt_fused_hvp(const void* X, int x_is_bf16, const void* v, const void* d2,
                            void* parts, void* out, int n, int d, int tile_n, int grid, int vec,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return (int)pt::launch<__nv_bfloat16>(X, v, d2, parts, out, n, d, tile_n, grid, vec, s);
  }
  return (int)pt::launch<float>(X, v, d2, parts, out, n, d, tile_n, grid, vec, s);
}
