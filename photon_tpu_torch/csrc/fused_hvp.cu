// Fused GLM data-Hessian product X^T diag(d2) X v in one read of X.
//
// Replaces: photon_tpu/ops/pallas_glm.py::fused_data_hvp (kernel body
// _hvp_kernel), the product behind every TRON conjugate-gradient step.
//
// Bound on the H100: bytes (n*d elements of X and one f32 vector read for
// 4*n*d flops). v is rounded to X's dtype before the dot
// (pallas_glm.py:224); every product and sum is f32.
//
// Two routes, chosen by shape in ops/fused_glm.py (the same shapes as
// fused_value_grad.cu):
//
// "row" (rows of a multiple of 16 bytes, d <= 1024): the bulk-copy ring and
// register row loop of row_ring.h, with HvpOp below as its per-row
// operation: u = x.round(v) by the butterfly, t = d2_i * u, and every lane
// adds x*t into its own accumulators from the row it already holds. A
// slot's partial is d wide; the same two-level tree sums the partials.
//
// "tile" (any other d <= 4096): the staged-tile kernel. Each CTA stages a tile in
// shared memory, one warp per row forms u = x_r.v, t_r = d2_r u_r, and every
// thread adds X_tile^T t into registers for its columns. One partial (d) per
// CTA; reduce_parts sums the partials in a fixed order.
//
// Both routes give results that are bitwise reproducible (no atomics).
#include "row_ring.h"

namespace pt {

// ---------------------------------------------------------------- row route

// Lane k holds d2 of the warp's k-th row; a row's coefficient is d2 * u.
struct HvpOp {
  static constexpr int kExtra = 0;
  struct Side {
    float d2;
  };
  const float* d2;

  __device__ __forceinline__ Side load(long i) const { return {d2[i]}; }

  __device__ __forceinline__ float coef(float s, const Side& mine, int k, int, float&) const {
    return __shfl_sync(0xffffffffu, mine.d2, k) * s;
  }

  __device__ __forceinline__ float end_rows(const Side&, float, int, int, long) const {
    return 0.f;
  }
};

// --------------------------------------------------------------- tile route

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
cudaError_t launch_tile(const void* X, const float* v, const float* d2, float* parts, float* out,
                        int n, int d, int tile_n, int grid, int vec, cudaStream_t stream) {
  const size_t smem = align16((size_t)tile_n * d * sizeof(T)) + (size_t)(d + tile_n) * sizeof(float);
  auto kernel = hvp_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(X), v, d2, parts, n, d, tile_n,
                                           vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(parts, grid, d, out, stream);
}

template <typename T>
cudaError_t dispatch_route(int route, const RowLaunch& a, const float* d2, int vec,
                           cudaStream_t s) {
  if (route == 1) return dispatch_row<T>(a, HvpOp{d2}, s);
  return launch_tile<T>(a.X, a.vec, d2, a.parts, a.out, a.n, a.d, a.tile_n, a.grid, vec, s);
}

}  // namespace pt

// route 0 (tile): parts is (grid, d) f32 scratch; tiles_per_slot and stages
// are unused. route 1 (row): parts is (slots + ceil(slots / 64), d) f32
// scratch, slots = ceil(ceil(n / tile_n) / tiles_per_slot); vec is unused.
// out: (d) f32. Returns the cudaError_t of the launches.
extern "C" int pt_fused_hvp(const void* X, int x_is_bf16, const void* v, const void* d2,
                            void* parts, void* out, int n, int d, int route, int tile_n, int grid,
                            int tiles_per_slot, int stages, int vec, void* stream) {
  const pt::RowLaunch a{X, static_cast<const float*>(v), static_cast<float*>(parts),
                        static_cast<float*>(out), n, d, tile_n, grid, tiles_per_slot, stages,
                        nullptr};
  const float* d2f = static_cast<const float*>(d2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return (int)pt::dispatch_route<__nv_bfloat16>(route, a, d2f, vec, s);
  return (int)pt::dispatch_route<float>(route, a, d2f, vec, s);
}

// Resident CTAs per SM of the row route's kernel at this shape, into
// *ctas_per_sm. Launches nothing.
extern "C" int pt_fused_hvp_occupancy(int x_is_bf16, int d, int tile_n, int stages,
                                      int* ctas_per_sm) {
  const pt::RowLaunch a{nullptr, nullptr, nullptr, nullptr, 0, d, tile_n, 0, 1, stages,
                        ctas_per_sm};
  if (x_is_bf16) return (int)pt::dispatch_row<__nv_bfloat16>(a, pt::HvpOp{nullptr}, nullptr);
  return (int)pt::dispatch_row<float>(a, pt::HvpOp{nullptr}, nullptr);
}
