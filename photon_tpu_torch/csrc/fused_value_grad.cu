// Fused GLM data term: sum_i wt_i * loss(x_i.w + off_i, y_i), its gradient
// X^T (wt * loss'(z, y)), and optionally the margins z, in one read of X.
//
// Replaces: photon_tpu/ops/pallas_glm.py::fused_data_value_and_grad (kernel
// body _kernel), the gradient pass of every fixed-effect L-BFGS iteration.
//
// Bound on the H100: bytes. Each row is read once (n*d elements of X plus
// four f32 vectors) for 4*n*d flops, far below the card's flop/byte ridge.
//
// Design: the TPU kernel carried its sums across a sequential grid. Here
// each CTA walks a fixed set of row tiles (tile t goes to CTA t % grid):
// it stages the tile in shared memory (16-byte loads where aligned), one
// warp per row forms z against w held in shared memory, then every thread
// adds X_tile^T dz into registers for the columns it owns. The tile is
// therefore read from device memory once and from shared memory twice.
// Each CTA writes one partial row [grad(d), loss]; reduce_parts sums the
// partials in a fixed order, so results are reproducible (no atomics).
// For bf16 X, w is rounded to bf16 before the dot (pallas_glm.py:328);
// every product and sum is f32.
#include "glm_common.h"

namespace pt {

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    value_grad_kernel(const T* __restrict__ X, const float* __restrict__ w,
                      const float* __restrict__ y, const float* __restrict__ off,
                      const float* __restrict__ wt, float* __restrict__ z_out,
                      float* __restrict__ parts, int n, int d, int tile_n, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  float* ws = reinterpret_cast<float*>(smem + align16((size_t)tile_n * d * sizeof(T)));
  float* dzs = ws + d;
  float* lvs = dzs + tile_n;

  for (int j = threadIdx.x; j < d; j += kThreads) ws[j] = round_like<T>(w[j]);

  float acc[kMaxColsPerThread];
#pragma unroll
  for (int k = 0; k < kMaxColsPerThread; ++k) acc[k] = 0.f;
  float loss_acc = 0.f;  // meaningful on thread 0 only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int num_tiles = (n + tile_n - 1) / tile_n;
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long r0 = (long)t * tile_n;
    const int rows = (int)min((long)tile_n, (long)n - r0);
    __syncthreads();  // the previous tile's readers are done
    stage(xs, X + r0 * d, (long)rows * d, vec != 0);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      const T* xr = xs + (long)r * d;
      float s = 0.f;
      for (int j = lane; j < d; j += 32) s = fmaf(to_f32(xr[j]), ws[j], s);
      s = warp_sum(s);
      if (lane == 0) {
        const long i = r0 + r;
        const float z = s + off[i];
        if (z_out != nullptr) z_out[i] = z;
        const float wi = wt[i], yi = y[i];
        lvs[r] = wi * loss_value<L>(z, yi);
        dzs[r] = wi * loss_dz<L>(z, yi);
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < rows; ++r) loss_acc += lvs[r];
    }
#pragma unroll
    for (int k = 0; k < kMaxColsPerThread; ++k) {
      const int j = threadIdx.x + k * kThreads;
      if (j < d) {
        float a = acc[k];
        for (int r = 0; r < rows; ++r) a = fmaf(to_f32(xs[(long)r * d + j]), dzs[r], a);
        acc[k] = a;
      }
    }
  }

  float* part = parts + (long)blockIdx.x * (d + 1);
#pragma unroll
  for (int k = 0; k < kMaxColsPerThread; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < d) part[j] = acc[k];
  }
  if (threadIdx.x == 0) part[d] = loss_acc;
}

template <typename T, int L>
cudaError_t launch(const void* X, const void* w, const void* y, const void* off, const void* wt,
                   void* z_out, void* parts, void* out, int n, int d, int tile_n, int grid,
                   int vec, cudaStream_t stream) {
  const size_t smem = align16((size_t)tile_n * d * sizeof(T)) + (size_t)(d + 2 * tile_n) * sizeof(float);
  auto kernel = value_grad_kernel<T, L>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(X), static_cast<const float*>(w), static_cast<const float*>(y),
      static_cast<const float*>(off), static_cast<const float*>(wt), static_cast<float*>(z_out),
      static_cast<float*>(parts), n, d, tile_n, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(static_cast<const float*>(parts), grid, d + 1, static_cast<float*>(out), stream);
}

template <typename T>
cudaError_t dispatch_loss(int loss, const void* X, const void* w, const void* y, const void* off,
                          const void* wt, void* z_out, void* parts, void* out, int n, int d,
                          int tile_n, int grid, int vec, cudaStream_t s) {
  switch (loss) {
    case kLogistic: return launch<T, kLogistic>(X, w, y, off, wt, z_out, parts, out, n, d, tile_n, grid, vec, s);
    case kSquared: return launch<T, kSquared>(X, w, y, off, wt, z_out, parts, out, n, d, tile_n, grid, vec, s);
    case kPoisson: return launch<T, kPoisson>(X, w, y, off, wt, z_out, parts, out, n, d, tile_n, grid, vec, s);
    case kSmoothedHinge: return launch<T, kSmoothedHinge>(X, w, y, off, wt, z_out, parts, out, n, d, tile_n, grid, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pt

// parts: (grid, d + 1) f32 scratch. out: (d + 1) f32 = [grad, loss].
// z_out may be null. Returns the cudaError_t of the launches.
extern "C" int pt_fused_value_grad(const void* X, int x_is_bf16, const void* w, const void* y,
                                   const void* off, const void* wt, void* z_out, void* parts,
                                   void* out, int n, int d, int tile_n, int grid, int loss,
                                   int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    return (int)pt::dispatch_loss<__nv_bfloat16>(loss, X, w, y, off, wt, z_out, parts, out, n, d,
                                                 tile_n, grid, vec, s);
  }
  return (int)pt::dispatch_loss<float>(loss, X, w, y, off, wt, z_out, parts, out, n, d, tile_n,
                                       grid, vec, s);
}
