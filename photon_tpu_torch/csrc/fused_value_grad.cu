// Fused GLM data term: sum_i wt_i * loss(x_i.w + off_i, y_i), its gradient
// X^T (wt * loss'(z, y)), and optionally the margins z, in one read of X.
//
// Replaces: photon_tpu/ops/pallas_glm.py::fused_data_value_and_grad (kernel
// body _kernel), the gradient pass of every fixed-effect L-BFGS iteration.
//
// Bound on the H100: bytes. Each row is read once (n*d elements of X plus
// four f32 vectors) for 4*n*d flops, far below the card's flop/byte ridge.
// For bf16 X, w is rounded to bf16 before the dot (pallas_glm.py:328);
// every product and sum is f32.
//
// Two routes, chosen by shape in ops/fused_glm.py:
//
// "row" (rows of a multiple of 16 bytes, d <= 1024): the bulk-copy ring and
// register row loop of row_ring.h, with ValueGradOp below as its per-row
// operation. Every lane computes dz itself and adds x*dz into its own
// accumulators; lane k evaluates the loss of the warp's k-th row and writes
// its margin. A slot's partial is [grad(d), loss].
//
// "tile" (any other d <= 4096): PR 1's kernel. Each CTA walks a fixed set of
// row tiles (tile t goes to CTA t % grid of a grid fixed by shape), stages
// the tile in shared memory, one warp per row forms z, then every thread
// adds X_tile^T dz into registers for the columns it owns; one partial per
// CTA, summed in a fixed order (reduce_parts).
//
// Both routes give results that are bitwise reproducible (no atomics).
#include "row_ring.h"

namespace pt {

// ---------------------------------------------------------------- row route

// The per-row operation of the row route (row_ring.h): z = x.w + off, the
// row's coefficient is dz = wt * loss'(z, y), and the extra value of a
// partial is the weighted loss. Lane k holds (y, off, wt) of its row, keeps
// that row's z and, after the tile, adds its loss and writes its margin.
template <int L>
struct ValueGradOp {
  static constexpr int kExtra = 1;
  struct Side {
    float y, off, wt;
  };
  const float *y, *off, *wt;
  float* z_out;  // may be null

  __device__ __forceinline__ Side load(long i) const { return {y[i], off[i], wt[i]}; }

  __device__ __forceinline__ float coef(float s, const Side& mine, int k, int lane,
                                        float& own) const {
    const float zi = s + __shfl_sync(0xffffffffu, mine.off, k);
    const float yi = __shfl_sync(0xffffffffu, mine.y, k);
    const float wi = __shfl_sync(0xffffffffu, mine.wt, k);
    if (lane == k) own = zi;
    return wi * loss_dz<L>(zi, yi);
  }

  __device__ __forceinline__ float end_rows(const Side& mine, float own, int lane, int rows,
                                            long first_row) const {
    if (lane >= rows) return 0.f;
    if (z_out != nullptr) z_out[first_row + lane] = own;
    return mine.wt * loss_value<L>(own, mine.y);
  }
};

// --------------------------------------------------------------- tile route

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    tile_value_grad_kernel(const T* __restrict__ X, const float* __restrict__ w,
                           const float* __restrict__ y, const float* __restrict__ off,
                           const float* __restrict__ wt, float* __restrict__ z_out,
                           float* __restrict__ parts, int n, int d, int tile_n, int vec,
                           const int* __restrict__ enable) {
  if (launch_disabled(enable)) return;
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

// Launch arguments, one struct for both routes (pointers are device memory).
struct Args {
  const void *X, *w, *y, *off, *wt;
  void *z_out, *parts, *out;
  int n, d, tile_n, grid, tiles_per_slot, stages, vec;
  int* ctas_per_sm;  // if set, the row route reports its occupancy instead of launching
  const int* enable;  // launch flag (glm_common.h launch_disabled), may be null
};

template <typename T, int L>
cudaError_t launch_row(const Args& a, cudaStream_t s) {
  const RowLaunch r{a.X,    static_cast<const float*>(a.w), static_cast<float*>(a.parts),
                    static_cast<float*>(a.out), a.n, a.d, a.tile_n, a.grid, a.tiles_per_slot,
                    a.stages, a.ctas_per_sm, a.enable};
  const ValueGradOp<L> op{static_cast<const float*>(a.y), static_cast<const float*>(a.off),
                          static_cast<const float*>(a.wt), static_cast<float*>(a.z_out)};
  return dispatch_row<T>(r, op, s);
}

template <typename T, int L>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  const size_t smem =
      align16((size_t)a.tile_n * a.d * sizeof(T)) + (size_t)(a.d + 2 * a.tile_n) * sizeof(float);
  auto kernel = tile_value_grad_kernel<T, L>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.X), static_cast<const float*>(a.w), static_cast<const float*>(a.y),
      static_cast<const float*>(a.off), static_cast<const float*>(a.wt),
      static_cast<float*>(a.z_out), static_cast<float*>(a.parts), a.n, a.d, a.tile_n, a.vec,
      a.enable);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(static_cast<const float*>(a.parts), a.grid, a.d + 1,
                       static_cast<float*>(a.out), stream, a.enable);
}

template <typename T, int L>
cudaError_t dispatch_route(int route, const Args& a, cudaStream_t s) {
  return route == 1 ? launch_row<T, L>(a, s) : launch_tile<T, L>(a, s);
}

template <typename T>
cudaError_t dispatch_loss(int loss, int route, const Args& a, cudaStream_t s) {
  switch (loss) {
    case kLogistic: return dispatch_route<T, kLogistic>(route, a, s);
    case kSquared: return dispatch_route<T, kSquared>(route, a, s);
    case kPoisson: return dispatch_route<T, kPoisson>(route, a, s);
    case kSmoothedHinge: return dispatch_route<T, kSmoothedHinge>(route, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace pt

// route 0 (tile): parts is (grid, d + 1) f32 scratch; tiles_per_slot and
// stages are unused. route 1 (row): parts is (slots + ceil(slots / 64),
// d + 1) f32 scratch, slots = ceil(ceil(n / tile_n) / tiles_per_slot); vec is
// unused. out: (d + 1) f32 = [grad, loss]. z_out may be null. enable: null,
// or a device int; a launch whose flag is 0 writes nothing. Returns the
// cudaError_t of the launches.
extern "C" int pt_fused_value_grad(const void* X, int x_is_bf16, const void* w, const void* y,
                                   const void* off, const void* wt, void* z_out, void* parts,
                                   void* out, int n, int d, int route, int tile_n, int grid,
                                   int tiles_per_slot, int stages, int loss, int vec,
                                   const void* enable, void* stream) {
  const pt::Args a{X,     w, y,      off,  wt,   z_out,          parts,  out, n,
                   d, tile_n, grid, tiles_per_slot, stages, vec, nullptr,
                   static_cast<const int*>(enable)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return (int)pt::dispatch_loss<__nv_bfloat16>(loss, route, a, s);
  return (int)pt::dispatch_loss<float>(loss, route, a, s);
}

// Resident CTAs per SM of the row route's kernel at this shape, into
// *ctas_per_sm. Launches nothing.
extern "C" int pt_fused_value_grad_occupancy(int x_is_bf16, int d, int tile_n, int stages,
                                             int loss, int* ctas_per_sm) {
  const pt::Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,     nullptr, nullptr,
                   0,       d,       tile_n,  0,       1,       stages,  0,           ctas_per_sm,
                   nullptr};
  if (x_is_bf16) return (int)pt::dispatch_loss<__nv_bfloat16>(loss, 1, a, nullptr);
  return (int)pt::dispatch_loss<float>(loss, 1, a, nullptr);
}
