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
// "row" (rows of a multiple of 16 bytes, d <= 1024):
// - Loads: one producer warp keeps a ring of `stages` row tiles in flight
//   with the 1-D bulk copy (a tile of row-major X is one contiguous span),
//   each stage guarded by a "full" mbarrier (transaction bytes) and an
//   "empty" one (one arrival per consumer warp).
// - Compute: each of 8 consumer warps owns whole rows of a tile. Lane l
//   holds the row's 16-byte chunks l, l+32, ... in registers, forms its part
//   of x.w against round(w) held in registers, and a fixed butterfly gives
//   every lane z. Every lane computes dz itself and adds x*dz into its own
//   d/32 accumulators from the same registers: the tile is read from shared
//   memory once, with 16-byte loads, and no lane waits on another. Lane k
//   holds the vectors (y, off, wt) of the warp's k-th row, evaluates that
//   row's loss and writes its margin.
// - Schedule: the rows are cut into slots of a row count fixed by the shape
//   (ops/fused_glm.py row_plan). The grid is the card's resident CTAs; CTA c
//   walks slots c, c + grid, ... At a slot's end the warps' accumulators are
//   summed in warp order into that slot's partial [grad(d), loss], so a
//   partial does not depend on the CTA or the card, and the partials go
//   through a fixed two-level tree (launch_reduce_tree).
//
// "tile" (any other d <= 4096): PR 1's kernel. Each CTA walks a fixed set of
// row tiles (tile t goes to CTA t % grid of a grid fixed by shape), stages
// the tile in shared memory, one warp per row forms z, then every thread
// adds X_tile^T dz into registers for the columns it owns; one partial per
// CTA, summed in a fixed order (reduce_parts).
//
// Both routes give results that are bitwise reproducible (no atomics).
#include "glm_common.h"

namespace pt {

// ---------------------------------------------------------------- row route

constexpr int kRowWarps = 8;
constexpr int kRowThreads = kRowWarps * 32;
// Rows of a warp processed together, so their butterflies and loss math
// interleave.
constexpr int kRowBatch = 2;

template <typename T>
struct Chunk {
  static constexpr int V = 16 / sizeof(T);  // values in a 16-byte chunk
};

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

// bf16 is the top half of an f32: a shift or a mask converts it exactly.
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// The warp's rows [r_begin, r_end) of a tile staged at xs (row-major, d
// columns, C chunks a row); row0 is the tile's first row in X. Lane k holds
// yk, ok, wk of row r_begin + k.
template <typename T, int L, int CPL>
__device__ __forceinline__ void row_tile(const T* xs, int d, int C, int r_begin, int r_end,
                                         long row0, float yk, float ok, float wk,
                                         const float (&wr)[CPL][Chunk<T>::V],
                                         float (&acc)[CPL][Chunk<T>::V], float& loss_acc,
                                         float* __restrict__ z_out) {
  constexpr int V = Chunk<T>::V;
  const int lane = threadIdx.x % 32;
  float zk = 0.f;
  for (int r = r_begin; r < r_end; r += kRowBatch) {
    uint4 raw[kRowBatch][CPL];
    float z[kRowBatch];
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const bool live = r + b < r_end;
      const uint4* xr = reinterpret_cast<const uint4*>(xs + (long)(r + b) * d);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        raw[b][k] = (live && c < C) ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
        float x[V];
        unpack(raw[b][k], x);
#pragma unroll
        for (int e = 0; e < V; ++e) s = fmaf(x[e], wr[k][e], s);
      }
      z[b] = s;
    }
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) z[b] = warp_sum(z[b]);
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const int k = (r + b - r_begin) & 31;
      const float zi = z[b] + __shfl_sync(0xffffffffu, ok, k);
      const float yi = __shfl_sync(0xffffffffu, yk, k);
      const float wi = __shfl_sync(0xffffffffu, wk, k);
      if (r + b < r_end) {
        if (lane == k) zk = zi;
        const float dz = wi * loss_dz<L>(zi, yi);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float x[V];
          unpack(raw[b][c], x);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[c][e] = fmaf(x[e], dz, acc[c][e]);
        }
      }
    }
  }
  if (lane < r_end - r_begin) {
    loss_acc += wk * loss_value<L>(zk, yk);
    if (z_out != nullptr) z_out[row0 + r_begin + lane] = zk;
  }
}

// Sums the warps' accumulators in warp order into one row [grad(d), loss]
// at out. red: kRowWarps * (d + 1) floats of shared memory.
template <typename T, int CPL>
__device__ __forceinline__ void flush_partial(const float (&acc)[CPL][Chunk<T>::V], float loss_acc,
                                              float* red, int d, int C, float* __restrict__ out) {
  constexpr int V = Chunk<T>::V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  named_sync(1, kRowThreads);  // earlier readers of red are done
  float* mine = red + warp * (d + 1);
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
#pragma unroll
      for (int e = 0; e < V; ++e) mine[c * V + e] = acc[k][e];
    }
  }
  const float ls = warp_sum(loss_acc);
  if (lane == 0) mine[d] = ls;
  named_sync(1, kRowThreads);
  for (int j = threadIdx.x; j <= d; j += kRowThreads) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kRowWarps; ++v) s += red[v * (d + 1) + j];
    out[j] = s;
  }
}

// Shared memory of the row kernel: 2 * stages mbarriers in the first
// kBarrierBytes, then the ring of stages (each 128-byte aligned), then the
// warps' reduction rows.
constexpr int kMaxStages = 8;
constexpr size_t kBarrierBytes = 2 * kMaxStages * sizeof(uint64_t);

__host__ __device__ __forceinline__ size_t align128(size_t b) { return (b + 127) & ~size_t(127); }

template <typename T>
__host__ __device__ __forceinline__ size_t row_stage_bytes(int d, int tile_n) {
  return align128((size_t)tile_n * d * sizeof(T));
}

template <typename T>
size_t row_smem_bytes(int d, int tile_n, int stages) {
  return kBarrierBytes + stages * row_stage_bytes<T>(d, tile_n) +
         (size_t)kRowWarps * (d + 1) * sizeof(float);
}

template <typename T, int L, int CPL>
__global__ void __launch_bounds__(kRowThreads + 32)
    row_value_grad_kernel(const T* __restrict__ X, const float* __restrict__ w,
                          const float* __restrict__ y, const float* __restrict__ off,
                          const float* __restrict__ wt, float* __restrict__ z_out,
                          float* __restrict__ parts, int n, int d, int tile_n,
                          int tiles_per_slot, int stages) {
  constexpr int V = Chunk<T>::V;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  unsigned char* ring = smem + kBarrierBytes;
  const size_t stage_bytes = row_stage_bytes<T>(d, tile_n);
  float* red = reinterpret_cast<float*>(ring + stages * stage_bytes);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int num_tiles = (n + tile_n - 1) / tile_n;
  const int num_slots = (num_tiles + tiles_per_slot - 1) / tiles_per_slot;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kRowWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kRowWarps) {
    // Producer: one lane keeps up to `stages` tiles in flight. A tile of a
    // row-major X is one contiguous span, a multiple of 16 bytes.
    if (lane == 0) {
      int it = 0;
      for (int slot = blockIdx.x; slot < num_slots; slot += gridDim.x) {
        const int t1 = min(num_tiles, (slot + 1) * tiles_per_slot);
        for (int t = slot * tiles_per_slot; t < t1; ++t, ++it) {
          const int s = it % stages, round = it / stages;
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          const long r0 = (long)t * tile_n;
          const int rows = (int)min((long)tile_n, (long)n - r0);
          const uint32_t bytes = (uint32_t)((size_t)rows * d * sizeof(T));
          mbar_arrive_expect_tx(&full[s], bytes);
          bulk_copy_g2s(ring + s * stage_bytes, X + r0 * d, bytes, &full[s]);
        }
      }
    }
    return;
  }

  const int C = d / V;
  float wr[CPL][V];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
#pragma unroll
    for (int e = 0; e < V; ++e) wr[k][e] = c < C ? round_like<T>(w[c * V + e]) : 0.f;
  }

  // Consumers: a warp's rows of a tile are rows [warp * rpw, (warp + 1) * rpw).
  const int rpw = tile_n / kRowWarps;
  int it = 0;
  for (int slot = blockIdx.x; slot < num_slots; slot += gridDim.x) {
    float acc[CPL][V];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[k][e] = 0.f;
    }
    float loss_acc = 0.f;
    const int t1 = min(num_tiles, (slot + 1) * tiles_per_slot);
    for (int t = slot * tiles_per_slot; t < t1; ++t, ++it) {
      const int s = it % stages, round = it / stages;
      const long r0 = (long)t * tile_n;
      const int rows = (int)min((long)tile_n, (long)n - r0);
      const int rb = min(rows, warp * rpw), re = min(rows, rb + rpw);
      float yk = 0.f, ok = 0.f, wk = 0.f;
      if (lane < re - rb) {  // issued before the wait, so they overlap it
        const long i = r0 + rb + lane;
        yk = y[i];
        ok = off[i];
        wk = wt[i];
      }
      mbar_wait(&full[s], round & 1);
      row_tile<T, L, CPL>(reinterpret_cast<const T*>(ring + s * stage_bytes), d, C, rb, re, r0,
                          yk, ok, wk, wr, acc, loss_acc, z_out);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    flush_partial<T, CPL>(acc, loss_acc, red, d, C, parts + (long)slot * (d + 1));
  }
}

// Launch arguments, one struct for both routes (pointers are device memory).
struct Args {
  const void *X, *w, *y, *off, *wt;
  void *z_out, *parts, *out;
  int n, d, tile_n, grid, tiles_per_slot, stages, vec;
  int* ctas_per_sm;  // if set, the row route reports its occupancy instead of launching
};

template <typename T, int L, int CPL>
cudaError_t launch_row(const Args& a, cudaStream_t stream) {
  if (a.stages < 2 || a.stages > kMaxStages) return cudaErrorInvalidValue;
  const size_t smem = row_smem_bytes<T>(a.d, a.tile_n, a.stages);
  auto kernel = row_value_grad_kernel<T, L, CPL>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // Several CTAs of ~74 KiB share an SM only with the carveout at its most.
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (a.ctas_per_sm != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.ctas_per_sm, kernel, kRowThreads + 32,
                                                         smem);
  }
  kernel<<<a.grid, kRowThreads + 32, smem, stream>>>(
      static_cast<const T*>(a.X), static_cast<const float*>(a.w), static_cast<const float*>(a.y),
      static_cast<const float*>(a.off), static_cast<const float*>(a.wt),
      static_cast<float*>(a.z_out), static_cast<float*>(a.parts), a.n, a.d, a.tile_n,
      a.tiles_per_slot, a.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // parts holds the slots' partials, then room for the tree's group sums.
  const int num_tiles = (a.n + a.tile_n - 1) / a.tile_n;
  const int num_slots = (num_tiles + a.tiles_per_slot - 1) / a.tiles_per_slot;
  float* parts = static_cast<float*>(a.parts);
  return launch_reduce_tree(parts, num_slots, a.d + 1, parts + (size_t)num_slots * (a.d + 1),
                            static_cast<float*>(a.out), stream);
}

// Chunks per lane: the smallest of 1, 2, 4, 8 with 32 * CPL >= d / V.
template <typename T, int L>
cudaError_t dispatch_row(const Args& a, cudaStream_t s) {
  const int C = a.d / Chunk<T>::V;
  if (C <= 32) return launch_row<T, L, 1>(a, s);
  if (C <= 64) return launch_row<T, L, 2>(a, s);
  if (C <= 128) return launch_row<T, L, 4>(a, s);
  if constexpr (sizeof(T) == 4) {
    if (C <= 256) return launch_row<T, L, 8>(a, s);
  }
  return cudaErrorInvalidValue;
}

// --------------------------------------------------------------- tile route

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    tile_value_grad_kernel(const T* __restrict__ X, const float* __restrict__ w,
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
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  const size_t smem =
      align16((size_t)a.tile_n * a.d * sizeof(T)) + (size_t)(a.d + 2 * a.tile_n) * sizeof(float);
  auto kernel = tile_value_grad_kernel<T, L>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.X), static_cast<const float*>(a.w), static_cast<const float*>(a.y),
      static_cast<const float*>(a.off), static_cast<const float*>(a.wt),
      static_cast<float*>(a.z_out), static_cast<float*>(a.parts), a.n, a.d, a.tile_n, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(static_cast<const float*>(a.parts), a.grid, a.d + 1,
                       static_cast<float*>(a.out), stream);
}

template <typename T, int L>
cudaError_t dispatch_route(int route, const Args& a, cudaStream_t s) {
  return route == 1 ? dispatch_row<T, L>(a, s) : launch_tile<T, L>(a, s);
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
// unused. out: (d + 1) f32 = [grad, loss]. z_out may be null. Returns the
// cudaError_t of the launches.
extern "C" int pt_fused_value_grad(const void* X, int x_is_bf16, const void* w, const void* y,
                                   const void* off, const void* wt, void* z_out, void* parts,
                                   void* out, int n, int d, int route, int tile_n, int grid,
                                   int tiles_per_slot, int stages, int loss, int vec,
                                   void* stream) {
  const pt::Args a{X,     w, y,      off,  wt,   z_out,          parts,  out, n,
                   d, tile_n, grid, tiles_per_slot, stages, vec, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return (int)pt::dispatch_loss<__nv_bfloat16>(loss, route, a, s);
  return (int)pt::dispatch_loss<float>(loss, route, a, s);
}

// Resident CTAs per SM of the row route's kernel at this shape, into
// *ctas_per_sm. Launches nothing.
extern "C" int pt_fused_value_grad_occupancy(int x_is_bf16, int d, int tile_n, int stages,
                                             int loss, int* ctas_per_sm) {
  const pt::Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                   0,       d,       tile_n,  0,       1,       stages,  0,       ctas_per_sm};
  if (x_is_bf16) return (int)pt::dispatch_loss<__nv_bfloat16>(loss, 1, a, nullptr);
  return (int)pt::dispatch_loss<float>(loss, 1, a, nullptr);
}
