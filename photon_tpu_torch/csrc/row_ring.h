// The "row" route shared by fused_value_grad.cu (K1) and fused_hvp.cu (K2):
// one read of X through registers, fed by an async bulk-copy ring.
//
// - Loads: one producer warp keeps a ring of `stages` row tiles in flight
//   with the 1-D bulk copy (a tile of row-major X is one contiguous span),
//   each stage guarded by a "full" mbarrier (transaction bytes) and an
//   "empty" one (one arrival per consumer warp).
// - Compute: each of 8 consumer warps owns whole rows of a tile. Lane l
//   holds the row's 16-byte chunks l, l+32, ... in registers, forms its part
//   of x.v against round(v) held in registers, and a fixed butterfly gives
//   every lane the dot s. The per-row operation (Op) turns s into the row's
//   coefficient c, and every lane adds x*c into its own d/32 accumulators
//   from the same registers: the tile is read from shared memory once, with
//   16-byte loads. Lane k holds the side values of the warp's k-th row
//   (loaded before the wait on the stage) and shuffles them to the others.
// - Schedule: the rows are cut into slots of a row count fixed by the shape
//   (ops/fused_glm.py row_plan). The grid is the card's resident CTAs; CTA c
//   walks slots c, c + grid, ... At a slot's end the warps' accumulators are
//   summed in warp order into that slot's partial [acc(d), extra(Op::kExtra)],
//   so a partial does not depend on the CTA or the card, and the partials go
//   through a fixed two-level tree (launch_reduce_tree).
//
// An Op provides:
//   kExtra                        0 or 1 values after the d columns of a partial;
//   Side, load(i)                 the side values of row i (lane k holds its row's);
//   coef(s, mine, k, lane, own)   row k's coefficient from its dot s; `own` is the
//                                 lane's scratch for the row it holds;
//   end_rows(mine, own, lane, rows, first_row)
//                                 after a tile: the lane's share of the extra value.
#pragma once

#include "glm_common.h"

namespace pt {

constexpr int kRowWarps = 8;
constexpr int kRowThreads = kRowWarps * 32;
// Rows of a warp processed together, so their butterflies and row math
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
// `mine`, the side values of row r_begin + k. Returns the lane's share of
// the tile's extra value.
template <typename T, typename Op, int CPL>
__device__ __forceinline__ float row_tile(const Op& op, const T* xs, int d, int C, int r_begin,
                                          int r_end, long row0, const typename Op::Side& mine,
                                          const float (&vr)[CPL][Chunk<T>::V],
                                          float (&acc)[CPL][Chunk<T>::V]) {
  constexpr int V = Chunk<T>::V;
  const int lane = threadIdx.x % 32;
  float own = 0.f;
  for (int r = r_begin; r < r_end; r += kRowBatch) {
    uint4 raw[kRowBatch][CPL];
    float s[kRowBatch];
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const bool live = r + b < r_end;
      const uint4* xr = reinterpret_cast<const uint4*>(xs + (long)(r + b) * d);
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        raw[b][k] = (live && c < C) ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
        float x[V];
        unpack(raw[b][k], x);
#pragma unroll
        for (int e = 0; e < V; ++e) p = fmaf(x[e], vr[k][e], p);
      }
      s[b] = p;
    }
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) s[b] = warp_sum(s[b]);
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      if (r + b < r_end) {  // the same for every lane of the warp
        const float c = op.coef(s[b], mine, (r + b - r_begin) & 31, lane, own);
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          float x[V];
          unpack(raw[b][k], x);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[k][e] = fmaf(x[e], c, acc[k][e]);
        }
      }
    }
  }
  return op.end_rows(mine, own, lane, r_end - r_begin, row0 + r_begin);
}

// Sums the warps' accumulators in warp order into one row [acc(d), extra]
// of width d + kExtra at out. red: kRowWarps * (d + kExtra) floats of
// shared memory.
template <typename T, int CPL, int kExtra>
__device__ __forceinline__ void flush_partial(const float (&acc)[CPL][Chunk<T>::V], float extra,
                                              float* red, int d, int C, float* __restrict__ out) {
  constexpr int V = Chunk<T>::V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int width = d + kExtra;
  named_sync(1, kRowThreads);  // earlier readers of red are done
  float* mine = red + warp * width;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
#pragma unroll
      for (int e = 0; e < V; ++e) mine[c * V + e] = acc[k][e];
    }
  }
  if constexpr (kExtra == 1) {
    const float ls = warp_sum(extra);
    if (lane == 0) mine[d] = ls;
  }
  named_sync(1, kRowThreads);
  for (int j = threadIdx.x; j < width; j += kRowThreads) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kRowWarps; ++v) s += red[v * width + j];
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
size_t row_smem_bytes(int d, int tile_n, int stages, int width) {
  return kBarrierBytes + stages * row_stage_bytes<T>(d, tile_n) +
         (size_t)kRowWarps * width * sizeof(float);
}

template <typename T, typename Op, int CPL>
__global__ void __launch_bounds__(kRowThreads + 32)
    row_kernel(const T* __restrict__ X, const float* __restrict__ vec, const Op op,
               float* __restrict__ parts, int n, int d, int tile_n, int tiles_per_slot,
               int stages, const int* __restrict__ enable) {
  if (launch_disabled(enable)) return;
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
  float vr[CPL][V];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
#pragma unroll
    for (int e = 0; e < V; ++e) vr[k][e] = c < C ? round_like<T>(vec[c * V + e]) : 0.f;
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
    float extra = 0.f;
    const int t1 = min(num_tiles, (slot + 1) * tiles_per_slot);
    for (int t = slot * tiles_per_slot; t < t1; ++t, ++it) {
      const int s = it % stages, round = it / stages;
      const long r0 = (long)t * tile_n;
      const int rows = (int)min((long)tile_n, (long)n - r0);
      const int rb = min(rows, warp * rpw), re = min(rows, rb + rpw);
      // Issued before the wait, so the loads overlap it.
      const typename Op::Side mine = lane < re - rb ? op.load(r0 + rb + lane) : typename Op::Side{};
      mbar_wait(&full[s], round & 1);
      extra += row_tile<T, Op, CPL>(op, reinterpret_cast<const T*>(ring + s * stage_bytes), d, C,
                                    rb, re, r0, mine, vr, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    flush_partial<T, CPL, Op::kExtra>(acc, extra, red, d, C,
                                      parts + (long)slot * (d + Op::kExtra));
  }
}

// One launch of the row route (pointers are device memory).
struct RowLaunch {
  const void* X;
  const float* vec;  // the vector dotted with each row, rounded like X
  float *parts, *out;
  int n, d, tile_n, grid, tiles_per_slot, stages;
  int* ctas_per_sm;    // if set, report the occupancy instead of launching
  const int* enable;   // launch flag (launch_disabled), may be null
};

template <typename T, typename Op, int CPL>
cudaError_t launch_row(const RowLaunch& a, const Op& op, cudaStream_t stream) {
  if (a.stages < 2 || a.stages > kMaxStages) return cudaErrorInvalidValue;
  const int width = a.d + Op::kExtra;
  const size_t smem = row_smem_bytes<T>(a.d, a.tile_n, a.stages, width);
  auto kernel = row_kernel<T, Op, CPL>;
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
  kernel<<<a.grid, kRowThreads + 32, smem, stream>>>(static_cast<const T*>(a.X), a.vec, op,
                                                      a.parts, a.n, a.d, a.tile_n,
                                                      a.tiles_per_slot, a.stages, a.enable);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // parts holds the slots' partials, then room for the tree's group sums.
  const int num_tiles = (a.n + a.tile_n - 1) / a.tile_n;
  const int num_slots = (num_tiles + a.tiles_per_slot - 1) / a.tiles_per_slot;
  return launch_reduce_tree(a.parts, num_slots, width, a.parts + (size_t)num_slots * width, a.out,
                            stream, a.enable);
}

// Chunks per lane: the smallest of 1, 2, 4, 8 with 32 * CPL >= d / V.
template <typename T, typename Op>
cudaError_t dispatch_row(const RowLaunch& a, const Op& op, cudaStream_t s) {
  const int C = a.d / Chunk<T>::V;
  if (C <= 32) return launch_row<T, Op, 1>(a, op, s);
  if (C <= 64) return launch_row<T, Op, 2>(a, op, s);
  if (C <= 128) return launch_row<T, Op, 4>(a, op, s);
  if constexpr (sizeof(T) == 4) {
    if (C <= 256) return launch_row<T, Op, 8>(a, op, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace pt
