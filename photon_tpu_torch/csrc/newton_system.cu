// Batched per-entity Newton system: for each entity e,
//   H_e = X_e^T diag(d2_e) X_e   (d x d)   and   g_e = X_e^T dz_e   (d),
// from one read of the entity's (n_max, d) slab.
//
// Replaces: photon_tpu/ops/pallas_newton.py::fused_newton_system (kernel
// bodies _system_kernel and _system_kernel_tiled, vmapped over entities),
// run once per random-effect Newton iteration.
//
// Bound on the H100: bytes up to d = 64 (each slab element is read once;
// the work is 2*d*d + 3*d flops per row, below the ridge), operations above:
// at d = 128 the upper triangle costs ~d*(d+1) flops per row against 4*d
// bytes, past the f32 ridge of ~20 flops a byte. What keeps a simple kernel
// from either bound is instruction issue: one FMA per shared-memory load if
// each thread owns one entry of H.
//
// Design (the launch plan is computed in ops/fused_newton.py newton_plan):
// - Register blocks. H is formed in 4x4 blocks; a lane owns one block on or
//   above the diagonal at a time and keeps it in registers. Per row, two 4-wide loads
//   x[a0:a0+4], x[b0:b0+4] and one of d2 feed 16 FMAs. Columns past d are
//   zeros in registers. The lower triangle is written as the mirror of the
//   upper (and a diagonal block uses its entries i <= j only), so H is
//   exactly symmetric. The owners of diagonal blocks also form g[a0:a0+4].
// - Panels. Above 32 * 8 upper blocks (d > 88) the blocks are cut into
//   `panels` runs of `panel_blocks` consecutive blocks, and the unit of work
//   is (entity, panel): unit u is panel u % panels of entity u / panels. A
//   panel reads the entity's whole slab, so a wide entity is read once per
//   panel; consecutive units, which run at about the same time on
//   neighbouring CTAs, read the same slab, so the re-reads mostly come from
//   L2. A block's sums do not depend on its panel or on the team that
//   computes it.
// - Row groups. A panel's lanes are panel_blocks x row_groups: group r takes the
//   rows i with i % row_groups == r. At the entity's end the groups' partial
//   blocks are summed in group order through shared memory, so the sum
//   order depends only on the shape.
// - Teams. A unit is worked by a team of whole warps (one warp at
//   d <= 16); a CTA holds several teams, one unit each at a time, and CTA
//   c walks unit groups c, c + grid, ... (grid from the card's occupancy).
// - Loads ("bulk" route: n_max a multiple of 4, rows of a multiple of 4
//   bytes, 16-byte aligned arrays). Each team keeps a ring of `stages`
//   chunks of its slab in flight: lane 0 issues three 1-D bulk copies per
//   chunk (X rows, d2, dz; each a contiguous span of a multiple of 16 bytes)
//   on the stage's "full" mbarrier, and re-issues a stage once every warp of
//   the team has arrived on its "empty" one. The ring runs on across the
//   team's entities, so the next entity's first chunks land while the
//   current one finishes.
// - "direct" route (any other shape): the same lanes and sums, loads
//   straight from device memory, element by element. Both routes give the
//   same bits for the same inputs.
#include "glm_common.h"

namespace pt {

constexpr int kBlk = 4;
constexpr int kPart = kBlk * kBlk + kBlk;  // a lane's block of H, then its piece of g
constexpr int kMaxStagesN = 4;
constexpr int kMaxThreadsN = 256;

struct Geometry {
  int E, n_max, d;
  int nb, blocks;  // blocks a side, blocks on or above the diagonal
  int panels, panel_blocks;  // a unit of work is (entity, panel)
  int team_warps, row_groups, teams;
  int chunk_rows, stages;  // bulk route only
};

__host__ __device__ __forceinline__ size_t align128n(size_t b) { return (b + 127) & ~size_t(127); }

template <typename T>
__host__ __device__ __forceinline__ size_t chunk_x_bytes(const Geometry& g) {
  return (size_t)g.chunk_rows * g.d * sizeof(T);
}

template <typename T>
__host__ __device__ __forceinline__ size_t stage_bytes(const Geometry& g) {
  return align128n(chunk_x_bytes<T>(g) + 2 * (size_t)g.chunk_rows * sizeof(float));
}

// Shared memory: the teams' mbarriers, their rings, then their reduction
// areas (panel_blocks * (row_groups - 1) * kPart floats each: group 0 keeps
// its partial in registers).
__host__ __device__ __forceinline__ size_t barrier_bytes(const Geometry& g, bool bulk) {
  return bulk ? align128n((size_t)g.teams * 2 * g.stages * sizeof(uint64_t)) : 0;
}

template <typename T>
__host__ __device__ __forceinline__ size_t red_offset(const Geometry& g, bool bulk) {
  return barrier_bytes(g, bulk) + (bulk ? (size_t)g.teams * g.stages * stage_bytes<T>(g) : 0);
}

template <typename T>
size_t smem_bytes(const Geometry& g, bool bulk) {
  return red_offset<T>(g, bulk) +
         (size_t)g.teams * g.panel_blocks * (g.row_groups - 1) * kPart * sizeof(float);
}

// x[a0:a0+4] of a row as f32; columns past d are zero.
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* row, int a0, int d, float (&v)[4]) {
  if constexpr (kVec) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + a0);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      // bf16 is the top half of an f32: a shift or a mask converts it exactly.
      const uint2 q = *reinterpret_cast<const uint2*>(row + a0);
      v[0] = __uint_as_float(q.x << 16);
      v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16);
      v[3] = __uint_as_float(q.y & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBlk; ++i) v[i] = a0 + i < d ? to_f32(row[a0 + i]) : 0.f;
  }
}

// Rows j0, j0 + step, ... below `rows` of a span of rows at xs (d columns),
// with their d2 and dz, into the lane's block h and, on a diagonal block, gv.
template <typename T, bool kVec>
__device__ __forceinline__ void add_rows(const T* xs, const float* d2s, const float* dzs, int d,
                                         int j0, int rows, int step, int a0, int b0, bool diag,
                                         float (&h)[kBlk][kBlk], float (&gv)[kBlk]) {
#pragma unroll 2
  for (int j = j0; j < rows; j += step) {
    const T* xr = xs + (long)j * d;
    float xa[kBlk], xb[kBlk];
    load4<T, kVec>(xr, a0, d, xa);
    load4<T, kVec>(xr, b0, d, xb);
    const float w = d2s[j];
#pragma unroll
    for (int i = 0; i < kBlk; ++i) {
      const float t = w * xa[i];
#pragma unroll
      for (int k = 0; k < kBlk; ++k) h[i][k] = fmaf(t, xb[k], h[i][k]);
    }
    if (diag) {
      const float z = dzs[j];
#pragma unroll
      for (int i = 0; i < kBlk; ++i) gv[i] = fmaf(xa[i], z, gv[i]);
    }
  }
}

template <typename T, bool kBulk, bool kVec>
__global__ void __launch_bounds__(kMaxThreadsN)
    newton_system_kernel(const T* __restrict__ X, const float* __restrict__ d2,
                         const float* __restrict__ dz, float* __restrict__ H,
                         float* __restrict__ g, const Geometry geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = geo.d, n_max = geo.n_max, G = geo.row_groups, P = geo.panel_blocks;
  const int team_threads = geo.team_warps * 32;
  const int team = threadIdx.x / team_threads, t = threadIdx.x % team_threads;
  const int lane = threadIdx.x % 32;
  const int grp = t / P;

  // The lane's block in a unit's panel: upper blocks in row-major order,
  // panel p holding blocks p * P ... p * P + P - 1; then its row group.
  bool active = false, diag = false;
  int a0 = 0, b0 = 0;
  auto setup = [&](long u) {
    const int blk = (int)(u % geo.panels) * P + t % P;
    active = t < P * G && blk < geo.blocks;
    int bi = 0, rem = active ? blk : 0;
    while (rem >= geo.nb - bi) {
      rem -= geo.nb - bi;
      ++bi;
    }
    a0 = kBlk * bi;
    b0 = kBlk * (bi + rem);
    diag = rem == 0;
  };

  float* red = reinterpret_cast<float*>(smem + red_offset<T>(geo, kBulk)) +
               (size_t)team * P * (G - 1) * kPart;
  auto team_sync = [&]() {
    if (geo.team_warps == 1) {
      __syncwarp();
    } else {
      named_sync(1 + team, team_threads);
    }
  };

  float h[kBlk][kBlk], gv[kBlk];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < kBlk; ++i) {
      gv[i] = 0.f;
#pragma unroll
      for (int k = 0; k < kBlk; ++k) h[i][k] = 0.f;
    }
  };
  // Sums the row groups' blocks in group order and writes the unit's part of
  // its entity's H and g.
  auto finish = [&](long u) {
    const long e = u / geo.panels;
    team_sync();  // earlier readers of red are done
    if (active && grp > 0) {
      float* mine = red + (t - P) * kPart;
#pragma unroll
      for (int i = 0; i < kBlk; ++i) {
#pragma unroll
        for (int k = 0; k < kBlk; ++k) mine[i * kBlk + k] = h[i][k];
        mine[kBlk * kBlk + i] = gv[i];
      }
    }
    team_sync();
    if (active && grp == 0) {
      float v[kPart];
#pragma unroll
      for (int i = 0; i < kBlk; ++i) {
#pragma unroll
        for (int k = 0; k < kBlk; ++k) v[i * kBlk + k] = h[i][k];
        v[kBlk * kBlk + i] = gv[i];
      }
      for (int q = 1; q < G; ++q) {
#pragma unroll
        for (int k = 0; k < kPart; ++k) v[k] += red[(t + (q - 1) * P) * kPart + k];
      }
      float* He = H + e * d * d;
#pragma unroll
      for (int i = 0; i < kBlk; ++i) {
#pragma unroll
        for (int k = 0; k < kBlk; ++k) {
          const int a = a0 + i, b = b0 + k;
          if (a < d && b < d && (!diag || i <= k)) {
            He[(long)a * d + b] = v[i * kBlk + k];
            He[(long)b * d + a] = v[i * kBlk + k];
          }
        }
        if (diag && a0 + i < d) g[e * d + a0 + i] = v[kBlk * kBlk + i];
      }
    }
    zero();
  };

  // This team's units: (q * teams + team) for groups q = blockIdx.x,
  // blockIdx.x + gridDim.x, ... below E * panels.
  const long units = (long)geo.E * geo.panels;
  int count = 0;
  if (team < units) {
    const long q_last = (units - 1 - team) / geo.teams;
    if ((long)blockIdx.x <= q_last) count = (int)((q_last - blockIdx.x) / gridDim.x + 1);
  }
  auto unit = [&](int k) {
    return ((long)blockIdx.x + (long)k * gridDim.x) * geo.teams + team;
  };
  zero();

  if constexpr (!kBulk) {
    for (int k = 0; k < count; ++k) {
      const long u = unit(k), e = u / geo.panels;
      setup(u);
      if (active) {
        add_rows<T, false>(X + e * n_max * d, d2 + e * n_max, dz + e * n_max, d, grp, n_max, G,
                           a0, b0, diag, h, gv);
      }
      finish(u);
    }
  } else {
    const int S = geo.stages, R = geo.chunk_rows;
    const int per_entity = (n_max + R - 1) / R;
    const int items = count * per_entity;
    const size_t sb = stage_bytes<T>(geo), xb = chunk_x_bytes<T>(geo);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem) + (size_t)team * 2 * S;
    uint64_t* empty = full + S;
    unsigned char* ring = smem + barrier_bytes(geo, true) + (size_t)team * S * sb;
    if (threadIdx.x == 0) {
      for (int s = 0; s < geo.teams * 2 * S; s += 2 * S) {
        uint64_t* f = reinterpret_cast<uint64_t*>(smem) + s;
        for (int i = 0; i < S; ++i) {
          mbar_init(&f[i], 1);
          mbar_init(&f[S + i], geo.team_warps);
        }
      }
      mbar_init_fence();
    }
    __syncthreads();

    // Item i is chunk i % per_entity of the team's (i / per_entity)-th unit.
    auto issue = [&](int i) {
      const int s = i % S, c = i % per_entity;
      const long base = unit(i / per_entity) / geo.panels * n_max + (long)c * R;
      const int rows = min(R, n_max - c * R);
      const uint32_t bx = (uint32_t)((size_t)rows * d * sizeof(T)), bv = rows * sizeof(float);
      unsigned char* st = ring + s * sb;
      mbar_arrive_expect_tx(&full[s], bx + 2 * bv);
      bulk_copy_g2s(st, X + base * d, bx, &full[s]);
      bulk_copy_g2s(st + xb, d2 + base, bv, &full[s]);
      bulk_copy_g2s(st + xb + R * sizeof(float), dz + base, bv, &full[s]);
    };
    if (t == 0) {
      for (int i = 0; i < min(S, items); ++i) issue(i);
    }
    __syncwarp();
    for (int i = 0; i < items; ++i) {
      const int s = i % S, round = i / S, c = i % per_entity;
      const int r0 = c * R, rows = min(R, n_max - r0);
      if (c == 0) setup(unit(i / per_entity));
      mbar_wait(&full[s], round & 1);
      if (active) {
        const unsigned char* st = ring + s * sb;
        const float* d2s = reinterpret_cast<const float*>(st + xb);
        add_rows<T, kVec>(reinterpret_cast<const T*>(st), d2s, d2s + R, d, (grp - r0 % G + G) % G,
                          rows, G, a0, b0, diag, h, gv);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (t == 0 && i + S < items) {
        mbar_wait(&empty[s], round & 1);
        issue(i + S);
      }
      __syncwarp();  // the producer lane rejoins its warp before the next chunk
      if (c == per_entity - 1) finish(unit(i / per_entity));
    }
  }
}

struct Args {
  const void *X, *d2, *dz;
  void *H, *g;
  int grid;
  int* ctas_per_sm;  // if set, report the occupancy instead of launching
};

template <typename T, bool kBulk, bool kVec>
cudaError_t launch(const Args& a, const Geometry& geo, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(geo, kBulk);
  const int threads = geo.teams * geo.team_warps * 32;
  auto kernel = newton_system_kernel<T, kBulk, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (a.ctas_per_sm != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.ctas_per_sm, kernel, threads, smem);
  }
  kernel<<<a.grid, threads, smem, stream>>>(
      static_cast<const T*>(a.X), static_cast<const float*>(a.d2), static_cast<const float*>(a.dz),
      static_cast<float*>(a.H), static_cast<float*>(a.g), geo);
  return cudaGetLastError();
}

// route 1 (bulk) takes 4-wide vector loads where rows are whole 4-value groups.
template <typename T>
cudaError_t dispatch(int route, const Args& a, const Geometry& geo, cudaStream_t s) {
  if (route == 0) return launch<T, false, false>(a, geo, s);
  if (geo.chunk_rows < 4 || geo.chunk_rows % 4 != 0 || geo.n_max % 4 != 0 ||
      (geo.d * sizeof(T)) % 4 != 0 || geo.stages < 1 || geo.stages > kMaxStagesN) {
    return cudaErrorInvalidValue;
  }
  if (geo.d % kBlk == 0) return launch<T, true, true>(a, geo, s);
  return launch<T, true, false>(a, geo, s);
}

inline cudaError_t make_geometry(int E, int n_max, int d, int panels, int team_warps,
                                 int row_groups, int teams, int chunk_rows, int stages,
                                 Geometry* geo) {
  if (d < 1 || panels < 1 || team_warps < 1 || row_groups < 1 || teams < 1 ||
      teams * team_warps * 32 > kMaxThreadsN) {
    return cudaErrorInvalidValue;
  }
  const int nb = (d + kBlk - 1) / kBlk, blocks = nb * (nb + 1) / 2;
  const int panel_blocks = (blocks + panels - 1) / panels;
  *geo = Geometry{E, n_max, d, nb, blocks, panels, panel_blocks, team_warps, row_groups, teams,
                  chunk_rows, stages};
  if (panel_blocks * row_groups > team_warps * 32) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace pt

// X: (E, n_max, d) f32 or bf16; d2, dz: (E, n_max) f32; H: (E, d, d); g:
// (E, d). route 1 = bulk, 0 = direct; the rest is newton_plan's geometry.
extern "C" int pt_newton_system(const void* X, int x_is_bf16, const void* d2, const void* dz,
                                void* H, void* g, int E, int n_max, int d, int route, int panels,
                                int team_warps, int row_groups, int teams, int chunk_rows,
                                int stages, int grid, void* stream) {
  pt::Geometry geo;
  cudaError_t err = pt::make_geometry(E, n_max, d, panels, team_warps, row_groups, teams,
                                      chunk_rows, stages, &geo);
  if (err != cudaSuccess) return (int)err;
  const pt::Args a{X, d2, dz, H, g, grid, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) return (int)pt::dispatch<__nv_bfloat16>(route, a, geo, s);
  return (int)pt::dispatch<float>(route, a, geo, s);
}

// Resident CTAs per SM of the kernel at this geometry, into *ctas_per_sm.
// Launches nothing.
extern "C" int pt_newton_system_occupancy(int x_is_bf16, int n_max, int d, int route, int panels,
                                          int team_warps, int row_groups, int teams,
                                          int chunk_rows, int stages, int* ctas_per_sm) {
  pt::Geometry geo;
  cudaError_t err = pt::make_geometry(1, n_max, d, panels, team_warps, row_groups, teams,
                                      chunk_rows, stages, &geo);
  if (err != cudaSuccess) return (int)err;
  const pt::Args a{nullptr, nullptr, nullptr, nullptr, nullptr, 0, ctas_per_sm};
  if (x_is_bf16) return (int)pt::dispatch<__nv_bfloat16>(route, a, geo, nullptr);
  return (int)pt::dispatch<float>(route, a, geo, nullptr);
}
