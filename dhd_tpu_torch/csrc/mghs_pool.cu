// Fused MGHS pooling for Hopper (sm_90a): one pass over the points sorted by
// their z-minor voxel key writes both the height-gated fine voxel grid
// (vox, B*Dy*Dx*Dz rows) and the z-collapsed BEV grid (bev, B*Dy*Dx rows).
//
// Replaces dhd_tpu/ops/pallas_pool.py:_kernel_dual_fused (kernel B1).  What
// it computes is the same: for every in-grid point, v = T(depth[dix] *
// feat[pix]) (the product rounded to the working type, as the plain version
// computes it), summed in fp32 into bev[pillar], and into vox[pillar, z]
// where z >= 0 and the point's height-band gate is on.  Every output element
// is written, zeros included, by exactly one writer: no atomics, no
// zero-fill pass, the same sums on every run.
//
// Bound by bytes: writing vox dominates (200*200*16 rows of 64 bf16 at the
// DHD presets); the per-pixel depth, feature and gate tables stay in L2.
// The design:
//   * the plan's schedule (built on the card with the rest of the plan by
//     the plan_*_kernel launches below, ops/mghs_pool_cuda.py:
//     pool_plan_cuda) holds a task per pillar, or, for a pillar of more
//     than 128 points, a piece of at most 128 of its points, the heaviest
//     first; a warp takes a task,
//     eight warps a block, so a block's warps have about as much to do and
//     the heaviest blocks start first.  No shared memory, no
//     __syncthreads;
//   * a point's row lies across LPP lanes, VEC channels each, so a warp
//     sums 32 / LPP points a step, one a lane group (at C = 64 bf16: 4
//     channels a lane, 16 lanes a point, two points a step); each group
//     keeps its own partial sums, added across the groups by shuffles when
//     a row is stored, so a warp's loads, shuffles and branches serve
//     several points.  bf16 products are bf16x2 multiplies.  The warp walks
//     its points 32 at a time: one coalesced load of 32 points' indices,
//     each lane fetches its own point's depth and gate, and shuffles hand
//     the points to the groups.  The next chunk's depths and gates and the
//     indices of the chunk after it are in flight while a chunk is summed,
//     and 8 / VEC feature rows a lane;
//   * the points of a pillar come in key order, so a vox row's points are
//     contiguous and z never decreases: the warp keeps bev and the current
//     row's sum in registers and stores a row when z moves past it, with the
//     rows no point reaches as zeros.  Points outside the fine grid (z = -1)
//     and gated-off points add to bev only;
//   * a piece of a split pillar stores its dz + 1 rows as an fp32 partial
//     block in its own scratch slot, and a second pass (a programmatic
//     dependent launch: scheduled while the first runs, it waits for its end
//     on the device) adds each split pillar's blocks in slot order, a warp
//     per output row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPoolBlocksPerSM = 4;   // the first pass: 64 registers a thread
constexpr int kCombineUnroll = 8;     // partial rows in flight, second pass
constexpr int kCombineBlocks = 264;   // the second pass: 2 blocks an H100 SM
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC consecutive channels of one row: loaded and stored as one access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) AlignedChunk { T v[VEC]; };

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float* out) {
  const AlignedChunk<T, VEC> c =
      *reinterpret_cast<const AlignedChunk<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = to_f32(c.v[k]);
}

// v[k] = T(d * f[k]) in fp32, for the VEC channels of one raw row chunk;
// bf16 two channels at a time: one bf16x2 multiply rounds the exact
// product once, as the fp32 product rounded to bf16 does
template <typename T, int VEC>
__device__ __forceinline__ void products(float d,
                                         const AlignedChunk<T, VEC>& f,
                                         float* v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC % 2 == 0) {
    const __nv_bfloat162 d2 = __float2bfloat162_rn(d);
#pragma unroll
    for (int k = 0; k < VEC; k += 2) {
      const __nv_bfloat162 p =
          __hmul2(d2, __halves2bfloat162(f.v[k], f.v[k + 1]));
      v[k] = __low2float(p);
      v[k + 1] = __high2float(p);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      v[k] = to_f32(from_f32<T>(d * to_f32(f.v[k])));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* acc) {
  AlignedChunk<T, VEC> c;
#pragma unroll
  for (int k = 0; k < VEC; ++k) c.v[k] = from_f32<T>(acc[k]);
  *reinterpret_cast<AlignedChunk<T, VEC>*>(p) = c;
}

// tasks[t] = (pillar, first point, end point, slot): warp t sums points
// [first, end) of the pillar into its rows, or into the fp32 partial block
// of `slot` when slot >= 0.  Padding tasks name pillar n_pillars.  LPP
// lanes hold a point's row, VEC channels each: a warp takes 32 / LPP
// points a step, one a lane group, and each group keeps its own partial
// sums, added across the groups when a row is stored.
template <typename T, int VEC, int LPP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kPoolBlocksPerSM)
mghs_pool_kernel(const T* __restrict__ depth, const T* __restrict__ feat,
                 const T* __restrict__ band_mask,
                 const int32_t* __restrict__ dix_s,
                 const int32_t* __restrict__ z_s,
                 const int4* __restrict__ tasks, float* __restrict__ scratch,
                 T* __restrict__ bev, T* __restrict__ vox, int n_tasks,
                 int n_pillars, int C, int D, int dz, int edge0, int edge1) {
  // the second pass may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  constexpr int kGroups = 32 / LPP;       // points a step
  // steps of feature rows in flight: 8 / VEC, as many as a chunk holds
  constexpr int kRowsWant = 8 / VEC;
  constexpr int kRows =
      kRowsWant * kGroups <= 32 ? kRowsWant : 32 / kGroups;
  const int lane = threadIdx.x & 31;
  const int grp = lane / LPP;
  const int t = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (t >= n_tasks) return;                       // warp-uniform
  const int4 task = tasks[t];
  const int pillar = task.x;
  if (pillar >= n_pillars) return;                // padding
  const int p0 = task.y, p1 = task.z;
  float* const part =
      task.w >= 0 ? scratch + static_cast<size_t>(task.w) * (dz + 1) * C
                  : nullptr;
  T* const vrow = vox + static_cast<size_t>(pillar) * dz * C;
  T* const brow = bev + static_cast<size_t>(pillar) * C;

  // point i's indices (dix -1 past the task's end), and from them its
  // pixel, depth and gate, raw: converted where they are used, so that the
  // loads stay in flight meanwhile
  auto indices = [&](int i, int& dix, int& z) {
    dix = -1;
    z = -1;
    if (i < p1) {
      dix = dix_s[i];
      z = z_s[i];
    }
  };
  auto fetch = [&](int dix, int z, int& pix, T& d, T& gate) {
    pix = 0;
    d = gate = from_f32<T>(0.f);
    if (dix >= 0) {
      pix = dix / D;
      d = depth[dix];
      gate = band_mask[pix * 3 + (z >= edge0) + (z >= edge1)];
    }
  };

  for (int c0 = 0; c0 < C; c0 += LPP * VEC) {
    const int c = c0 + (lane % LPP) * VEC;
    const bool active = c < C;                    // C % VEC == 0
    float bsum[VEC], rsum[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) bsum[k] = rsum[k] = 0.f;
    int cur = 0;                                  // the row rsum sums
    // the row of `r` (r == dz: bev) in the output or the partial block
    auto row_of = [&](int r) -> size_t { return static_cast<size_t>(r) * C; };
    // row r (r == dz: bev) is final: the groups' sums added, stored by
    // group 0, and the sums restart
    auto put = [&](int r, float* acc) {
#pragma unroll
      for (int off = LPP; off < 32; off <<= 1)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] += __shfl_xor_sync(kFull, acc[k], off);
      if (active && grp == 0) {
        if (part != nullptr)
          store<float, VEC>(part + row_of(r) + c, acc);
        else if (r < dz)
          store<T, VEC>(vrow + row_of(r) + c, acc);
        else
          store<T, VEC>(brow + c, acc);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    };
    // rows [r0, r1) that no point reaches: zeros, a row a group
    auto zeros = [&](int r0, int r1) {
      const float zero[VEC] = {};
      for (int r = r0 + grp; r < r1; r += kGroups) {
        if (!active) continue;
        if (part != nullptr)
          store<float, VEC>(part + row_of(r) + c, zero);
        else
          store<T, VEC>(vrow + row_of(r) + c, zero);
      }
    };

    // a lane's point of the chunk (pix, z, d_raw, g_raw) and the indices
    // of its point in the next chunk (nx_dix, nx_z)
    int dix, z, pix, nx_dix, nx_z;
    T d_raw, g_raw;
    indices(p0 + lane, dix, z);
    fetch(dix, z, pix, d_raw, g_raw);
    indices(p0 + 32 + lane, nx_dix, nx_z);
    for (int base = p0; base < p1; base += 32) {
      const int n = min(32, p1 - base);
      // this chunk's point: its depth and fine z where the gate is on
      const int my_pix = pix;
      const float my_d = to_f32(d_raw);
      const int my_zg = z >= 0 && to_f32(g_raw) > 0.f ? z : -1;
      // the next chunk's values and the indices of the chunk after it, in
      // flight while this chunk is summed
      z = nx_z;
      fetch(nx_dix, nx_z, pix, d_raw, g_raw);
      indices(base + 64 + lane, nx_dix, nx_z);
      for (int j = 0; j < n; j += kRows * kGroups) {
        AlignedChunk<T, VEC> f[kRows];            // raw, as loaded
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          // the group's point of step u; every lane shuffles (src < 32)
          const int src = j + u * kGroups + grp;
          const int pu = __shfl_sync(kFull, my_pix, src);
#pragma unroll
          for (int k = 0; k < VEC; ++k) f[u].v[k] = from_f32<T>(0.f);
          if (active && src < n)
            f[u] = *reinterpret_cast<const AlignedChunk<T, VEC>*>(
                feat + static_cast<size_t>(pu) * C + c);
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (j + u * kGroups >= n) break;        // warp-uniform
          const int src = j + u * kGroups + grp;
          const float du = __shfl_sync(kFull, my_d, src);
          int zu = __shfl_sync(kFull, my_zg, src);
          if (src >= n) zu = -1;                  // past the chunk: f is 0
          float v[VEC];
          products(du, f[u], v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) bsum[k] += v[k];
          if (__any_sync(kFull, zu > cur)) {
            // a new row in this step: the groups' points in order
#pragma unroll
            for (int i = 0; i < kGroups; ++i) {
              const int zi = __shfl_sync(kFull, zu, i * LPP);
              if (zi > cur) {                     // warp-uniform
                put(cur, rsum);
                zeros(cur + 1, zi);
                cur = zi;
              }
              if (grp == i && zi >= 0) {
#pragma unroll
                for (int k = 0; k < VEC; ++k) rsum[k] += v[k];
              }
            }
          } else if (zu >= 0) {                   // zu == cur
#pragma unroll
            for (int k = 0; k < VEC; ++k) rsum[k] += v[k];
          }
        }
      }
    }
    put(cur, rsum);
    zeros(cur + 1, dz);
    put(dz, bsum);
  }
}

// The second pass: a warp per (split pillar, row), rows 0..dz-1 of vox and
// row dz of bev.  splits[e] = (pillar, first slot, pieces, 0), the split
// pillars first, then padding (pillar n_pillars).  The partial rows are
// read kCombineUnroll at a time into as many sums, added in a fixed order.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mghs_pool_combine_kernel(const int4* __restrict__ splits,
                         const float* __restrict__ scratch,
                         T* __restrict__ bev, T* __restrict__ vox,
                         int n_splits, int n_pillars, int C, int dz) {
  // launched while the first pass runs: wait for its end and its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31;
  const long long n_work = static_cast<long long>(n_splits) * (dz + 1);
  for (long long w = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       w < n_work; w += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    const int e = static_cast<int>(w / (dz + 1));
    const int r = static_cast<int>(w % (dz + 1));
    const int4 s = splits[e];
    if (s.x >= n_pillars) break;        // padding from here on; warp-uniform
    const size_t stride = static_cast<size_t>(dz + 1) * C;
    const float* src = scratch + static_cast<size_t>(s.y) * stride +
                       static_cast<size_t>(r) * C;
    T* dst = r < dz ? vox + (static_cast<size_t>(s.x) * dz + r) * C
                    : bev + static_cast<size_t>(s.x) * C;
    for (int c0 = 0; c0 < C; c0 += 32 * VEC) {
      const int c = c0 + lane * VEC;
      if (c >= C) break;                 // no shuffles below
      float part[kCombineUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) part[u][k] = 0.f;
      for (int i = 0; i < s.z; i += kCombineUnroll) {
#pragma unroll
        for (int u = 0; u < kCombineUnroll; ++u) {
          if (i + u < s.z) {
            float x[VEC];
            load<float, VEC>(src + static_cast<size_t>(i + u) * stride + c,
                             x);
#pragma unroll
            for (int k = 0; k < VEC; ++k) part[u][k] += x[k];
          }
        }
      }
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        acc[k] = 0.f;
#pragma unroll
        for (int u = 0; u < kCombineUnroll; ++u) acc[k] += part[u][k];
      }
      store<T, VEC>(dst + c, acc);
    }
  }
}

template <typename T, int VEC, int LPP>
int launch_vec(const T* depth, const T* feat, const T* band_mask,
               const int32_t* dix_s, const int32_t* z_s, const int4* tasks,
               const int4* splits, float* scratch, T* bev, T* vox,
               int n_tasks, int n_splits, int n_pillars, int C, int D, int dz,
               int edge0, int edge1, cudaStream_t st) {
  if (n_tasks == 0) return 0;
  mghs_pool_kernel<T, VEC, LPP>
      <<<(n_tasks + kWarpsPerBlock - 1) / kWarpsPerBlock,
         kWarpsPerBlock * 32, 0, st>>>(depth, feat, band_mask, dix_s, z_s,
                                        tasks, scratch, bev, vox, n_tasks,
                                        n_pillars, C, D, dz, edge0, edge1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 0) return static_cast<int>(err);
  const long long work = static_cast<long long>(n_splits) * (dz + 1);
  const long long want = (work + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(
      want < kCombineBlocks ? want : kCombineBlocks));
  cfg.blockDim = dim3(kWarpsPerBlock * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* sc = scratch;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, mghs_pool_combine_kernel<T, VEC>, splits, sc, bev, vox, n_splits,
      n_pillars, C, dz));
}

template <typename T>
int launch(const void* depth, const void* feat, const void* band_mask,
           const void* dix_s, const void* z_s, const void* tasks,
           const void* splits, void* scratch, void* bev, void* vox,
           int n_tasks, int n_splits, int n_pillars, int C, int D, int dz,
           int edge0, int edge1, int vec, int lpp, void* stream) {
#define POOL_LAUNCH(VEC, LPP)                                               \
  launch_vec<T, VEC, LPP>(                                                  \
      static_cast<const T*>(depth), static_cast<const T*>(feat),            \
      static_cast<const T*>(band_mask), static_cast<const int32_t*>(dix_s), \
      static_cast<const int32_t*>(z_s), static_cast<const int4*>(tasks),    \
      static_cast<const int4*>(splits), static_cast<float*>(scratch),       \
      static_cast<T*>(bev), static_cast<T*>(vox), n_tasks, n_splits,        \
      n_pillars, C, D, dz, edge0, edge1, static_cast<cudaStream_t>(stream))
  switch (vec * 100 + lpp) {
    case 108: return POOL_LAUNCH(1, 8);
    case 116: return POOL_LAUNCH(1, 16);
    case 132: return POOL_LAUNCH(1, 32);
    case 208: return POOL_LAUNCH(2, 8);
    case 216: return POOL_LAUNCH(2, 16);
    case 232: return POOL_LAUNCH(2, 32);
    case 408: return POOL_LAUNCH(4, 8);
    case 416: return POOL_LAUNCH(4, 16);
    case 432: return POOL_LAUNCH(4, 32);
  }
#undef POOL_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan, built on the card from the points sorted by key (key_s and
// the sort's order): each point's depth-table index and fine z, each
// pillar's first point, and the first pass's schedule.  A pillar of n
// points is n / piece tasks of `piece` points, then, where n % piece > 0
// or n == 0, one task of the rest; a pillar of more than `piece` points
// is split, and its tasks take consecutive scratch slots.  The tasks are
// listed by size, largest first, ties in pillar and point order (a
// stable counting sort over the sizes piece..0), then padding.  Three
// launches, the second and third programmatic dependents of the one
// before: the points (a thread each); the counts of each tile of
// kPlanTile pillars (a warp walks 32 pillars a step, a pillar a lane);
// then each tile adds up the tiles before it and writes its tasks.
constexpr int kPlanThreads = 256;
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kPlanSteps = 4;                   // 32-pillar steps a warp
constexpr int kPlanTile = kPlanWarps * kPlanSteps * 32;
constexpr int kMaxPiece = 256;
constexpr int kPlanCols = kMaxPiece + 3;        // sizes 0..piece, splits, slots

__device__ __forceinline__ int warp_excl_scan(int x, int lane, int& total) {
  int incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  total = __shfl_sync(kFull, incl, 31);
  return incl - x;
}

// point i: its depth-table index (the sort's order is a point id in (B,
// N, D, fH, fW) order; the table is pixel-major), its fine z (-1 outside
// the fine grid) and, where its pillar differs from the point before's,
// the first point of the pillars between
__global__ void __launch_bounds__(kPlanThreads)
plan_points_kernel(const int32_t* __restrict__ key_s,
                   const int64_t* __restrict__ order,
                   const int32_t* __restrict__ seg_vox, int P, int n_pillars,
                   int dz, int num_seg_vox, int D, int hw,
                   int32_t* __restrict__ dix_s, int32_t* __restrict__ z_s,
                   int32_t* __restrict__ starts) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int i = blockIdx.x * kPlanThreads + threadIdx.x;
  if (i >= P) return;
  const int key = key_s[i];
  const long long o = order[i];
  const long long cam = o / (static_cast<long long>(D) * hw);
  dix_s[i] = static_cast<int32_t>((cam * hw + o % hw) * D + (o / hw) % D);
  z_s[i] = seg_vox[o] != num_seg_vox ? key % dz : -1;
  const int cur = key / dz;          // n_pillars for a point off the grid
  const int prev = i > 0 ? key_s[i - 1] / dz : -1;
  for (int q = prev + 1; q <= cur; ++q) starts[q] = i;
  if (i == P - 1)
    for (int q = cur + 1; q <= n_pillars; ++q) starts[q] = P;
}

// One warp's walk of its pillars in a tile, kPlanSteps steps of 32, the
// intervals of all steps loaded first; step(p, s0, s1, full, rest,
// split) gets a pillar's full tasks, its last task's size (-1: none) and
// whether it is split (zeros and -1 past the last pillar).
template <typename Step>
__device__ __forceinline__ void walk_tile(const int32_t* __restrict__ starts,
                                          int n_pillars, int piece,
                                          Step step) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kPlanTile + warp * kPlanSteps * 32 + lane;
  int s0[kPlanSteps], s1[kPlanSteps];
#pragma unroll
  for (int u = 0; u < kPlanSteps; ++u) {
    const int p = base + u * 32;
    s0[u] = p < n_pillars ? starts[p] : 0;
    s1[u] = p < n_pillars ? starts[p + 1] : 0;
  }
#pragma unroll
  for (int u = 0; u < kPlanSteps; ++u) {
    const int p = base + u * 32;
    const int n = s1[u] - s0[u];
    const int rest =
        p < n_pillars && (n == 0 || n % piece) ? n % piece : -1;
    step(p, s0[u], s1[u], n / piece, rest, n > piece);
  }
}

// hist[w * kPlanCols + c]: warp w's tasks of c points (c <= piece), its
// split pillars (c = piece + 1) and their slots (c = piece + 2)
__device__ __forceinline__ void tile_hist(const int32_t* __restrict__ starts,
                                          int n_pillars, int piece,
                                          int* hist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kPlanWarps * kPlanCols; i += kPlanThreads)
    hist[i] = 0;
  __syncthreads();
  int* const mine = hist + warp * kPlanCols;
  const unsigned below = (1u << lane) - 1;
  int full_w = 0, split_w = 0, slot_w = 0;      // warp-uniform
  walk_tile(starts, n_pillars, piece,
            [&](int, int, int, int full, int rest, bool split) {
              full_w += __reduce_add_sync(kFull, full);
              split_w += __popc(__ballot_sync(kFull, split));
              slot_w += __reduce_add_sync(kFull,
                                          split ? full + (rest > 0) : 0);
              const unsigned same = __match_any_sync(kFull, rest);
              if (rest >= 0 && (same & below) == 0)
                mine[rest] += __popc(same);
              __syncwarp();
            });
  if (lane == 0) {
    mine[piece] = full_w;
    mine[piece + 1] = split_w;
    mine[piece + 2] = slot_w;
  }
  __syncthreads();
}

// the counts of each tile: counts[tile * (piece + 3) + c]
__global__ void __launch_bounds__(kPlanThreads)
plan_count_kernel(const int32_t* __restrict__ starts, int n_pillars,
                  int piece, int32_t* __restrict__ counts) {
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");   // starts written
  __shared__ int hist[kPlanWarps * kPlanCols];
  tile_hist(starts, n_pillars, piece, hist);
  for (int c = threadIdx.x; c < piece + 3; c += kPlanThreads) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kPlanWarps; ++w) sum += hist[w * kPlanCols + c];
    counts[blockIdx.x * (piece + 3) + c] = sum;
  }
}

__global__ void __launch_bounds__(kPlanThreads)
plan_write_kernel(const int32_t* __restrict__ starts, int n_pillars,
                  int piece, const int32_t* __restrict__ counts,
                  int4* __restrict__ tasks, int n_tasks,
                  int4* __restrict__ splits, int n_splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");   // counts written
  __shared__ int hist[kPlanWarps * kPlanCols];
  __shared__ int before[kPlanCols], total[kPlanCols];
  __shared__ int n_real;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cols = piece + 3;
  // every column over the tiles, and over the tiles before this one
  for (int c = threadIdx.x; c < cols; c += kPlanThreads) {
    int all = 0, bef = 0;
    for (int t = 0; t < static_cast<int>(gridDim.x); ++t) {
      const int v = counts[t * cols + c];
      all += v;
      bef += t < static_cast<int>(blockIdx.x) ? v : 0;
    }
    total[c] = all;
    before[c] = bef;
  }
  tile_hist(starts, n_pillars, piece, hist);      // syncs first
  // the first position of each size: the sizes above it, largest first;
  // lane l takes the sizes piece - l * per ... in that order
  if (warp == 0) {
    const int per = (piece + 1 + 31) / 32;
    int mine = 0;
    for (int k = 0; k < per; ++k) {
      const int r = piece - (lane * per + k);
      if (r >= 0) mine += total[r];
    }
    int all;
    int next = warp_excl_scan(mine, lane, all);
    for (int k = 0; k < per; ++k) {
      const int r = piece - (lane * per + k);
      if (r >= 0) {
        const int c = total[r];
        total[r] = next;               // now the size's first position
        next += c;
      }
    }
    if (lane == 0) n_real = all;
  }
  __syncthreads();
  // each warp's first position of each column: the tiles before, then the
  // warps before
  for (int c = threadIdx.x; c < cols; c += kPlanThreads) {
    int at = before[c] + (c <= piece ? total[c] : 0);
#pragma unroll
    for (int w = 0; w < kPlanWarps; ++w) {
      const int v = hist[w * kPlanCols + c];
      hist[w * kPlanCols + c] = at;
      at += v;
    }
  }
  __syncthreads();

  int* const at = hist + warp * kPlanCols;
  const unsigned below = (1u << lane) - 1;
  int full_at = at[piece], split_at = at[piece + 1], slot_at = at[piece + 2];
  walk_tile(starts, n_pillars, piece,
            [&](int p, int s0, int s1, int full, int rest, bool split) {
    int n_full, n_slots;
    const int full_ex = warp_excl_scan(full, lane, n_full);
    const int pieces = full + (rest >= 0);
    const int slot_ex = warp_excl_scan(split ? pieces : 0, lane, n_slots);
    const unsigned split_lanes = __ballot_sync(kFull, split);
    const int slot0 = split ? slot_at + slot_ex : -1;
    if (split) {
      const int e = split_at + __popc(split_lanes & below);
      if (e < n_splits) splits[e] = make_int4(p, slot0, pieces, 0);
    }
    for (int k = 0; k < full; ++k) {
      const int t = full_at + full_ex + k;
      if (t < n_tasks)
        tasks[t] = make_int4(p, s0 + k * piece, s0 + (k + 1) * piece,
                             split ? slot0 + k : -1);
    }
    const unsigned same = __match_any_sync(kFull, rest);
    if (rest >= 0) {
      const int t = at[rest] + __popc(same & below);
      if (t < n_tasks)
        tasks[t] = make_int4(p, s0 + full * piece, s1,
                             split ? slot0 + full : -1);
    }
    __syncwarp();
    if (rest >= 0 && (same & below) == 0) at[rest] += __popc(same);
    __syncwarp();
    full_at += n_full;
    split_at += __popc(split_lanes);
    slot_at += n_slots;
  });

  // padding: empty tasks past the last point, no slot; empty splits
  const int p_in = starts[n_pillars];
  const int stride = static_cast<int>(gridDim.x) * kPlanThreads;
  const int first = blockIdx.x * kPlanThreads + threadIdx.x;
  for (int t = n_real + first; t < n_tasks; t += stride)
    tasks[t] = make_int4(n_pillars, p_in, p_in, -1);
  for (int e = total[piece + 1] + first; e < n_splits; e += stride)
    splits[e] = make_int4(n_pillars, 0, 0, 0);
}

}  // namespace

// depth (pixels, D), feat (pixels, C), band_mask (pixels, 3) row-major;
// dix_s, z_s (P,) int32; tasks (n_tasks, 4) and splits (n_splits, 4)
// int32, 16-byte aligned; scratch (slots, dz + 1, C) fp32; bev (n_pillars,
// C) and vox (n_pillars, dz, C).  vec (1, 2 or 4) divides C, and feat is
// aligned to vec elements; lpp (8, 16 or 32) lanes hold a point's row.
#define POOL_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* depth, const void* feat,                   \
                      const void* band_mask, const void* dix_s,              \
                      const void* z_s, const void* tasks, const void* splits, \
                      void* scratch, void* bev, void* vox, int n_tasks,      \
                      int n_splits, int n_pillars, int C, int D, int dz,     \
                      int edge0, int edge1, int vec, int lpp,                \
                      void* stream) {                                        \
    return launch<T>(depth, feat, band_mask, dix_s, z_s, tasks, splits,      \
                     scratch, bev, vox, n_tasks, n_splits, n_pillars, C, D,  \
                     dz, edge0, edge1, vec, lpp, stream);                    \
  }

POOL_ENTRY(mghs_pool_bf16, __nv_bfloat16)
POOL_ENTRY(mghs_pool_f32, float)

// key_s (P,) int32 sorted keys and order (P,) int64 the sort's indices;
// seg_vox (P,) int32 in point order; dix_s, z_s (P,) and starts
// (n_pillars + 1,) int32 out; tasks (n_tasks, 4) and splits (n_splits, 4)
// int32 out, 16-byte aligned, sized by the points as
// ops/mghs_pool_cuda.py:_schedule_sizes sizes them; counts
// (ceil(n_pillars / 1024), piece + 3) int32 of work; 1 <= piece <= 256.
extern "C" int mghs_pool_plan(const void* key_s, const void* order,
                              const void* seg_vox, int P, int n_pillars,
                              int dz, int num_seg_vox, int D, int hw,
                              int piece, void* dix_s, void* z_s, void* starts,
                              void* tasks, int n_tasks, void* splits,
                              int n_splits, void* counts, void* stream) {
  if (piece < 1 || piece > kMaxPiece || n_pillars < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  plan_points_kernel<<<(P + kPlanThreads - 1) / kPlanThreads, kPlanThreads,
                       0, st>>>(
      static_cast<const int32_t*>(key_s), static_cast<const int64_t*>(order),
      static_cast<const int32_t*>(seg_vox), P, n_pillars, dz, num_seg_vox, D,
      hw, static_cast<int32_t*>(dix_s), static_cast<int32_t*>(z_s),
      static_cast<int32_t*>(starts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_pillars + kPlanTile - 1) / kPlanTile);
  cfg.blockDim = dim3(kPlanThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int32_t* st_ptr = static_cast<const int32_t*>(starts);
  err = cudaLaunchKernelEx(&cfg, plan_count_kernel, st_ptr, n_pillars, piece,
                           static_cast<int32_t*>(counts));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* counts_ptr = static_cast<const int32_t*>(counts);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, plan_write_kernel, st_ptr, n_pillars, piece, counts_ptr,
      static_cast<int4*>(tasks), n_tasks, static_cast<int4*>(splits),
      n_splits));
}
