// Sorted segment-sum for Hopper (sm_90a):
//   out[v] = sum over i with seg[i] == v of vals[row(i)]   for v in [0, V)
// over points sorted by segment id, with row(i) = order[i] when an order is
// given (the kernel gathers the rows of unsorted values itself) and i
// otherwise.  Sums are fp32; ids < 0 or >= V contribute nothing; every
// output row is written, empty segments as exact zeros.
//
// Replaces dhd_tpu/ops/pallas_pool.py:_kernel (kernel B2).  What it computes
// is the same; the design is not the TPU kernel's one-hot matmul over
// visit tables and lane-packed pillar pairs:
//   * each warp owns a run of kSegsPerWarp consecutive segments and finds
//     where its points start and end by two binary searches over the sorted
//     ids, so there is no starts table and no second launch;
//   * the warp walks its points 32 ids at a time (one coalesced load, then
//     shuffles), its lanes across the channels (two per lane where C is
//     even: one bf16x2 per lane at C = 64), loading kUnroll rows ahead of
//     the sums so several loads are in flight;
//   * the fp32 sums stay in registers and each output row is written once
//     when the walk passes it, zeros included: no atomics, no zero-fill
//     pass, the same summation order on every run.
// Bound by bytes: reading vals and the ids once and writing the (V, C)
// output once (at the DHD-S `--what pool` shapes the output is 77% of it).
// A hot segment is walked by one warp: that warp is the tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegsPerWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;
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
__device__ __forceinline__ void load_add(const T* p, float* acc) {
  const AlignedChunk<T, VEC> c = *reinterpret_cast<const AlignedChunk<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] += to_f32(c.v[k]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float* acc) {
  AlignedChunk<T, VEC> c;
#pragma unroll
  for (int k = 0; k < VEC; ++k) c.v[k] = from_f32<T>(acc[k]);
  *reinterpret_cast<AlignedChunk<T, VEC>*>(p) = c;
}

// first index in seg[0, n) whose id is >= v
__device__ __forceinline__ int lower_bound(const int32_t* seg, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (seg[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename TI, typename TO, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sorted_segment_sum_kernel(const TI* __restrict__ vals,
                          const int32_t* __restrict__ seg,
                          const int32_t* __restrict__ order,
                          TO* __restrict__ out, int P, int C, int V) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int v0 = warp * kSegsPerWarp;
  if (v0 >= V) return;                          // warp-uniform
  const int v1 = min(v0 + kSegsPerWarp, V);
  int bound = 0;
  if (lane < 2) bound = lower_bound(seg, P, lane == 0 ? v0 : v1);
  const int p0 = __shfl_sync(kFull, bound, 0);  // points [p0, p1) have ids
  const int p1 = __shfl_sync(kFull, bound, 1);  // in [v0, v1)

  for (int c0 = 0; c0 < C; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < C;                  // C % VEC == 0
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    int cur = v0;                               // the row acc sums
    for (int base = p0; base < p1; base += 32) {
      const int n = min(32, p1 - base);
      int my_seg = 0, my_row = 0;
      if (lane < n) {
        my_seg = seg[base + lane];
        my_row = order != nullptr ? order[base + lane] : base + lane;
      }
      for (int j0 = 0; j0 < n; j0 += kUnroll) {
        float v[kUnroll][VEC];
        int s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[u] = __shfl_sync(kFull, my_seg, (j0 + u) & 31);
          const int row = __shfl_sync(kFull, my_row, (j0 + u) & 31);
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
          if (active && j0 + u < n)
            load_add<TI, VEC>(vals + static_cast<size_t>(row) * C + c, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j0 + u >= n) break;               // warp-uniform
          while (cur < s[u]) {                  // rows up to this point's
            if (active) store<TO, VEC>(out + static_cast<size_t>(cur) * C + c,
                                       acc);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
            ++cur;
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
        }
      }
    }
    while (cur < v1) {                          // the run's remaining rows
      if (active) store<TO, VEC>(out + static_cast<size_t>(cur) * C + c, acc);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      ++cur;
    }
  }
}

template <typename TI, typename TO>
int launch(const void* vals, const void* seg, const void* order, void* out,
           int P, int C, int V, int vec, void* stream) {
  const int n_warps = (V + kSegsPerWarp - 1) / kSegsPerWarp;
  const int blocks = (n_warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TI* v = static_cast<const TI*>(vals);
  const int32_t* s = static_cast<const int32_t*>(seg);
  const int32_t* o = static_cast<const int32_t*>(order);
  TO* y = static_cast<TO*>(out);
  if (vec == 2)
    sorted_segment_sum_kernel<TI, TO, 2>
        <<<blocks, kWarpsPerBlock * 32, 0, st>>>(v, s, o, y, P, C, V);
  else
    sorted_segment_sum_kernel<TI, TO, 1>
        <<<blocks, kWarpsPerBlock * 32, 0, st>>>(v, s, o, y, P, C, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals (P, C) and out (V, C) row-major; seg (P,) sorted; order (P,) or null.
// vec is 2 where C is even and vals and out are aligned to two elements.
#define SEGSUM_ENTRY(NAME, TI, TO)                                         \
  extern "C" int NAME(const void* vals, const void* seg, const void* order, \
                      void* out, int P, int C, int V, int vec,            \
                      void* stream) {                                     \
    return launch<TI, TO>(vals, seg, order, out, P, C, V, vec, stream);   \
  }

SEGSUM_ENTRY(segment_sum_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
SEGSUM_ENTRY(segment_sum_bf16_f32, __nv_bfloat16, float)
SEGSUM_ENTRY(segment_sum_f32_bf16, float, __nv_bfloat16)
SEGSUM_ENTRY(segment_sum_f32_f32, float, float)
