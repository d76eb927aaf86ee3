// Sorted segment-sum for Hopper (sm_90a):
//   out[v] = sum over i with seg[i] == v of vals[row(i)]   for v in [0, V)
// over points sorted by segment id, with row(i) = order[i] when an order is
// given (the kernel gathers the rows of unsorted values itself) and i
// otherwise.  Sums are fp32; ids < 0 or >= V contribute nothing; every
// output row is written, empty segments as exact zeros.
//
// Replaces dhd_tpu/ops/pallas_pool.py:_kernel (kernel B2).  What it computes
// is the same; the design is not the TPU kernel's one-hot matmul over
// visit tables and lane-packed pillar pairs.  It splits the work merge-path
// style (Merrill and Garland's CSR SpMV), so no segment is walked by one
// warp however many points it holds:
//   * the work is a merge of two lists, the P points and the V row ends:
//     point i comes before the end of row j when seg[i] <= j.  Each warp
//     takes about kItems consecutive items of that merge (its "share", the
//     same for every `order`) and finds where its share starts and ends,
//     in points and in rows, by two diagonal searches over the sorted ids,
//     one per half-warp at once (16 probes a step, one per lane);
//   * a share boundary that falls inside a row moves to the row's end when
//     the row ends within 15 points (one more 16-lane load): with ids
//     spread over the rows no row crosses a share, and only a long row is
//     split;
//   * the warp walks its share's points 32 ids at a time (one coalesced
//     load, the next 32 loaded meanwhile, then shuffles), its lanes across
//     the channels, VEC channels a lane (the wrapper takes the fewest
//     channel passes up to 4 channels a lane: one bf16x2 per lane at C =
//     64), loading 4 bf16 or 8 fp32 rows ahead of the sums; the fp32 sums
//     stay in registers;
//   * a row whose points and end lie in one share is written once by that
//     share, zeros included.  A row whose points cross shares is left to
//     the second pass: each share that holds its first points stores its
//     fp32 partial row as a "carry" (the share's last row), and the share
//     where the row ends stores its own as a "head" (the share's first
//     row);
//   * the second pass is a grid of a few warps a multiprocessor that scan
//     the shares for heads: each head's warp adds the row's carries
//     (several streams of them at small C) and then the head, and writes
//     the row.  It is a programmatic dependent launch (Hopper): its blocks
//     are scheduled while the first pass runs and wait for its end on the
//     device, so the second launch adds no launch gap.
// The partition depends on the ids alone, so the sums are taken in the
// same order on every run and for every `order`: no float atomics.
// Bound by bytes: reading vals and the ids once and writing the (V, C)
// output once (at the DHD-S `--what pool` shapes the output is 77% of it).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kItems = 48;  // points + row ends per warp's share
// rows loaded ahead of the sums and resident blocks per SM the registers
// must allow, by the type of the rows: bf16 rows go faster with more warps
// (8 blocks, 32 registers) and fewer rows each, fp32 rows the other way
template <typename TI> struct Tune;
template <> struct Tune<__nv_bfloat16> {
  static constexpr int kRows = 4, kBlocks = 8;
};
template <> struct Tune<float> {
  static constexpr int kRows = 8, kBlocks = 1;
};
constexpr int kFixupUnroll = 16;
constexpr int kFixupBlocks = 264;   // the second pass: 2 blocks an H100 SM
constexpr int kSnap = 15;           // a boundary moves past <= 15 points
static_assert(kItems > kSnap, "a moved boundary must stay in its share");
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

// Where a share starts and ends: i points and j = k - i row ends before
// its diagonal k, for k0 by lanes 0-15 and k1 by lanes 16-31.
//   * The split: the least i in [max(0, k - V), min(k, P)] with seg[i] >=
//     k - i (point i comes after the end of row k - i - 1), or min(k, P).
//     Every lane probes one point a step, and a ballot keeps the 1/16 of
//     the range that holds the answer.
//   * Row j is open at the split when point i - 1 is row j's (seg[i - 1]
//     == j < V).  If row j ends within kSnap points, the split moves past
//     them and past row j's end: (i, j) -> (first index with seg > j, j + 1).
//     Both shares at a boundary compute it from the same k, so they agree.
//   * A row still open is a carry out of the share before the boundary and
//     a carry into the share after it.
struct Bounds {
  int i0, j0, i1, j1;
  bool carry_in, carry_out;
};

__device__ __forceinline__ Bounds share_bounds(const int32_t* seg, int P,
                                               int V, long long k0,
                                               long long k1, int lane) {
  const int half = lane >> 4;
  const int l = lane & 15;
  const long long k = half ? k1 : k0;
  int lo = static_cast<int>(k - V > 0 ? k - V : 0);
  int hi = static_cast<int>(k < P ? k : P);
  while (__any_sync(kFull, lo < hi)) {
    const int span = hi - lo;
    bool after = true;
    if (span > 0) {
      const int probe = lo + static_cast<int>(
          (static_cast<long long>(span) * l) >> 4);
      after = seg[probe] >= k - probe;
    }
    const unsigned b = (__ballot_sync(kFull, after) >> (16 * half)) & 0xffffu;
    if (span > 0) {
      if (b == 0) {
        lo = lo + static_cast<int>((static_cast<long long>(span) * 15) >> 4)
             + 1;
      } else {
        const int f = __ffs(b) - 1;  // the first lane whose probe is after
        hi = lo + static_cast<int>((static_cast<long long>(span) * f) >> 4);
        if (f > 0)
          lo = lo + static_cast<int>(
                   (static_cast<long long>(span) * (f - 1)) >> 4) + 1;
      }
    }
  }
  int i = lo;
  int j = static_cast<int>(k - i);
  // seg[i - 1 + l]: lane 0 of the half tells whether row j is open, lanes
  // 1-15 where it ends (past P counts as ended)
  const int t = i - 1 + l;
  const int x = t < 0 ? -1 : t >= P ? 0x7fffffff : seg[t];
  const int x0 = __shfl_sync(kFull, x, 16 * half);   // every lane shuffles
  const bool open = j < V && x0 == j && i > 0;
  const unsigned ends =
      (__ballot_sync(kFull, l > 0 && x > j) >> (16 * half)) & 0xffffu;
  const bool snap = open && ends != 0;
  if (snap) {
    i = i - 1 + (__ffs(ends) - 1);
    j = j + 1;
  }
  const int carry = open && !snap;
  Bounds bd;
  bd.i0 = __shfl_sync(kFull, i, 0);
  bd.j0 = __shfl_sync(kFull, j, 0);
  bd.i1 = __shfl_sync(kFull, i, 16);
  bd.j1 = __shfl_sync(kFull, j, 16);
  bd.carry_in = __shfl_sync(kFull, carry, 0) != 0;
  bd.carry_out = __shfl_sync(kFull, carry, 16) != 0 && bd.i1 > bd.i0;
  return bd;
}

// rows[share] = {carry row, head row}: the row whose partial the share
// stored in carry / head, or -1.
template <typename TI, typename TO, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, Tune<TI>::kBlocks)
segment_sum_share_kernel(const TI* __restrict__ vals,
                         const int32_t* __restrict__ seg,
                         const int32_t* __restrict__ order,
                         TO* __restrict__ out, float* __restrict__ carry,
                         float* __restrict__ head, int2* __restrict__ rows,
                         int P, int C, int V, int n_shares) {
  // the second pass may be scheduled now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;");
  constexpr int kUnroll = Tune<TI>::kRows;
  const int lane = threadIdx.x & 31;
  const int share = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (share >= n_shares) return;                // warp-uniform
  const long long total = static_cast<long long>(P) + V;
  const long long k0 = static_cast<long long>(share) * kItems;
  const long long k1 = k0 + kItems < total ? k0 + kItems : total;
  // points [i0, i1) and the ends of rows [j0, j1); the share's first row
  // began in an earlier share (its sum is a head) / its last row goes on
  // in a later one (its sum is a carry)
  const Bounds bd = share_bounds(seg, P, V, k0, k1, lane);
  const int i0 = bd.i0, j0 = bd.j0, i1 = bd.i1, j1 = bd.j1;
  const bool carry_in = bd.carry_in, carry_out = bd.carry_out;
  if (lane == 0)
    rows[share] = make_int2(carry_out ? j1 : -1,
                            carry_in && j0 < j1 ? j0 : -1);
  if (j0 >= V) return;                          // dropped ids only

  for (int c0 = 0; c0 < C; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool active = c < C;                  // C % VEC == 0
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    int cur = j0;                               // the row acc sums
    // row cur ends: written, or kept as the head for the second pass
    auto flush = [&]() {
      if (active) {
        if (cur == j0 && carry_in) {
          store<float, VEC>(head + static_cast<size_t>(share) * C + c, acc);
        } else {
          store<TO, VEC>(out + static_cast<size_t>(cur) * C + c, acc);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      ++cur;
    };
    // the ids and rows of the next 32 points, loaded a chunk ahead
    int next_seg = -1, next_row = 0;
    if (i0 + lane < i1) {
      next_seg = seg[i0 + lane];
      next_row = order != nullptr ? order[i0 + lane] : i0 + lane;
    }
    for (int base = i0; base < i1; base += 32) {
      const int n = min(32, i1 - base);
      const int my_seg = next_seg;
      const int my_row = next_row;
      if (base + 32 + lane < i1) {
        next_seg = seg[base + 32 + lane];
        next_row = order != nullptr ? order[base + 32 + lane]
                                    : base + 32 + lane;
      }
      for (int j = 0; j < n; j += kUnroll) {
        float v[kUnroll][VEC];
        int s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[u] = __shfl_sync(kFull, my_seg, (j + u) & 31);
          const int row = __shfl_sync(kFull, my_row, (j + u) & 31);
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
          if (active && j + u < n && s[u] >= 0 && s[u] < V)
            load_add<TI, VEC>(vals + static_cast<size_t>(row) * C + c, v[u]);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (j + u >= n) break;                // warp-uniform
          while (cur < s[u] && cur < j1) flush();
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
        }
      }
    }
    while (cur < j1) flush();                   // the share's remaining ends
    if (carry_out && active)
      store<float, VEC>(carry + static_cast<size_t>(share) * C + c, acc);
  }
}

// The first of the shares just before `share` whose carry row is r (they
// are contiguous): one look at the 32 before it, else a 32-ary search.
__device__ __forceinline__ int first_carry(const int2* rows, int share, int r,
                                           int lane) {
  const int t = share - 1 - lane;
  const unsigned stop = __ballot_sync(kFull, !(t >= 0 && rows[t].x == r));
  if (stop != 0) return share - (__ffs(stop) - 1);
  int lo = 0, hi = share - 32;                  // the answer is in [lo, hi]
  while (lo < hi) {
    const long long span = hi - lo;
    const int probe = lo + static_cast<int>((span * lane) >> 5);
    const unsigned b = __ballot_sync(kFull, rows[probe].x == r);
    if (b == 0) {
      lo += static_cast<int>((span * 31) >> 5) + 1;
    } else {
      const int f = __ffs(b) - 1;
      hi = lo + static_cast<int>((span * f) >> 5);
      if (f > 0) lo += static_cast<int>((span * (f - 1)) >> 5) + 1;
    }
  }
  return lo;
}

// The second pass: each warp scans 32 shares at a time for heads.  For a
// head, the row's carries in share order, then the head, rounded once into
// out.  A row of C fp32 is read by 2^lpr_log2 lanes, FV floats each (16
// bytes where C % 4 == 0), and the warp's 32 >> lpr_log2 lane groups take
// every (32 >> lpr_log2)-th carry: a hot row's hundreds of carries are read
// by several streams with 16 loads each in flight (one partial sum each),
// then the streams' sums meet in a butterfly (the same sums in every lane,
// and on every run).
template <typename TO, int FV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_fixup_kernel(TO* __restrict__ out,
                         const float* __restrict__ carry,
                         const float* __restrict__ head,
                         const int2* __restrict__ rows, int C, int n_shares,
                         int lpr_log2) {
  // launched while the first pass runs: wait for its end and its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lanes = 1 << lpr_log2;              // lanes per row
  const int streams = 32 >> lpr_log2;
  const int stream = lane >> lpr_log2;
  for (int base = warp * 32; base < n_shares;
       base += gridDim.x * kWarpsPerBlock * 32) {
    const int my_head = base + lane < n_shares ? rows[base + lane].y : -1;
    unsigned todo = __ballot_sync(kFull, my_head >= 0);
    while (todo != 0) {
      const int l = __ffs(todo) - 1;
      todo &= todo - 1;
      const int share = base + l;
      const int r = __shfl_sync(kFull, my_head, l);
      const int first = first_carry(rows, share, r, lane);
      for (int c0 = 0; c0 < C; c0 += lanes * FV) {
        const int c = c0 + (lane & (lanes - 1)) * FV;
        const bool active = c < C;              // C % FV == 0
        // one sum per load slot, so all kFixupUnroll loads are in flight
        float part[kFixupUnroll][FV];
#pragma unroll
        for (int u = 0; u < kFixupUnroll; ++u)
#pragma unroll
          for (int k = 0; k < FV; ++k) part[u][k] = 0.f;
        for (int t = first + stream; t < share;
             t += streams * kFixupUnroll) {
#pragma unroll
          for (int u = 0; u < kFixupUnroll; ++u) {
            const int ts = t + u * streams;
            if (active && ts < share)
              load_add<float, FV>(carry + static_cast<size_t>(ts) * C + c,
                                  part[u]);
          }
        }
        float acc[FV];
#pragma unroll
        for (int k = 0; k < FV; ++k) {
          acc[k] = 0.f;
#pragma unroll
          for (int u = 0; u < kFixupUnroll; ++u) acc[k] += part[u][k];
        }
        for (int off = 16; off >= lanes; off >>= 1) {
#pragma unroll
          for (int k = 0; k < FV; ++k)
            acc[k] += __shfl_xor_sync(kFull, acc[k], off);
        }
        if (stream == 0 && active) {
          load_add<float, FV>(head + static_cast<size_t>(share) * C + c, acc);
          store<TO, FV>(out + static_cast<size_t>(r) * C + c, acc);
        }
      }
    }
  }
}

template <typename TI, typename TO, int VEC>
int launch_vec(const TI* v, const int32_t* s, const int32_t* o, TO* y,
               float* carry, float* head, int2* rows, int P, int C, int V,
               int n_shares, cudaStream_t st) {
  const int blocks = (n_shares + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_sum_share_kernel<TI, TO, VEC>
      <<<blocks, kWarpsPerBlock * 32, 0, st>>>(v, s, o, y, carry, head, rows,
                                               P, C, V, n_shares);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  const int scan_blocks = (n_shares + 32 * kWarpsPerBlock - 1) /
                          (32 * kWarpsPerBlock);
  cfg.gridDim = dim3(scan_blocks < kFixupBlocks ? scan_blocks : kFixupBlocks);
  cfg.blockDim = dim3(kWarpsPerBlock * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the second pass reads fp32 rows: 16 bytes a lane where C allows
  const int fv = C % 4 == 0 ? 4 : 1;
  int lpr_log2 = 0;
  while (lpr_log2 < 5 && (fv << lpr_log2) < C) ++lpr_log2;
  const float* cc = carry;
  const float* hc = head;
  const int2* rc = rows;
  return static_cast<int>(
      fv == 4 ? cudaLaunchKernelEx(&cfg, segment_sum_fixup_kernel<TO, 4>, y,
                                   cc, hc, rc, C, n_shares, lpr_log2)
              : cudaLaunchKernelEx(&cfg, segment_sum_fixup_kernel<TO, 1>, y,
                                   cc, hc, rc, C, n_shares, lpr_log2));
}

template <typename TI, typename TO>
int launch(const void* vals, const void* seg, const void* order, void* out,
           void* scratch, int P, int C, int V, int vec, void* stream) {
  const int n_shares = static_cast<int>(
      (static_cast<long long>(P) + V + kItems - 1) / kItems);
  // scratch: carry and head rows (n_shares x C fp32 each), then rows
  float* carry = static_cast<float*>(scratch);
  float* head = carry + static_cast<size_t>(n_shares) * C;
  int2* rows = reinterpret_cast<int2*>(head + static_cast<size_t>(n_shares) * C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TI* v = static_cast<const TI*>(vals);
  const int32_t* s = static_cast<const int32_t*>(seg);
  const int32_t* o = static_cast<const int32_t*>(order);
  TO* y = static_cast<TO*>(out);
#define SEGSUM_LAUNCH(VEC)                                                  \
  launch_vec<TI, TO, VEC>(v, s, o, y, carry, head, rows, P, C, V, n_shares, \
                          st)
  switch (vec) {
    case 1: return SEGSUM_LAUNCH(1);
    case 2: return SEGSUM_LAUNCH(2);
    case 4: return SEGSUM_LAUNCH(4);
  }
#undef SEGSUM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Items (points + row ends) per share: the wrapper sizes the scratch for
// ceil((P + V) / items) shares, 2 * C fp32 and one int2 each.
extern "C" int segment_sum_items() { return kItems; }

// vals (P, C) and out (V, C) row-major; seg (P,) sorted; order (P,) or null;
// scratch as segment_sum_items says, 16-byte aligned.  vec (1, 2 or 4)
// divides C, and vals and out are aligned to vec elements.
#define SEGSUM_ENTRY(NAME, TI, TO)                                         \
  extern "C" int NAME(const void* vals, const void* seg, const void* order, \
                      void* out, void* scratch, int P, int C, int V,       \
                      int vec, void* stream) {                             \
    return launch<TI, TO>(vals, seg, order, out, scratch, P, C, V, vec,    \
                          stream);                                         \
  }

SEGSUM_ENTRY(segment_sum_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
SEGSUM_ENTRY(segment_sum_bf16_f32, __nv_bfloat16, float)
SEGSUM_ENTRY(segment_sum_f32_bf16, float, __nv_bfloat16)
SEGSUM_ENTRY(segment_sum_f32_f32, float, float)
