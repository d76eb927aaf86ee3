// Stereo matching cost volume for Hopper (sm_90a): for every camera bn,
// depth bin d and stereo pixel (h, w),
//
//   cost[bn, d, h, w] = sum_c |curr[bn, h, w, c] - warp_c| (+ bias where
//                       warp_0 == 0),
//   warp_c = bilinear sample of prev[bn, :, :, c] at (uf, vf)[bn, d, h, w],
//
// zero-padded, align_corners=True: taps (floor(u) + {0, 1}, floor(v) +
// {0, 1}) outside [0, Ws) x [0, Hs) read zero; the plan's far sentinel
// (-1e4) puts every tap outside.  A sample is "invalid", and gets +bias,
// where the warped channel 0 is exactly 0.0 (the reference's quirk,
// model_utils/depthnet.py:354-356): valid samples whose channel 0 is an
// exact zero (common after a ReLU) get it too.
//
// Replaces dhd_tpu/ops/cost_volume_pallas.py:_kernel.  The TPU kernel
// reformulated the warp as MXU matmuls over row windows of a transposed,
// VMEM-resident prev map; none of that carries over.
//
// Bound on an H100: operations, about 11 fp32 flops per valid sample and
// channel (DHD-M: 6 x 88 x 64 x 176 samples of C = 256, 16.7 GFLOP, 0.25 ms
// at 67 TFLOP/s) against 140 MB of traffic (0.04 ms).  The time follows the
// fixed cost of a sample (its plan loads, tap addresses, the dependent tap
// gathers and the reduction across lanes), so the design cuts that:
//   * a pixel's channel row is held by G = C/8 lanes in bf16 (C/4 in fp32;
//     up to 32, then two 16-byte chunks a lane), so no lane idles at any
//     C: two pixels a warp at C = 128, one at 256, 32 at 8;
//   * a block of 256 threads covers a compact tile of pixels (8 wide, or 16
//     for 128 and more) and sweeps the depth bins in lock-step, kBatch at a
//     time: the tile's neighbouring pixels gather neighbouring taps of the
//     same bin together, so most taps hit in L1;
//   * the plan of a batch is loaded by coalesced loads over consecutive w
//     (into registers while the previous batch computes), and each sample
//     is formed once, by one thread, into shared memory: its four bilinear
//     weights, zeroed for taps off the image, and its tap offset; the G
//     lanes of its pixel read them as broadcasts;
//   * each lane issues the tap gathers of the next depth bin before it sums
//     the current one (two register stages), and the registers are capped
//     so that kMinBlocks blocks fit an SM: latency is hidden by both;
//   * a tap is read only where its weight is not 0; a sample with every
//     tap off costs no gather: its sum is the lane's sum of |curr|,
//     computed once;
//   * the costs of a batch meet in shared memory and leave as coalesced
//     rows over w.
// The arithmetic is fp32 from fp32-upcast taps; lane 0 of a pixel's group
// holds channel 0 and adds the bias to its partial where warp_0 is 0, so the
// result differs from the plain version only in the order of the fp32 sums
// (the bias included) and in fp32 contractions.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // depth bins per staged plan batch
constexpr int kMinBlocks = 4;  // resident blocks per SM the registers allow
constexpr unsigned kFull = 0xffffffffu;
constexpr float kSentinel = -1e4f;

template <typename T> struct Chunk;  // elements in one 16-byte load
template <> struct Chunk<float> { static constexpr int V = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int V = 8; };

// One sample's taps: the offset of its top-left tap row (in elements) and
// the four bilinear weights, 0 for a tap off the image.  A tap is read only
// where its weight is not 0 (a tap on the image with weight 0 adds 0 all
// the same).
struct Sample {
  int off;
  float w[4];  // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
};

__device__ __forceinline__ Sample make_sample(float u, float v, int Hs,
                                              int Ws, int C) {
  const float x0f = floorf(u);
  const float y0f = floorf(v);
  const float wx = u - x0f;
  const float wy = v - y0f;
  // clamping to [-2, W] keeps each tap's in/out-of-image verdict and the
  // int conversion in range (the sentinel is -1e4)
  const int x0 = static_cast<int>(fmaxf(fminf(x0f, float(Ws)), -2.f));
  const int y0 = static_cast<int>(fmaxf(fminf(y0f, float(Hs)), -2.f));
  const float ax0 = x0 >= 0 && x0 < Ws ? 1.f - wx : 0.f;
  const float ax1 = x0 + 1 >= 0 && x0 + 1 < Ws ? wx : 0.f;
  const float ay0 = y0 >= 0 && y0 < Hs ? 1.f - wy : 0.f;
  const float ay1 = y0 + 1 >= 0 && y0 + 1 < Hs ? wy : 0.f;
  Sample s;
  s.w[0] = ay0 * ax0;
  s.w[1] = ay0 * ax1;
  s.w[2] = ay1 * ax0;
  s.w[3] = ay1 * ax1;
  s.off = (y0 * Ws + x0) * C;
  return s;
}

// element e of a 16-byte chunk, as fp32
template <typename T>
__device__ __forceinline__ float elem(const uint4& a, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& a, int e) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  return __uint_as_float(w[e]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& a, int e) {
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
  // little-endian: element 2k is the low half of word k
  return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
}

// G lanes per pixel (a power of two, at most 32), NCH 16-byte chunks of the
// channel row per lane.
template <typename T, int G, int NCH>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cost_volume_kernel(const T* __restrict__ prev, const T* __restrict__ curr,
                   const float* __restrict__ uf, const float* __restrict__ vf,
                   float* __restrict__ cost, int D, int Hs, int Ws, int C,
                   int tiles_w, int tiles_h, float bias) {
  constexpr int V = Chunk<T>::V;
  constexpr int PB = kThreads / G;            // pixels per block
  constexpr int TW = PB >= 128 ? 16 : 8;      // tile width (w)
  constexpr int TH = PB / TW;                 // tile height (h)
  constexpr int kPlan = kBatch * PB;          // samples of one batch
  constexpr int kPerThread = (kPlan + kThreads - 1) / kThreads;

  __shared__ float4 s_w[kBatch][PB];          // a batch's samples: weights
  __shared__ int s_off[kBatch][PB];           // and top-left tap offsets
  __shared__ float s_cost[kBatch][PB];

  int blk = blockIdx.x;
  const int tile_w = blk % tiles_w;
  blk /= tiles_w;
  const int tile_h = blk % tiles_h;
  const int bn = blk / tiles_h;
  const int px = threadIdx.x / G;             // this lane's pixel
  const int g = threadIdx.x % G;              // lane within the pixel group
  const int h = tile_h * TH + px / TW;
  const int w = tile_w * TW + px % TW;
  const bool valid = h < Hs && w < Ws;
  const int hw = Hs * Ws;
  const int n_chunks = C / V;

  float cur[NCH][V];
  float abs_sum = 0.f;  // sum of |curr| over the lane's channels
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int j = g + G * k;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (valid && j < n_chunks)
      raw = __ldg(reinterpret_cast<const uint4*>(
          curr + (static_cast<size_t>(bn) * hw + h * Ws + w) * C + j * V));
#pragma unroll
    for (int e = 0; e < V; ++e) {
      cur[k][e] = elem<T>(raw, e);
      abs_sum += fabsf(cur[k][e]);
    }
  }
  const T* src = prev + static_cast<size_t>(bn) * hw * C;
  const size_t plane0 = static_cast<size_t>(bn) * D * hw;

  // the plan of one batch: thread t loads samples t, t + 256, ... (their
  // uf and vf over consecutive w) and forms them once for all the lanes
  float u_reg[kPerThread], v_reg[kPerThread];
  auto load_plan = [&](int d0) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int i = threadIdx.x + e * kThreads;
      const int b = i / PB;
      const int p = i % PB;
      const int hh = tile_h * TH + p / TW;
      const int ww = tile_w * TW + p % TW;
      u_reg[e] = v_reg[e] = kSentinel;
      if (i < kPlan && d0 + b < D && hh < Hs && ww < Ws) {
        const size_t o = plane0 + static_cast<size_t>(d0 + b) * hw +
                         hh * Ws + ww;
        u_reg[e] = __ldg(uf + o);
        v_reg[e] = __ldg(vf + o);
      }
    }
  };

  // two register stages of one bin's sample and taps
  uint4 taps[2][NCH][4];
  Sample smp[2];
  auto gather = [&](int buf, int bin) {
    const float4 wq = s_w[bin][px];
    const Sample sm = {s_off[bin][px], {wq.x, wq.y, wq.z, wq.w}};
    smp[buf] = sm;
    const T* r0 = src + sm.off;
    const int tap_off[4] = {0, C, Ws * C, Ws * C + C};
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int j = g + G * k;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        taps[buf][k][q] =
            j < n_chunks && sm.w[q] != 0.f
                ? __ldg(reinterpret_cast<const uint4*>(r0 + tap_off[q] +
                                                       j * V))
                : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // a bin's sum across the group, stored to s_cost
  auto reduce_store = [&](int buf, int bin) {
    const Sample& sm = smp[buf];
    float a = 0.f;
    float warp0 = 0.f;
    if (sm.w[0] != 0.f || sm.w[1] != 0.f || sm.w[2] != 0.f ||
        sm.w[3] != 0.f) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float wv = fmaf(
              elem<T>(taps[buf][k][3], e), sm.w[3],
              fmaf(elem<T>(taps[buf][k][2], e), sm.w[2],
                   fmaf(elem<T>(taps[buf][k][1], e), sm.w[1],
                        elem<T>(taps[buf][k][0], e) * sm.w[0])));
          if (k == 0 && e == 0) warp0 = wv;
          a += fabsf(cur[k][e] - wv);
        }
      }
    } else {
      a = abs_sum;  // every tap off: |curr - 0|, the same sums
    }
    // lane 0 of the group holds channel 0
    if (g == 0 && warp0 == 0.f) a += bias;
#pragma unroll
    for (int off = G >> 1; off > 0; off >>= 1)
      a += __shfl_xor_sync(kFull, a, off);
    if (g == 0) s_cost[bin][px] = a;
  };

  load_plan(0);
  for (int d0 = 0; d0 < D; d0 += kBatch) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i < kPlan) {
        const Sample sm = make_sample(u_reg[e], v_reg[e], Hs, Ws, C);
        (&s_w[0][0])[i] = make_float4(sm.w[0], sm.w[1], sm.w[2], sm.w[3]);
        (&s_off[0][0])[i] = sm.off;
      }
    }
    __syncthreads();
    if (d0 + kBatch < D) load_plan(d0 + kBatch);  // in flight meanwhile
    gather(0, 0);
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      if (s + 1 < kBatch) gather((s + 1) & 1, s + 1);
      reduce_store(s & 1, s);
    }
    __syncthreads();
    // the batch's costs: rows of the tile over consecutive w
    for (int i = threadIdx.x; i < kBatch * PB; i += kThreads) {
      const int b = i / PB;
      const int p = i % PB;
      const int hh = tile_h * TH + p / TW;
      const int ww = tile_w * TW + p % TW;
      if (d0 + b < D && hh < Hs && ww < Ws)
        cost[plane0 + static_cast<size_t>(d0 + b) * hw + hh * Ws + ww] =
            s_cost[b][p];
    }
    // the next batch's sample stores come after this barrier's readers;
    // its s_cost stores after the next barrier
  }
}

template <typename T, int G, int NCH>
int launch_g(const T* p, const T* c, const float* u, const float* v,
             float* out, int BN, int D, int Hs, int Ws, int C, float bias,
             cudaStream_t s) {
  constexpr int PB = kThreads / G;
  constexpr int TW = PB >= 128 ? 16 : 8;
  constexpr int TH = PB / TW;
  const int tiles_w = (Ws + TW - 1) / TW;
  const int tiles_h = (Hs + TH - 1) / TH;
  const long long blocks = static_cast<long long>(BN) * tiles_w * tiles_h;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cost_volume_kernel<T, G, NCH><<<static_cast<int>(blocks), kThreads, 0, s>>>(
      p, c, u, v, out, D, Hs, Ws, C, tiles_w, tiles_h, bias);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* prev, const void* curr, const void* uf, const void* vf,
           void* cost, int BN, int D, int Hs, int Ws, int C, float bias,
           void* stream) {
  const int chunks = C / Chunk<T>::V;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(prev);
  const T* c = static_cast<const T*>(curr);
  const float* u = static_cast<const float*>(uf);
  const float* v = static_cast<const float*>(vf);
  float* out = static_cast<float*>(cost);
#define CV_LAUNCH(G, NCH) \
  launch_g<T, G, NCH>(p, c, u, v, out, BN, D, Hs, Ws, C, bias, s)
  if (chunks <= 1) return CV_LAUNCH(1, 1);
  if (chunks <= 2) return CV_LAUNCH(2, 1);
  if (chunks <= 4) return CV_LAUNCH(4, 1);
  if (chunks <= 8) return CV_LAUNCH(8, 1);
  if (chunks <= 16) return CV_LAUNCH(16, 1);
  if (chunks <= 32) return CV_LAUNCH(32, 1);
  if (chunks <= 64) return CV_LAUNCH(32, 2);
#undef CV_LAUNCH
  // C > 512 (bf16) or > 256 (fp32): no preset has it
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// prev, curr (BN, Hs, Ws, C) channels-last; uf, vf, cost (BN, D, Hs, Ws).
extern "C" int stereo_cost_bf16(const void* prev, const void* curr,
                                const void* uf, const void* vf, void* cost,
                                int BN, int D, int Hs, int Ws, int C,
                                float bias, void* stream) {
  return launch<__nv_bfloat16>(prev, curr, uf, vf, cost, BN, D, Hs, Ws, C,
                               bias, stream);
}

extern "C" int stereo_cost_f32(const void* prev, const void* curr,
                               const void* uf, const void* vf, void* cost,
                               int BN, int D, int Hs, int Ws, int C,
                               float bias, void* stream) {
  return launch<float>(prev, curr, uf, vf, cost, BN, D, Hs, Ws, C, bias,
                       stream);
}
