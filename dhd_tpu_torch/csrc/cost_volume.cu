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
// VMEM-resident prev map; none of that carries over.  Here:
//   * one warp per (bn, h, w) pixel, 8 pixels (consecutive w) per block;
//   * each lane holds its 16-byte chunks of curr's channel row (C/32 of
//     the channels) in registers for the whole depth sweep;
//   * for each d the lanes gather the 4 taps' contiguous channel rows of
//     prev with 16-byte loads; a camera's prev (5.8 MB at DHD-M in bf16)
//     stays in L2, and neighbouring pixels share taps in L1;
//   * |curr - warp| is summed in fp32 from fp32 taps, reduced across the
//     warp with shuffles, and lane 0 (which holds channel 0) writes the
//     cost, so the channel-0 test sees the fp32 tap sum.
// Bound on an H100 at DHD-M (BN=6, D=88, 64x176, C=256): operations, about
// 11 fp32 flops per sample and channel (16.7 GFLOP, 0.25 ms at 67 TFLOP/s)
// against 140 MB of traffic (0.04 ms).  This first version issues far more
// instructions than that count (address math, bf16 unpacking, the
// shuffle reduction per depth bin).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T> struct Chunk;  // elements in one 16-byte load
template <> struct Chunk<float> { static constexpr int V = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int V = 8; };

__device__ __forceinline__ void load_chunk(const float* p, float* out) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // little-endian: element 2k is the low half
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// NCH: the most 16-byte chunks of a channel row one lane holds.
template <typename T, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    cost_volume_kernel(const T* __restrict__ prev, const T* __restrict__ curr,
                       const float* __restrict__ uf,
                       const float* __restrict__ vf, float* __restrict__ cost,
                       int n_pix, int D, int Hs, int Ws, int C, float bias) {
  constexpr int V = Chunk<T>::V;
  const int lane = threadIdx.x & 31;
  const int pix = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= n_pix) return;  // whole warps leave together
  const int hw = Hs * Ws;
  const int bn = pix / hw;
  const int p = pix - bn * hw;
  const int n_chunks = C / V;

  float cur[NCH][V];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int j = lane + 32 * k;
    if (j < n_chunks) {
      load_chunk(curr + static_cast<size_t>(pix) * C + j * V, cur[k]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) cur[k][e] = 0.f;
    }
  }

  const T* src = prev + static_cast<size_t>(bn) * hw * C;
  const size_t base = static_cast<size_t>(bn) * D * hw + p;
  for (int d = 0; d < D; ++d) {
    const size_t o = base + static_cast<size_t>(d) * hw;
    const float u = __ldg(uf + o);
    const float v = __ldg(vf + o);
    const float x0f = floorf(u);
    const float y0f = floorf(v);
    const float wx = u - x0f;
    const float wy = v - y0f;
    // clamping to [-2, W] keeps each tap's in/out-of-image verdict and the
    // int conversion in range (the sentinel is -1e4)
    const int x0 = static_cast<int>(fmaxf(fminf(x0f, float(Ws)), -2.f));
    const int y0 = static_cast<int>(fmaxf(fminf(y0f, float(Hs)), -2.f));
    const bool vx0 = x0 >= 0 && x0 < Ws;
    const bool vx1 = x0 + 1 >= 0 && x0 + 1 < Ws;
    const bool vy0 = y0 >= 0 && y0 < Hs;
    const bool vy1 = y0 + 1 >= 0 && y0 + 1 < Hs;
    const float ax0 = vx0 ? 1.f - wx : 0.f;
    const float ax1 = vx1 ? wx : 0.f;
    const float ay0 = vy0 ? 1.f - wy : 0.f;
    const float ay1 = vy1 ? wy : 0.f;
    // row pointers of the taps; read only where the tap is in the image
    const T* r00 = src + static_cast<ptrdiff_t>(y0 * Ws + x0) * C;
    const T* r10 = r00 + static_cast<ptrdiff_t>(Ws) * C;

    float acc = 0.f;
    float warp0 = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int j = lane + 32 * k;
      if (j >= n_chunks) break;
      float t00[V], t01[V], t10[V], t11[V];
#pragma unroll
      for (int e = 0; e < V; ++e) t00[e] = t01[e] = t10[e] = t11[e] = 0.f;
      if (vy0 && vx0) load_chunk(r00 + j * V, t00);
      if (vy0 && vx1) load_chunk(r00 + C + j * V, t01);
      if (vy1 && vx0) load_chunk(r10 + j * V, t10);
      if (vy1 && vx1) load_chunk(r10 + C + j * V, t11);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float top = t00[e] * ax0 + t01[e] * ax1;
        const float bot = t10[e] * ax0 + t11[e] * ax1;
        const float w = top * ay0 + bot * ay1;
        if (k == 0 && e == 0) warp0 = w;
        acc += fabsf(cur[k][e] - w);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) cost[o] = warp0 == 0.f ? acc + bias : acc;
  }
}

template <typename T>
int launch(const void* prev, const void* curr, const void* uf, const void* vf,
           void* cost, int n_pix, int D, int Hs, int Ws, int C, float bias,
           void* stream) {
  const int lanes_chunks = (C / Chunk<T>::V + 31) / 32;
  const dim3 grid((n_pix + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* p = static_cast<const T*>(prev);
  const T* c = static_cast<const T*>(curr);
  const float* u = static_cast<const float*>(uf);
  const float* v = static_cast<const float*>(vf);
  float* out = static_cast<float*>(cost);
  if (lanes_chunks <= 1) {
    cost_volume_kernel<T, 1><<<grid, block, 0, s>>>(p, c, u, v, out, n_pix,
                                                    D, Hs, Ws, C, bias);
  } else if (lanes_chunks <= 2) {
    cost_volume_kernel<T, 2><<<grid, block, 0, s>>>(p, c, u, v, out, n_pix,
                                                    D, Hs, Ws, C, bias);
  } else {  // C > 512 (bf16) or > 256 (fp32): no preset has it
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stereo_cost_bf16(const void* prev, const void* curr,
                                const void* uf, const void* vf, void* cost,
                                int n_pix, int D, int Hs, int Ws, int C,
                                float bias, void* stream) {
  return launch<__nv_bfloat16>(prev, curr, uf, vf, cost, n_pix, D, Hs, Ws, C,
                               bias, stream);
}

extern "C" int stereo_cost_f32(const void* prev, const void* curr,
                               const void* uf, const void* vf, void* cost,
                               int n_pix, int D, int Hs, int Ws, int C,
                               float bias, void* stream) {
  return launch<float>(prev, curr, uf, vf, cost, n_pix, D, Hs, Ws, C, bias,
                       stream);
}
