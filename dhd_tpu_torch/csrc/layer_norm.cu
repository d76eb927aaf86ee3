// One-pass LayerNorm over the last axis for Hopper (sm_90a): for every row
// r of x (rows, C),
//
//   mu  = sum_c x / C,   var = max(sum_c x^2 / C - mu^2, 0)   (fp32)
//   y   = (x - mu) * (rsqrt(var + eps) * weight) + bias,       cast to T,
//
// with fp32 weight and bias: the JAX package's FusedLayerNorm
// (dhd_tpu/nn/swin.py:126-131), op for op.
//
// Replaces dhd_tpu/ops/layer_norm.py:_ln_kernel, which streamed
// (block_r, C) row tiles through VMEM.  Here:
//   * one warp per row, 8 rows per block;
//   * each lane loads its 16-byte chunks of the row (C/32 of the row) once
//     and keeps them in registers for the statistics and the write, so x
//     is read once and y written once;
//   * the fp32 sums of x and x^2 are reduced across the warp with
//     shuffles; weight and bias (fp32, a few KB) come through the
//     read-only cache.
// Bound on an H100: bytes.  A Swin-B LN reads and writes its rows once in
// bf16 (stage 2, 16,896 x 512: 34.6 MB, 0.010 ms at 3.35 TB/s); about 8
// flops per element are far below the compute roof.  At C = 128 only half
// of a warp's lanes hold a chunk.
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
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = a.z;
  out[3] = a.w;
}

__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // little-endian: element 2k is the low half
    out[2 * k] = __uint_as_float(w[k] << 16);
    out[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store_chunk(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p,
                                            const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// NCH: the most 16-byte chunks of a row one lane holds.
template <typename T, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    layer_norm_kernel(const T* __restrict__ x,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int rows, int C, float eps) {
  constexpr int V = Chunk<T>::V;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together
  const int n_chunks = C / V;
  const T* xr = x + static_cast<size_t>(row) * C;
  T* yr = y + static_cast<size_t>(row) * C;

  float v[NCH][V];
  float s = 0.f;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int j = lane + 32 * k;
    if (j < n_chunks) {
      load_chunk(xr + j * V, v[k]);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s += v[k][e];
        ss += v[k][e] * v[k][e];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  // the plain version's op order, each op rounded on its own (no fused
  // multiply-adds): where (x - mu) * mul cancels against bias, a fused
  // product would move the result by whole bf16 ulps of a tiny output
  const float inv_c = 1.f / static_cast<float>(C);
  const float mu = __fmul_rn(s, inv_c);
  const float var =
      fmaxf(__fsub_rn(__fmul_rn(ss, inv_c), __fmul_rn(mu, mu)), 0.f);
  const float rs = rsqrtf(__fadd_rn(var, eps));

#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int j = lane + 32 * k;
    if (j < n_chunks) {
      float w[V], b[V], o[V];
#pragma unroll
      for (int e = 0; e < V; e += 4) {
        load_chunk(weight + j * V + e, w + e);
        load_chunk(bias + j * V + e, b + e);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float mul = __fmul_rn(rs, w[e]);
        o[e] = __fadd_rn(__fmul_rn(__fsub_rn(v[k][e], mu), mul), b[e]);
      }
      store_chunk(yr + j * V, o);
    }
  }
}

template <typename T, int NCH>
void launch_one(const void* x, const void* w, const void* b, void* y,
                int rows, int C, float eps, cudaStream_t s) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  layer_norm_kernel<T, NCH><<<grid, kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), rows, C, eps);
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int C, float eps, void* stream) {
  const int lanes_chunks = (C / Chunk<T>::V + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes_chunks <= 1) {
    launch_one<T, 1>(x, w, b, y, rows, C, eps, s);
  } else if (lanes_chunks <= 2) {
    launch_one<T, 2>(x, w, b, y, rows, C, eps, s);
  } else if (lanes_chunks <= 4) {
    launch_one<T, 4>(x, w, b, y, rows, C, eps, s);
  } else if (lanes_chunks <= 8) {
    launch_one<T, 8>(x, w, b, y, rows, C, eps, s);
  } else {  // C > 2048 in bf16 or > 1024 in fp32
    if constexpr (Chunk<T>::V == 4) {
      if (lanes_chunks <= 16) {
        launch_one<T, 16>(x, w, b, y, rows, C, eps, s);
        return static_cast<int>(cudaGetLastError());
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int layer_norm_bf16(const void* x, const void* weight,
                               const void* bias, void* y, int rows, int C,
                               float eps, void* stream) {
  return launch<__nv_bfloat16>(x, weight, bias, y, rows, C, eps, stream);
}

extern "C" int layer_norm_f32(const void* x, const void* weight,
                              const void* bias, void* y, int rows, int C,
                              float eps, void* stream) {
  return launch<float>(x, weight, bias, y, rows, C, eps, stream);
}
