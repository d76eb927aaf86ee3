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
// (block_r, C) row tiles through VMEM with weight and bias resident
// (index map (0, 0)).  Bound on an H100: bytes.  A Swin-B LN reads and
// writes its rows once in bf16 (stage 2, 16,896 x 512: 34.6 MB, 0.010 ms
// at 3.35 TB/s); about 8 flops per element are far below the compute roof.
// The design keeps every lane's loads busy:
//   * persistent blocks of 256 threads (as many as fit on the card) walk
//     the rows, kThreads / LPR rows per step;
//   * a row has LPR lanes, lane l holding the 16-byte chunks l + LPR k of
//     the row (one chunk at every bf16 C the presets reach): two rows per
//     warp at C = 128, a warp per row up to C = 256, 2-8 warps per row
//     from C = 512 to 2048;
//   * each lane loads its chunks' weight and bias once, into registers,
//     for the whole walk;
//   * the next row's chunks are loaded before the current row is reduced,
//     so one row's load latency hides behind the other's reduction;
//   * the fp32 sums of x and x^2 are reduced with shuffles among the LPR
//     lanes and, past 32 lanes, across the row's warps through shared
//     memory (two slots by step parity: one barrier a step), in a fixed
//     order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> struct Chunk;  // elements in one 16-byte load
template <> struct Chunk<float> { static constexpr int V = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int V = 8; };

__device__ __forceinline__ void unpack(const uint4& a, float* out, float) {
  out[0] = __uint_as_float(a.x);
  out[1] = __uint_as_float(a.y);
  out[2] = __uint_as_float(a.z);
  out[3] = __uint_as_float(a.w);
}

__device__ __forceinline__ void unpack(const uint4& a, float* out,
                                       __nv_bfloat16) {
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

// LPR: lanes per row (16 to 256); NCH: the most chunks a lane holds.
template <typename T, int LPR, int NCH>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const T* __restrict__ x,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int rows, int C, float eps) {
  constexpr int V = Chunk<T>::V;
  constexpr int R = kThreads / LPR;  // rows per step
  constexpr int WPR = LPR / 32;      // warps per row, past 32 lanes
  __shared__ float2 partial[2][kWarps];
  const int sub = threadIdx.x / LPR;
  const int l = threadIdx.x - sub * LPR;
  const int n_chunks = C / V;

  bool has[NCH];
  float w[NCH][V], b[NCH][V];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int j = l + LPR * k;
    has[k] = j < n_chunks;
#pragma unroll
    for (int e = 0; e < V; e += 4) {
      const float4 wv = has[k] ? *reinterpret_cast<const float4*>(
                                     weight + j * V + e)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 bv = has[k] ? *reinterpret_cast<const float4*>(
                                     bias + j * V + e)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      w[k][e] = wv.x, w[k][e + 1] = wv.y, w[k][e + 2] = wv.z,
      w[k][e + 3] = wv.w;
      b[k][e] = bv.x, b[k][e + 1] = bv.y, b[k][e + 2] = bv.z,
      b[k][e + 3] = bv.w;
    }
  }

  auto load_row = [&](int r, uint4 (&dst)[NCH]) {
    const T* xr = x + static_cast<size_t>(r) * C;
#pragma unroll
    for (int k = 0; k < NCH; ++k)
      dst[k] = r < rows && has[k]
                   ? *reinterpret_cast<const uint4*>(xr + (l + LPR * k) * V)
                   : make_uint4(0, 0, 0, 0);
  };

  const int step = gridDim.x * R;
  uint4 cur[NCH], nxt[NCH];
  load_row(blockIdx.x * R + sub, cur);
  // every thread of the block takes the same number of steps: the
  // shuffles and the barrier need all of them
  for (int base = blockIdx.x * R, it = 0; base < rows; base += step, ++it) {
    const int r = base + sub;
    load_row(r + step, nxt);

    float v[NCH][V];
    float s = 0.f;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      unpack(cur[k], v[k], T());
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s += v[k][e];
        ss += v[k][e] * v[k][e];
      }
    }
#pragma unroll
    for (int off = (LPR < 32 ? LPR : 32) / 2; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if constexpr (WPR > 1) {
      float2* slot = partial[it & 1];
      if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = make_float2(s, ss);
      __syncthreads();
      s = ss = 0.f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) {
        const float2 p = slot[sub * WPR + i];
        s += p.x;
        ss += p.y;
      }
    }
    // the plain version's op order, each op rounded on its own (no fused
    // multiply-adds): where (x - mu) * mul cancels against bias, a fused
    // product would move the result by whole bf16 ulps of a tiny output
    const float inv_c = 1.f / static_cast<float>(C);
    const float mu = __fmul_rn(s, inv_c);
    const float var =
        fmaxf(__fsub_rn(__fmul_rn(ss, inv_c), __fmul_rn(mu, mu)), 0.f);
    const float rs = rsqrtf(__fadd_rn(var, eps));

    if (r < rows) {
      T* yr = y + static_cast<size_t>(r) * C;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        if (has[k]) {
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float mul = __fmul_rn(rs, w[k][e]);
            o[e] = __fadd_rn(__fmul_rn(__fsub_rn(v[k][e], mu), mul), b[k][e]);
          }
          store_chunk(yr + (l + LPR * k) * V, o);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) cur[k] = nxt[k];
  }
}

constexpr int kMaxDevices = 64;

// Blocks of the persistent grid: as many as are resident on the current
// device at once, and no more than the row steps.
template <typename T, int LPR, int NCH>
int launch_one(const void* x, const void* w, const void* b, void* y,
               int rows, int C, float eps, cudaStream_t s) {
  static int resident[kMaxDevices] = {};  // per instantiation and device
  auto kernel = layer_norm_kernel<T, LPR, NCH>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] <= 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms * per_sm <= 0)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  constexpr int R = kThreads / LPR;
  const long long steps = (static_cast<long long>(rows) + R - 1) / R;
  const int grid =
      static_cast<int>(steps < resident[dev] ? steps : resident[dev]);
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<T*>(y), rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int C, float eps, void* stream) {
  const int chunks = C / Chunk<T>::V;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks <= 16) return launch_one<T, 16, 1>(x, w, b, y, rows, C, eps, s);
  if (chunks <= 32) return launch_one<T, 32, 1>(x, w, b, y, rows, C, eps, s);
  if (chunks <= 64) return launch_one<T, 64, 1>(x, w, b, y, rows, C, eps, s);
  if (chunks <= 128)
    return launch_one<T, 128, 1>(x, w, b, y, rows, C, eps, s);
  if (chunks <= 256)
    return launch_one<T, 256, 1>(x, w, b, y, rows, C, eps, s);
  if constexpr (Chunk<T>::V == 4) {  // fp32 up to C = 2048
    if (chunks <= 512)
      return launch_one<T, 256, 2>(x, w, b, y, rows, C, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
