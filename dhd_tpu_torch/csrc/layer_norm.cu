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
//
// Two more instantiations of the same kernel carry a Swin block's data
// movement (nn/swin.py:SwinBlock), each row's arithmetic unchanged:
//   * kWindows, norm1 in window order: output row r of the (B * nW * ws^2,
//     C) window tensor is the LayerNorm of the token at the padded,
//     cyclically shifted position window partition puts there, or exact
//     zeros where that position is padding (the pad comes after norm1);
//   * kResidual, the window reverse, the attention residual and norm2:
//     for token t, s = x[t] + proj[inv(t)] (the add in fp32, rounded to T,
//     as PyTorch's add), written to the residual stream, and the
//     LayerNorm of s.
// The row maps are window_partition / window_reverse with the shift and
// the crop (nn/swin.py:_window_perms), computed per row with divisions by
// a multiply and a shift (Div).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 0;      // y[r] = LN(x[r])
constexpr int kWindows = 1;   // y[r] = LN(x[src(r)]) or 0 (padding)
constexpr int kResidual = 2;  // s[t] = x[t] + p[inv(t)], y[t] = LN(s[t])

template <typename T> struct Chunk;  // elements in one 16-byte load
template <> struct Chunk<float> { static constexpr int V = 4; };
template <> struct Chunk<__nv_bfloat16> { static constexpr int V = 8; };

// n / d for 0 <= n < 2^31: (umulhi(n, m) + n) >> s, with s the least
// shift where 2^s >= d and m = 2^32 (2^s - d) / d + 1 (fits in 32 bits).
struct Div {
  uint32_t m, s;
  __device__ __forceinline__ int div(int n) const {
    const uint32_t u = static_cast<uint32_t>(n);
    return static_cast<int>((__umulhi(u, m) + u) >> s);
  }
};

Div make_div(int d) {
  uint32_t s = 0;
  while ((1ull << s) < static_cast<uint64_t>(d)) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return Div{static_cast<uint32_t>(m), s};
}

// A Swin block's map of h x w tokens a image into windows of ws x ws over
// the padded hp x wp map, cyclically shifted by `shift`: nw_w windows a
// row of windows, n_win = ws * ws tokens a window.
struct RowMap {
  const void* p;  // kResidual: the window tensor added to x
  void* sum;      // kResidual: where s is written
  int h, w, hp, wp, ws, shift, nw_w, n_win;
  Div img;        // kWindows: hp * wp rows a image; kResidual: h * w
  Div win;        // kWindows: n_win
  Div wrow;       // kWindows: nw_w; kResidual: w
  Div wsd;        // ws
};

// kWindows: the token of x that window row r holds, or -1 for padding.
__device__ __forceinline__ int window_source(int r, const RowMap& m) {
  const int b = m.img.div(r);
  const int q = r - b * m.hp * m.wp;
  const int widx = m.win.div(q);
  const int n = q - widx * m.n_win;
  const int wi = m.wrow.div(widx);
  const int wj = widx - wi * m.nw_w;
  const int pi = m.wsd.div(n);
  const int pj = n - pi * m.ws;
  int si = wi * m.ws + pi + m.shift;
  int sj = wj * m.ws + pj + m.shift;
  if (si >= m.hp) si -= m.hp;
  if (sj >= m.wp) sj -= m.wp;
  return si < m.h && sj < m.w ? (b * m.h + si) * m.w + sj : -1;
}

// kResidual: the window row that token t came back from.
__device__ __forceinline__ int window_target(int t, const RowMap& m) {
  const int b = m.img.div(t);
  const int k = t - b * m.h * m.w;
  const int i = m.wrow.div(k);
  const int j = k - i * m.w;
  int ri = i - m.shift;
  int rj = j - m.shift;
  if (ri < 0) ri += m.hp;
  if (rj < 0) rj += m.wp;
  const int wi = m.wsd.div(ri);
  const int wj = m.wsd.div(rj);
  return b * m.hp * m.wp + (wi * m.nw_w + wj) * m.n_win
         + (ri - wi * m.ws) * m.ws + (rj - wj * m.ws);
}

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

// a + b in fp32, rounded to T: PyTorch's add of two T tensors
__device__ __forceinline__ float add_round(float a, float b, float) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float add_round(float a, float b,
                                           __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, b)));
}

// LPR: lanes per row (16 to 256); NCH: the most chunks a lane holds;
// MAP: kRows, kWindows or kResidual (`map` unused by kRows).
template <typename T, int LPR, int NCH, int MAP>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const T* __restrict__ x,
                      const float* __restrict__ weight,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int rows, int C, float eps, RowMap map) {
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

  const T* p = static_cast<const T*>(map.p);
  // row r's chunks into dst (kResidual: and its window row's into dst_p);
  // false where kWindows maps r to padding (dst then zeros)
  auto load_row = [&](int r, uint4 (&dst)[NCH], uint4 (&dst_p)[NCH]) {
    int src = r;
    if constexpr (MAP == kWindows) src = r < rows ? window_source(r, map) : -1;
    const bool live = r < rows && src >= 0;
    const T* xr = x + static_cast<size_t>(live ? src : 0) * C;
#pragma unroll
    for (int k = 0; k < NCH; ++k)
      dst[k] = live && has[k]
                   ? *reinterpret_cast<const uint4*>(xr + (l + LPR * k) * V)
                   : make_uint4(0, 0, 0, 0);
    if constexpr (MAP == kResidual) {
      const T* pr =
          p + static_cast<size_t>(live ? window_target(r, map) : 0) * C;
#pragma unroll
      for (int k = 0; k < NCH; ++k)
        dst_p[k] = live && has[k] ? *reinterpret_cast<const uint4*>(
                                        pr + (l + LPR * k) * V)
                                  : make_uint4(0, 0, 0, 0);
    }
    return live;
  };

  const int step = gridDim.x * R;
  uint4 cur[NCH], nxt[NCH], cur_p[NCH], nxt_p[NCH];
  bool cur_live = load_row(blockIdx.x * R + sub, cur, cur_p);
  // every thread of the block takes the same number of steps: the
  // shuffles and the barrier need all of them
  for (int base = blockIdx.x * R, it = 0; base < rows; base += step, ++it) {
    const int r = base + sub;
    const bool nxt_live = load_row(r + step, nxt, nxt_p);

    float v[NCH][V];
    float s = 0.f;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      unpack(cur[k], v[k], T());
      if constexpr (MAP == kResidual) {
        float pv[V];
        unpack(cur_p[k], pv, T());
#pragma unroll
        for (int e = 0; e < V; ++e) v[k][e] = add_round(v[k][e], pv[e], T());
      }
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
        const float2 pp = slot[sub * WPR + i];
        s += pp.x;
        ss += pp.y;
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
          if constexpr (MAP == kWindows) {  // padding stays exact zeros
            if (!cur_live) {
#pragma unroll
              for (int e = 0; e < V; ++e) o[e] = 0.f;
            }
          }
          store_chunk(yr + (l + LPR * k) * V, o);
          if constexpr (MAP == kResidual)
            store_chunk(static_cast<T*>(map.sum) + static_cast<size_t>(r) * C
                            + (l + LPR * k) * V,
                        v[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      cur[k] = nxt[k];
      if constexpr (MAP == kResidual) cur_p[k] = nxt_p[k];
    }
    cur_live = nxt_live;
  }
}

constexpr int kMaxDevices = 64;

// Blocks of the persistent grid: as many as are resident on the current
// device at once, and no more than the row steps.
template <typename T, int LPR, int NCH, int MAP>
int launch_one(const void* x, const void* w, const void* b, void* y,
               int rows, int C, float eps, const RowMap& map,
               cudaStream_t s) {
  static int resident[kMaxDevices] = {};  // per instantiation and device
  auto kernel = layer_norm_kernel<T, LPR, NCH, MAP>;
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
      static_cast<const float*>(b), static_cast<T*>(y), rows, C, eps, map);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MAP>
int launch(const void* x, const void* w, const void* b, void* y, int rows,
           int C, float eps, const RowMap& map, void* stream) {
  const int chunks = C / Chunk<T>::V;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks <= 16)
    return launch_one<T, 16, 1, MAP>(x, w, b, y, rows, C, eps, map, s);
  if (chunks <= 32)
    return launch_one<T, 32, 1, MAP>(x, w, b, y, rows, C, eps, map, s);
  if (chunks <= 64)
    return launch_one<T, 64, 1, MAP>(x, w, b, y, rows, C, eps, map, s);
  if (chunks <= 128)
    return launch_one<T, 128, 1, MAP>(x, w, b, y, rows, C, eps, map, s);
  if (chunks <= 256)
    return launch_one<T, 256, 1, MAP>(x, w, b, y, rows, C, eps, map, s);
  if constexpr (Chunk<T>::V == 4) {  // fp32 up to C = 2048
    if (chunks <= 512)
      return launch_one<T, 256, 2, MAP>(x, w, b, y, rows, C, eps, map, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The map of `images` images of h x w tokens into windows of ws x ws,
// shifted by `shift`; false where a size is out of range.
bool make_map(int images, int h, int w, int ws, int shift, RowMap* m) {
  if (images <= 0 || h <= 0 || w <= 0 || ws <= 0 || shift < 0 ||
      shift >= ws)
    return false;
  m->h = h, m->w = w, m->ws = ws, m->shift = shift;
  m->hp = (h + ws - 1) / ws * ws;
  m->wp = (w + ws - 1) / ws * ws;
  m->nw_w = m->wp / ws;
  m->n_win = ws * ws;
  m->win = make_div(m->n_win);
  m->wsd = make_div(ws);
  return true;
}

template <typename T>
int windows(const void* x, const void* w, const void* b, void* y,
            int images, int C, float eps, int h, int wd, int ws, int shift,
            void* stream) {
  RowMap m{};
  if (!make_map(images, h, wd, ws, shift, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  m.img = make_div(m.hp * m.wp);
  m.wrow = make_div(m.nw_w);
  return launch<T, kWindows>(x, w, b, y, images * m.hp * m.wp, C, eps, m,
                             stream);
}

template <typename T>
int residual(const void* x, const void* p, const void* w, const void* b,
             void* sum, void* y, int images, int C, float eps, int h, int wd,
             int ws, int shift, void* stream) {
  RowMap m{};
  if (!make_map(images, h, wd, ws, shift, &m))
    return static_cast<int>(cudaErrorInvalidValue);
  m.p = p;
  m.sum = sum;
  m.img = make_div(h * wd);
  m.wrow = make_div(wd);
  return launch<T, kResidual>(x, w, b, y, images * h * wd, C, eps, m,
                              stream);
}

}  // namespace

extern "C" int layer_norm_bf16(const void* x, const void* weight,
                               const void* bias, void* y, int rows, int C,
                               float eps, void* stream) {
  return launch<__nv_bfloat16, kRows>(x, weight, bias, y, rows, C, eps,
                                      RowMap{}, stream);
}

extern "C" int layer_norm_f32(const void* x, const void* weight,
                              const void* bias, void* y, int rows, int C,
                              float eps, void* stream) {
  return launch<float, kRows>(x, weight, bias, y, rows, C, eps, RowMap{},
                              stream);
}

extern "C" int layer_norm_windows_bf16(const void* x, const void* weight,
                                       const void* bias, void* y, int images,
                                       int C, float eps, int h, int w, int ws,
                                       int shift, void* stream) {
  return windows<__nv_bfloat16>(x, weight, bias, y, images, C, eps, h, w, ws,
                                shift, stream);
}

extern "C" int layer_norm_windows_f32(const void* x, const void* weight,
                                      const void* bias, void* y, int images,
                                      int C, float eps, int h, int w, int ws,
                                      int shift, void* stream) {
  return windows<float>(x, weight, bias, y, images, C, eps, h, w, ws, shift,
                        stream);
}

extern "C" int layer_norm_residual_bf16(const void* x, const void* p,
                                        const void* weight, const void* bias,
                                        void* sum, void* y, int images, int C,
                                        float eps, int h, int w, int ws,
                                        int shift, void* stream) {
  return residual<__nv_bfloat16>(x, p, weight, bias, sum, y, images, C, eps,
                                 h, w, ws, shift, stream);
}

extern "C" int layer_norm_residual_f32(const void* x, const void* p,
                                       const void* weight, const void* bias,
                                       void* sum, void* y, int images, int C,
                                       float eps, int h, int w, int ws,
                                       int shift, void* stream) {
  return residual<float>(x, p, weight, bias, sum, y, images, C, eps, h, w,
                         ws, shift, stream);
}
