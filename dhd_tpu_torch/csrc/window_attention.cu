// Swin window attention for Hopper (sm_90a): for every window w and head h
// of the qkv Linear's output qkv (W, N, 3C), feature order [q|k|v] x [head]
// x [d] with hd = C / heads,
//
//   q_s   = round_T(q * scale)          (scale = hd^-1/2 rounded to T)
//   s     = q_s . k + bias[h] + mask[w % nW_img]             (fp32)
//   e     = exp(s - max_m s)
//   out   = (sum_m round_T(e_m) v_m) / (sum_m e_m)            (fp32 sums)
//
// written to out (W, N, C) in T: what dhd_tpu/ops/window_attention.py's
// _kernel and _kernel_v2 compute (lines 58-71).  One kernel replaces both:
// v2 only regrouped heads for the TPU's 128-wide matrix unit.
//
// Bound on an H100: bytes, W*N*8C in bf16 (qkv read once, out written
// once: 292 MB at DHD-L stage 0, 0.087 ms); the 4*N^2*hd flops per
// (window, head) take 0.021 ms there on the tensor cores.
//
// bf16 (the served path): window_attention_tc_kernel, one block of 9 warps
// per (window, head); the heads of one window are neighbouring blocks, so
// the window's qkv rows come from device memory once and then from L2.
//   * q_s, k and v of the head go to shared memory as bf16 with 16-byte
//     loads, rows padded with zeros to Np, a multiple of 16;
//   * each warp takes 16-row tiles of queries: S = q_s k^T with bf16
//     tensor-core products (wmma 16x16x16, fp32 sums) into a 16 x Np fp32
//     strip in shared memory; bias and mask rows come from L2 (the whole
//     (h, N, N) bias and (nW_img, N, N) mask stay there); the warp takes
//     four rows at a time (their loads and shuffle reductions overlap),
//     the max and the fp32 sum of e, and writes round_T(e) over the strip
//     as bf16; then O = P v on the tensor cores, divided by the sums.
// fp32 (the small CPU-checked configurations): window_attention_kernel,
// the same function on the CUDA cores: a block of 8 warps per (window,
// head), k and v in shared memory as fp32 (k rows padded to hd + 1 floats
// so 32 lanes reading one d of 32 keys hit 32 banks), a warp per query
// row, lane l scoring keys l + 32t, lane d accumulating out[d].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;       // fp32 kernel
constexpr int kThreads = kWarps * 32;
constexpr int kTcWarps = 9;     // bf16 kernel: a 16-row tile each at N = 144
constexpr int kRows = 4;        // bf16 kernel: rows softmaxed together
constexpr int kMaxSlices = 8;   // N <= 256 = 8 x 32 keys

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Two bf16 (little-endian: the low half first) times scale, each rounded
// to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t w, float scale) {
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(__uint_as_float(w << 16) * scale,
                            __uint_as_float(w & 0xffff0000u) * scale);
  return *reinterpret_cast<const uint32_t*>(&r);
}

size_t tc_smem_bytes(int Np, int HD) {
  return sizeof(bf16) * 3 * static_cast<size_t>(Np) * HD +
         sizeof(float) * (kTcWarps * 16 * static_cast<size_t>(Np) +
                          kTcWarps * 16);
}

// HD: head dim, 16 or 32; NT: 32-key slices a lane scores (N <= 32 NT).
// Np = N rounded up to 16, at most 256.
template <int HD, int NT>
__global__ void __launch_bounds__(kTcWarps * 32)
    window_attention_tc_kernel(const bf16* __restrict__ qkv,
                               const bf16* __restrict__ bias,
                               const bf16* __restrict__ mask,
                               bf16* __restrict__ out, int N, int C,
                               int heads, int n_mask, float scale) {
  constexpr int KT = HD / 16;  // 16-deep steps of q_s k^T
  constexpr int CH = HD / 8;   // 16-byte chunks in a head's row
  const int Np = (N + 15) & ~15;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // Np x HD each
  bf16* ks = qs + Np * HD;
  bf16* vs = ks + Np * HD;
  float* strips = reinterpret_cast<float*>(vs + Np * HD);  // 16 x Np each
  float* rowsums = strips + kTcWarps * 16 * Np;            // 16 each

  const int win = blockIdx.x / heads;
  const int h = blockIdx.x - win * heads;
  const size_t row_stride = 3 * static_cast<size_t>(C);
  const bf16* base = qkv + static_cast<size_t>(win) * N * row_stride + h * HD;

  for (int i = threadIdx.x; i < Np * CH; i += kTcWarps * 32) {
    const int key = i / CH;
    const int c8 = (i - key * CH) * 8;
    uint4 q = make_uint4(0, 0, 0, 0), k = q, v = q;
    if (key < N) {
      const bf16* r = base + key * row_stride + c8;
      q = *reinterpret_cast<const uint4*>(r);
      k = *reinterpret_cast<const uint4*>(r + C);
      v = *reinterpret_cast<const uint4*>(r + 2 * C);
      q = make_uint4(scale_pair(q.x, scale), scale_pair(q.y, scale),
                     scale_pair(q.z, scale), scale_pair(q.w, scale));
    }
    *reinterpret_cast<uint4*>(qs + key * HD + c8) = q;
    *reinterpret_cast<uint4*>(ks + key * HD + c8) = k;
    *reinterpret_cast<uint4*>(vs + key * HD + c8) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* S = strips + warp * 16 * Np;
  // P (bf16) is written over S, row r at S's row r: a stride of 2 Np
  bf16* P = reinterpret_cast<bf16*>(S);
  float* rsum = rowsums + warp * 16;
  const bf16* bias_h = bias + static_cast<size_t>(h) * N * N;
  const bf16* mask_w =
      n_mask > 0 ? mask + static_cast<size_t>(win % n_mask) * N * N : nullptr;
  bf16* out_w = out + static_cast<size_t>(win) * N * C + h * HD;

  for (int rt = warp; rt < Np / 16; rt += kTcWarps) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      wmma::load_matrix_sync(qa[kk], qs + rt * 16 * HD + kk * 16, HD);
    for (int ct = 0; ct < Np / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + ct * 16 * HD + kk * 16, HD);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(S + ct * 16, acc, Np, wmma::mem_row_major);
    }
    __syncwarp();

    // softmax of the strip, kRows rows at a time so that their loads and
    // shuffle reductions overlap
    for (int r0 = 0; r0 < 16; r0 += kRows) {
      float ev[kRows][NT];
      float m[kRows];
      float sum[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int row = rt * 16 + r0 + j;
        const float* srow = S + (r0 + j) * Np;
        const bf16* brow = bias_h + row * N;
        const bf16* mrow = mask_w != nullptr ? mask_w + row * N : nullptr;
        m[j] = -INFINITY;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int c = lane + 32 * t;
          ev[j][t] = -INFINITY;
          if (row < N && c < N) {
            float sc = srow[c] + __bfloat162float(brow[c]);
            if (mrow != nullptr) sc += __bfloat162float(mrow[c]);
            ev[j][t] = sc;
            m[j] = fmaxf(m[j], sc);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          m[j] = fmaxf(m[j], __shfl_xor_sync(0xffffffffu, m[j], off));
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        sum[j] = 0.f;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          // padded rows and keys: e = 0 (their max stays -inf)
          ev[j][t] = ev[j][t] > -INFINITY ? expf(ev[j][t] - m[j]) : 0.f;
          sum[j] += ev[j][t];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], off);
      }
      __syncwarp();  // these rows of S are read before P covers them
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        bf16* prow = P + (r0 + j) * 2 * Np;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int c = lane + 32 * t;
          if (c < Np) prow[c] = __float2bfloat16_rn(ev[j][t]);
        }
        // padded rows are never stored: any nonzero sum will do
        if (lane == 0) rsum[r0 + j] = sum[j] > 0.f ? sum[j] : 1.f;
      }
    }
    __syncwarp();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[KT];
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) wmma::fill_fragment(oacc[dt], 0.f);
    for (int kt = 0; kt < Np / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, P + kt * 16, 2 * Np);
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, vs + kt * 16 * HD + dt * 16, HD);
        wmma::mma_sync(oacc[dt], pa, vb, oacc[dt]);
      }
    }
    __syncwarp();  // P is read; O goes over it
#pragma unroll
    for (int dt = 0; dt < KT; ++dt)
      wmma::store_matrix_sync(S + dt * 16, oacc[dt], HD, wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = i / HD;
      const int d = i - r * HD;
      const int row = rt * 16 + r;
      if (row < N)
        out_w[static_cast<size_t>(row) * C + d] =
            __float2bfloat16_rn(S[r * HD + d] / rsum[r]);
    }
    __syncwarp();  // S is rewritten by the next row tile
  }
}

size_t smem_bytes(int N, int HD) {
  return sizeof(float) *
         (static_cast<size_t>(N) * (HD + 1) + static_cast<size_t>(N) * HD +
          kWarps * HD + kWarps * static_cast<size_t>(N));
}

// fp32.  HD: head dim (16 or 32); NT: 32-key slices a lane scores
// (N <= 32 * NT).
template <int HD, int NT>
__global__ void __launch_bounds__(kThreads)
    window_attention_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            float* __restrict__ out, int N, int C, int heads,
                            int n_mask, float scale) {
  constexpr int KS = HD + 1;
  constexpr int G = 32 / HD;  // key groups in the value product
  extern __shared__ float smem[];
  float* ks = smem;                  // N x KS
  float* vs = ks + N * KS;           // N x HD
  float* qbuf = vs + N * HD;         // kWarps x HD
  float* ebuf = qbuf + kWarps * HD;  // kWarps x N

  const int win = blockIdx.x / heads;
  const int h = blockIdx.x - win * heads;
  const size_t row_stride = 3 * static_cast<size_t>(C);
  const float* base = qkv + static_cast<size_t>(win) * N * row_stride + h * HD;

  for (int i = threadIdx.x; i < N * HD; i += kThreads) {
    const int key = i / HD;
    const int d = i - key * HD;
    const float* r = base + key * row_stride + d;
    ks[key * KS + d] = r[C];
    vs[i] = r[2 * C];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* bias_h = bias + static_cast<size_t>(h) * N * N;
  const float* mask_w =
      n_mask > 0 ? mask + static_cast<size_t>(win % n_mask) * N * N : nullptr;
  float* qw = qbuf + warp * HD;
  float* ew = ebuf + warp * N;
  const int d = lane % HD;
  const int g = lane / HD;
  float* out_w = out + static_cast<size_t>(win) * N * C + h * HD;

  for (int row = warp; row < N; row += kWarps) {
    if (lane < HD) qw[lane] = base[row * row_stride + lane] * scale;
    __syncwarp();
    float q[HD];
#pragma unroll
    for (int j = 0; j < HD; ++j) q[j] = qw[j];

    float s[NT];
    float m = -INFINITY;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int key = lane + 32 * t;
      s[t] = -INFINITY;
      if (key < N) {
        const float* kr = ks + key * KS;
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < HD; ++j) acc = fmaf(q[j], kr[j], acc);
        acc += bias_h[row * N + key];
        if (mask_w != nullptr) acc += mask_w[row * N + key];
        s[t] = acc;
        m = fmaxf(m, acc);
      }
    }
    m = warp_max(m);

    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int key = lane + 32 * t;
      if (key < N) {
        const float e = expf(s[t] - m);
        sum += e;
        ew[key] = e;
      }
    }
    sum = warp_sum(sum);
    __syncwarp();

    float o = 0.f;
    for (int key = g; key < N; key += G)
      o = fmaf(ew[key], vs[key * HD + d], o);
    if (G == 2) o += __shfl_xor_sync(0xffffffffu, o, 16);
    if (lane < HD) out_w[static_cast<size_t>(row) * C + lane] = o / sum;
    __syncwarp();  // qw and ew are rewritten for the next row
  }
}

// Raises the block's dynamic shared memory limit where it passes 48 KB.
template <typename K>
int allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int HD, int NT>
int launch_tc(const void* qkv, const void* bias, const void* mask, void* out,
              int W, int N, int C, int heads, int n_mask, float scale,
              cudaStream_t s) {
  const size_t smem = tc_smem_bytes((N + 15) & ~15, HD);
  auto kernel = window_attention_tc_kernel<HD, NT>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<W * heads, kTcWarps * 32, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(mask), static_cast<bf16*>(out), N, C, heads,
      n_mask, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_tc_hd(const void* qkv, const void* bias, const void* mask,
                 void* out, int W, int N, int C, int heads, int n_mask,
                 float scale, cudaStream_t s) {
  if (N <= 32)
    return launch_tc<HD, 1>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                            scale, s);
  if (N <= 64)
    return launch_tc<HD, 2>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                            scale, s);
  if (N <= 160)
    return launch_tc<HD, 5>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                            scale, s);
  return launch_tc<HD, 8>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                          scale, s);
}

template <int HD, int NT>
int launch_f32(const void* qkv, const void* bias, const void* mask, void* out,
               int W, int N, int C, int heads, int n_mask, float scale,
               cudaStream_t s) {
  const size_t smem = smem_bytes(N, HD);
  auto kernel = window_attention_kernel<HD, NT>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<W * heads, kThreads, smem, s>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(out), N, C, heads,
      n_mask, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32_hd(const void* qkv, const void* bias, const void* mask,
                  void* out, int W, int N, int C, int heads, int n_mask,
                  float scale, cudaStream_t s) {
  if (N <= 64)
    return launch_f32<HD, 2>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                             scale, s);
  if (N <= 160)
    return launch_f32<HD, 5>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                             scale, s);
  return launch_f32<HD, 8>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                           scale, s);
}

}  // namespace

extern "C" int window_attention_bf16(const void* qkv, const void* bias,
                                     const void* mask, void* out, int W,
                                     int N, int C, int heads, int n_mask,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 32 * kMaxSlices) return cudaErrorInvalidValue;
  if (C == 32 * heads)
    return launch_tc_hd<32>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                            scale, s);
  if (C == 16 * heads)
    return launch_tc_hd<16>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                            scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int window_attention_f32(const void* qkv, const void* bias,
                                    const void* mask, void* out, int W, int N,
                                    int C, int heads, int n_mask,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 32 * kMaxSlices) return cudaErrorInvalidValue;
  if (C == 32 * heads)
    return launch_f32_hd<32>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                             scale, s);
  if (C == 16 * heads)
    return launch_f32_hd<16>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                             scale, s);
  return cudaErrorInvalidValue;
}
