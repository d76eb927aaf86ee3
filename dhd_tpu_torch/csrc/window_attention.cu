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
// (window, head) take 0.021 ms there on the tensor cores.  Beside the
// bytes, each (window, head) reads an N x N bias and mask (41 KB each at
// N = 144 in bf16) against 27.6 KB of qkv: those must come from L1/L2.
//
// bf16 (the served path): window_attention_mma_kernel, FlashAttention-2
// style, with the whole key row in registers (N <= 256):
//   * a block takes one (head, window) pair, pairs head-major so that
//     neighbouring blocks read one head's bias rows, and Np/16 warps
//     (Np = N rounded up to 16; 8 warps of two row tiles each at Np =
//     256);
//   * q, k and v of the pair reach shared memory by cp.async (16-byte
//     pieces, rows past N zero-filled); the block waits for them and then
//     computes.  The two blocks an SM holds at N = 144 (96 registers a
//     thread) overlap one's copies with the other's products.  Rows are
//     padded to hd + 8 elements so that ldmatrix's eight 16-byte rows fall
//     in eight distinct bank groups;
//   * each warp owns 16 query rows and every key: S = q_s k^T with
//     mma.sync m16n8k16 (bf16 in, fp32 sums) from ldmatrix operands,
//     2Np/8 n8 tiles of fp32 in registers (72 values at N = 144).  No
//     score strip exists: shared memory holds only q, k and v;
//   * bias and mask come from L1/L2 straight into the accumulator
//     layout.  k and v sit in shared memory in the key order of key_of,
//     which makes a lane's accumulator columns 8 contiguous keys of each
//     32: one 16-byte load per row and 32 keys, at N = 144 five loads
//     per row (the last of 8 bytes) for the bias and five for the mask;
//   * the row max and the sum of e are reduced across the 4 lanes of a
//     quad; e = 2^(s log2 e - max log2 e) (ex2.approx, 2 fp32 ulps);
//     round_T(e) is packed in place into the A operand of P v, the
//     accumulator layout of S being the A layout of the next product;
//   * O / sum is written as bf16 pairs straight from the accumulators.
// wgmma is not used: its 64-row warpgroup tiles would pad N = 144 to 192
// rows (25% more work), it needs the k/v tiles in its own shared-memory
// layout, and the kernel is bound by bytes and latency, not by the
// tensor cores (0.021 of the 0.087 ms at stage 0).
//
// fp32 (the small CPU-checked configurations): window_attention_kernel,
// the same function on the CUDA cores: a block of 8 warps per (window,
// head), k and v in shared memory as fp32 (k rows padded to hd + 1 floats
// so 32 lanes reading one d of 32 keys hit 32 banks), a warp per query
// row, lane l scoring keys l + 32t, lane d accumulating out[d].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;       // fp32 kernel
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSlices = 8;   // N <= 256 = 8 x 32 keys
constexpr int kPad = 8;         // bf16 kernel: padding of a shared row

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !full.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until every committed copy has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The key in shared row n of k and v (Np = 16 nk keys).  The order makes
// the keys behind a lane's accumulator columns contiguous: column n of
// S = q_s k^T is n8 tile n / 8, lane t holding columns 2t, 2t + 1 of each
// tile.  In a block of 32 keys (four tiles) lane t's eight columns are
// keys 8t .. 8t + 7, one 16-byte piece of a bias or mask row; in a last
// block of 16 keys, keys 4t .. 4t + 3, 8 bytes.  Permuting the keys of k
// and v together changes only the order of the sums over keys.
__device__ __forceinline__ int key_of(int n, int nk) {
  if ((n >> 5) * 2 + 1 < nk) {
    const int w = n & 31;
    return (n & ~31) + ((w >> 1) & 3) * 8 + (w >> 3) * 2 + (w & 1);
  }
  const int w = n & 15;
  return (n & ~15) + ((w >> 1) & 3) * 4 + (w >> 3) * 2 + (w & 1);
}

// s += row r0 (accumulator elements 0, 1) and row r1 (2, 3) of an N x N
// bias or mask in the key order of key_of, for lane t.  vec: N % 8 == 0
// and the matrix 16-byte aligned, so every piece is a whole load, wholly
// inside or wholly past N.
template <int NK>
__device__ __forceinline__ void add_rows(float (&s)[2 * NK][4],
                                         const bf16* __restrict__ r0,
                                         const bf16* __restrict__ r1, int t,
                                         int nk, int N, bool vec) {
#pragma unroll
  for (int b = 0; b < (NK + 1) / 2; ++b) {
    if (2 * b + 1 < nk) {  // 32 keys: s[4b + i] holds keys 8t + 2i, + 1
      const int k0 = 32 * b + 8 * t;
      uint32_t w0[4] = {0, 0, 0, 0}, w1[4] = {0, 0, 0, 0};
      if (vec) {
        if (k0 < N) {
          const uint4 a = __ldg(reinterpret_cast<const uint4*>(r0 + k0));
          const uint4 c = __ldg(reinterpret_cast<const uint4*>(r1 + k0));
          w0[0] = a.x, w0[1] = a.y, w0[2] = a.z, w0[3] = a.w;
          w1[0] = c.x, w1[1] = c.y, w1[2] = c.z, w1[3] = c.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = k0 + e;
          const uint32_t x0 = k < N ? __bfloat16_as_ushort(r0[k]) : 0u;
          const uint32_t x1 = k < N ? __bfloat16_as_ushort(r1[k]) : 0u;
          w0[e >> 1] |= x0 << (16 * (e & 1));
          w1[e >> 1] |= x1 << (16 * (e & 1));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[4 * b + i][0] += bf16_lo(w0[i]);
        s[4 * b + i][1] += bf16_hi(w0[i]);
        s[4 * b + i][2] += bf16_lo(w1[i]);
        s[4 * b + i][3] += bf16_hi(w1[i]);
      }
    } else if (2 * b + 1 == nk) {  // the last 16 keys: keys 4t + 2i, + 1
      const int k0 = 32 * b + 4 * t;
      uint32_t w0[2] = {0, 0}, w1[2] = {0, 0};
      if (vec) {
        if (k0 < N) {
          const uint2 a = __ldg(reinterpret_cast<const uint2*>(r0 + k0));
          const uint2 c = __ldg(reinterpret_cast<const uint2*>(r1 + k0));
          w0[0] = a.x, w0[1] = a.y;
          w1[0] = c.x, w1[1] = c.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + e;
          const uint32_t x0 = k < N ? __bfloat16_as_ushort(r0[k]) : 0u;
          const uint32_t x1 = k < N ? __bfloat16_as_ushort(r1[k]) : 0u;
          w0[e >> 1] |= x0 << (16 * (e & 1));
          w1[e >> 1] |= x1 << (16 * (e & 1));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        s[4 * b + i][0] += bf16_lo(w0[i]);
        s[4 * b + i][1] += bf16_hi(w0[i]);
        s[4 * b + i][2] += bf16_lo(w1[i]);
        s[4 * b + i][3] += bf16_hi(w1[i]);
      }
    }
  }
}

// NK: the most 16-key (and 16-row) tiles, Np / 16 <= NK.
template <int NK>
struct MmaShape {
  static constexpr int kWarps = NK <= 9 ? NK : (NK + 1) / 2;
  static constexpr int kMinBlocks = NK <= 4 ? 4 : (NK <= 9 ? 2 : 1);
};

template <int HD, int NK>
__global__ void __launch_bounds__(MmaShape<NK>::kWarps * 32,
                                  MmaShape<NK>::kMinBlocks)
    window_attention_mma_kernel(const bf16* __restrict__ qkv,
                                const bf16* __restrict__ bias,
                                const bf16* __restrict__ mask,
                                bf16* __restrict__ out, int W, int N, int C,
                                int n_mask, int vec, float scale) {
  constexpr int WARPS = MmaShape<NK>::kWarps;
  constexpr int RS = HD + kPad;  // shared row stride, elements
  constexpr int CH = HD / 8;     // 16-byte pieces of a head's row
  constexpr int KS = HD / 16;    // 16-deep steps of q_s k^T
  constexpr int DT = HD / 8;     // n8 tiles of the output
  const int Np = (N + 15) & ~15;
  const int nk = Np / 16;
  extern __shared__ __align__(128) unsigned char smem_mma[];
  bf16* qs = reinterpret_cast<bf16*>(smem_mma);  // [q|k|v][Np][RS]
  bf16* ks = qs + Np * RS;
  bf16* vs = ks + Np * RS;

  const size_t row_stride = 3 * static_cast<size_t>(C);
  const int h = blockIdx.x / W;
  const int win = blockIdx.x - h * W;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8)
  const int t = lane & 3;   // accumulator column pair
  constexpr float kLog2e = 1.4426950408889634f;

  // q, k, v of the pair: consecutive threads take consecutive 16-byte
  // pieces of one token's q | k | v; shared row n of k and v holds key
  // key_of(n)
  {
    const bf16* base = qkv + static_cast<size_t>(win) * N * row_stride +
                       h * HD;
    for (int i = threadIdx.x; i < Np * 3 * CH; i += WARPS * 32) {
      const int n = i / (3 * CH);
      const int rem = i - n * 3 * CH;
      const int part = rem / CH;
      const int c8 = (rem - part * CH) * 8;
      const int row = part == 0 ? n : key_of(n, nk);
      const bool in = row < N;
      cp_async16(smem_u32(qs + (part * Np + n) * RS + c8),
                 base + (in ? row : 0) * row_stride + part * C + c8, in);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }

  const bf16* bias_h = bias + static_cast<size_t>(h) * N * N;
  const bf16* mask_w =
      n_mask > 0 ? mask + static_cast<size_t>(win % n_mask) * N * N
                 : nullptr;
  bf16* out_w = out + static_cast<size_t>(win) * N * C + h * HD;

  for (int rt = warp; rt < nk; rt += WARPS) {
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(qa[kk],
                  smem_u32(qs + (rt * 16 + (lane & 7) + (lane & 8)) * RS +
                           kk * 16 + (lane >> 4) * 8));
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[kk][r] = scale_pair(qa[kk][r], scale);
    }

    float s[2 * NK][4];
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NK; ++j2) {
      if (j2 < nk) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4(kb, smem_u32(ks + (j2 * 16 + (lane & 7) +
                                         ((lane >> 4) << 3)) * RS +
                                   kk * 16 + (lane & 8)));
          mma_bf16(s[2 * j2], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * j2 + 1], qa[kk], kb[2], kb[3]);
        }
      }
    }

    // s + bias, + mask, in that order; keys past N (and tiles past Np)
    // get -inf, so e = 0 there
    const int r0 = rt * 16 + g;
    const int r1 = r0 + 8;
    const bool in0 = r0 < N, in1 = r1 < N;
    const size_t o0 = static_cast<size_t>(in0 ? r0 : 0) * N;
    const size_t o1 = static_cast<size_t>(in1 ? r1 : 0) * N;
    add_rows<NK>(s, bias_h + o0, bias_h + o1, t, nk, N, vec != 0);
    if (mask_w != nullptr)
      add_rows<NK>(s, mask_w + o0, mask_w + o1, t, nk, N, vec != 0);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      const int n = j * 8 + 2 * t;
      if (j >= 2 * nk || key_of(n, nk) >= N) s[j][0] = s[j][2] = -INFINITY;
      if (j >= 2 * nk || key_of(n + 1, nk) >= N)
        s[j][1] = s[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // e = exp(s - max) = 2^(s log2 e - max log2 e)
    const float ml0 = mx0 * kLog2e, ml1 = mx1 * kLog2e;
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], kLog2e, -ml0));
      s[j][1] = ex2(fmaf(s[j][1], kLog2e, -ml0));
      s[j][2] = ex2(fmaf(s[j][2], kLog2e, -ml1));
      s[j][3] = ex2(fmaf(s[j][3], kLog2e, -ml1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }

    // O = round_T(e) v: the accumulators of key tiles 2j2 and 2j2 + 1
    // are the A operand of the 16-key step j2
    float o[DT][4];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
#pragma unroll
    for (int j2 = 0; j2 < NK; ++j2) {
      if (j2 < nk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * j2][0], s[2 * j2][1]),
            pack_bf16(s[2 * j2][2], s[2 * j2][3]),
            pack_bf16(s[2 * j2 + 1][0], s[2 * j2 + 1][1]),
            pack_bf16(s[2 * j2 + 1][2], s[2 * j2 + 1][3])};
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_u32(vs + (j2 * 16 + (lane & 7) +
                                               (lane & 8)) * RS +
                                         dd * 16 + (lane >> 4) * 8));
          mma_bf16(o[2 * dd], pa, vb[0], vb[1]);
          mma_bf16(o[2 * dd + 1], pa, vb[2], vb[3]);
        }
      }
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int d = dt * 8 + 2 * t;
      if (in0)
        *reinterpret_cast<uint32_t*>(out_w + static_cast<size_t>(r0) * C +
                                     d) =
            pack_bf16(o[dt][0] / l0, o[dt][1] / l0);
      if (in1)
        *reinterpret_cast<uint32_t*>(out_w + static_cast<size_t>(r1) * C +
                                     d) =
            pack_bf16(o[dt][2] / l1, o[dt][3] / l1);
    }
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

template <int HD, int NK>
int launch_mma(const void* qkv, const void* bias, const void* mask,
               void* out, int W, int N, int C, int heads, int n_mask,
               float scale, cudaStream_t s) {
  const int Np = (N + 15) & ~15;
  const size_t smem = sizeof(bf16) * 3 * static_cast<size_t>(Np) *
                      (HD + kPad);
  auto kernel = window_attention_mma_kernel<HD, NK>;
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  const int vec =
      N % 8 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0 &&
      (mask == nullptr || reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  kernel<<<W * heads, MmaShape<NK>::kWarps * 32, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(mask), static_cast<bf16*>(out), W, N, C,
      n_mask, vec, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_mma_hd(const void* qkv, const void* bias, const void* mask,
                  void* out, int W, int N, int C, int heads, int n_mask,
                  float scale, cudaStream_t s) {
  if (N <= 32)
    return launch_mma<HD, 2>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                             scale, s);
  if (N <= 64)
    return launch_mma<HD, 4>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                             scale, s);
  if (N <= 144)
    return launch_mma<HD, 9>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                             scale, s);
  return launch_mma<HD, 16>(qkv, bias, mask, out, W, N, C, heads, n_mask,
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
    return launch_mma_hd<32>(qkv, bias, mask, out, W, N, C, heads, n_mask,
                             scale, s);
  if (C == 16 * heads)
    return launch_mma_hd<16>(qkv, bias, mask, out, W, N, C, heads, n_mask,
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
