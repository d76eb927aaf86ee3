// The memory-bound passes between a UNet's convolutions (nn/unet.py) for
// Hopper (sm_90a), in two kernels over channels-last (NHWC) tensors:
//
//   unet_bn_relu_kernel: an eval BatchNorm from the fp32 running
//     statistics and affine, then ReLU, written into a channel slice of a
//     buffer at least as wide (the skip half of an Up's concatenation, or
//     a tensor of its own), and with POOL also the 2x2 / stride-2 max pool
//     of that result (floor sizes, as nn.MaxPool2d(2));
//   unet_up_place_kernel: the transposed conv's bias added to its output,
//     which is written into the second half of the Up's concatenation
//     buffer at the pad offset, zeros on the pad border.
//
// Replaces no TPU kernel.  The JAX package leaves these passes to XLA,
// which fuses them into its convolutions; the port's eager chain ran them
// as separate PyTorch kernels (BatchNorm's copy of the mean, its inverse
// std and its transform, ReLU, max pool, the bias add, F.pad, torch.cat):
// 94 small launches a UNet at 200x200, where these make 22.
//
// The numbers are the chain's, operation for operation, so that the kernel
// is held to it bit for bit:
//   * inv_std = rsqrtf(running_var + eps), eps as a float, as PyTorch's
//     batch_norm_calc_invstd computes it in eval;
//   * y = w * (x - mean) * inv_std + b in fp32, the expression of
//     batch_norm_transform_input_channels_last_kernel (Normalization.cuh),
//     which nvcc contracts the same way, then one rounding to T;
//   * ReLU on the rounded value as clamp_min does (NaN kept, else fmaxf);
//   * the max pool as max_pool_forward_nhwc: -inf, then row by row
//     "v > max || isnan(v)";
//   * the bias add as a T add (fp32 sum, one rounding).
// bf16 rounds with __float2bfloat16, c10::BFloat16's conversion on sm_80+.
//
// Bound on an H100: bytes.  A pass reads its input and writes its output
// once (the pooled variant a quarter more); a few flops an element are far
// below the compute roof.  The largest, a 200x200x64 bf16 tensor, moves
// 10.2 MB (3 us at 3.35 TB/s), and most inputs arrive from the 50 MB L2,
// where the conv ahead wrote them.  The design:
//   * a thread owns 8 channels (16 bytes of bf16, two 16-byte loads of
//     fp32) and holds their scale terms (or bias) in registers;
//   * threads walk pixels with their channel group fastest, so a warp's
//     loads and stores are contiguous; a plain pass has each thread take
//     kPix pixels a lane-count apart, all loaded before any is computed;
//   * the pooled variant has a thread own a 2x2 quad of pixels, so every
//     input is read once; odd sizes keep their last row and column in the
//     full-size output only;
//   * one grid a call, sized to the tensor.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// pixels a thread takes in the plain passes, as many as a pooled quad holds
constexpr int kPix = 4;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // little-endian: element 2k is the low half
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// v must hold values a bf16 represents (they were rounded): exact.
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = (__float_as_uint(v[2 * k]) >> 16)
           | (__float_as_uint(v[2 * k + 1]) & 0xffff0000u);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// y rounded to T, as a float.
__device__ __forceinline__ float rounded(float y, float) { return y; }
__device__ __forceinline__ float rounded(float y, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(y));
}

template <typename T, bool POOL>
__global__ void __launch_bounds__(kThreads) unet_bn_relu_kernel(
    const T* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ weight,
    const float* __restrict__ bias, float eps, T* __restrict__ out,
    int out_stride, T* __restrict__ pooled, int n, int h, int w, int c,
    int lanes) {
  const int groups = c / 8;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int lane = t / groups;
  if (lane >= lanes) return;
  const int c0 = (t - lane * groups) * 8;

  float m[8], inv[8], wt[8], s[8];
  load8(mean + c0, m);
  load8(var + c0, inv);
  load8(weight + c0, wt);
  load8(bias + c0, s);
#pragma unroll
  for (int k = 0; k < 8; ++k) inv[k] = rsqrtf(inv[k] + eps);

  // BatchNorm, rounding, ReLU: the chain's three passes on one chunk
  auto epilogue = [&](float (&v)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float r = rounded(wt[k] * (v[k] - m[k]) * inv[k] + s[k], T());
      v[k] = isnan(r) ? r : fmaxf(r, 0.f);
    }
  };

  float v[kPix][8];
  size_t dst[kPix];
  bool has[kPix];
  if constexpr (!POOL) {
    const int npix = n * h * w;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int p = lane + k * lanes;
      has[k] = p < npix;
      dst[k] = static_cast<size_t>(p) * out_stride + c0;
      if (has[k]) load8(x + static_cast<size_t>(p) * c + c0, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (!has[k]) continue;
      epilogue(v[k]);
      store8(out + dst[k], v[k]);
    }
  } else {
    // lane: the quad (b, qy, qx) of a (ceil(h/2), ceil(w/2)) grid
    const int qw = (w + 1) / 2, qh = (h + 1) / 2;
    const int qx = lane % qw;
    const int qy = (lane / qw) % qh;
    const int b = lane / (qw * qh);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int y = 2 * qy + k / 2, xx = 2 * qx + k % 2;
      has[k] = y < h && xx < w;
      const size_t p = (static_cast<size_t>(b) * h + y) * w + xx;
      dst[k] = p * out_stride + c0;
      if (has[k]) load8(x + p * c + c0, v[k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!has[k]) continue;
      epilogue(v[k]);
      store8(out + dst[k], v[k]);
    }
    if (has[3]) {  // the whole quad lies inside: floor sizes
      float mx[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        mx[e] = -INFINITY;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (v[k][e] > mx[e] || isnan(v[k][e])) mx[e] = v[k][e];
      }
      const int ph = h / 2, pw = w / 2;
      const size_t q = (static_cast<size_t>(b) * ph + qy) * pw + qx;
      store8(pooled + q * c + c0, mx);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) unet_up_place_kernel(
    const T* __restrict__ up, const T* __restrict__ bias, T* __restrict__ out,
    int out_stride, int n, int H, int W, int h, int w, int top, int left,
    int c, int lanes) {
  const int groups = c / 8;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int lane = t / groups;
  if (lane >= lanes) return;
  const int c0 = (t - lane * groups) * 8;

  float bv[8];
  load8(bias + c0, bv);
  const int npix = n * H * W;
  float v[kPix][8];
  bool has[kPix], inside[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int p = lane + k * lanes;
    has[k] = p < npix;
    const int X = p % W, Y = (p / W) % H, b = p / (W * H);
    const int sy = Y - top, sx = X - left;
    inside[k] = has[k] && sy >= 0 && sy < h && sx >= 0 && sx < w;
    if (inside[k])
      load8(up + ((static_cast<size_t>(b) * h + sy) * w + sx) * c + c0,
            v[k]);
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (!has[k]) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      v[k][e] = inside[k] ? rounded(v[k][e] + bv[e], T()) : 0.f;
    store8(out + static_cast<size_t>(lane + k * lanes) * out_stride + c0,
           v[k]);
  }
}

int blocks_for(long long threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

template <typename T>
int bn_relu(const void* x, const void* mean, const void* var,
            const void* weight, const void* bias, float eps, void* out,
            int out_stride, void* pooled, int n, int h, int w, int c,
            void* stream) {
  if (c <= 0 || c % 8 || out_stride < c || out_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long npix = static_cast<long long>(n) * h * w;
  const int groups = c / 8;
  if (pooled == nullptr) {
    const int lanes = static_cast<int>((npix + kPix - 1) / kPix);
    unet_bn_relu_kernel<T, false>
        <<<blocks_for(static_cast<long long>(lanes) * groups), kThreads, 0,
           s>>>(static_cast<const T*>(x), static_cast<const float*>(mean),
                static_cast<const float*>(var),
                static_cast<const float*>(weight),
                static_cast<const float*>(bias), eps, static_cast<T*>(out),
                out_stride, nullptr, n, h, w, c, lanes);
  } else {
    const int lanes = n * ((h + 1) / 2) * ((w + 1) / 2);
    unet_bn_relu_kernel<T, true>
        <<<blocks_for(static_cast<long long>(lanes) * groups), kThreads, 0,
           s>>>(static_cast<const T*>(x), static_cast<const float*>(mean),
                static_cast<const float*>(var),
                static_cast<const float*>(weight),
                static_cast<const float*>(bias), eps, static_cast<T*>(out),
                out_stride, static_cast<T*>(pooled), n, h, w, c, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int up_place(const void* up, const void* bias, void* out, int out_stride,
             int n, int H, int W, int h, int w, int top, int left, int c,
             void* stream) {
  if (c <= 0 || c % 8 || out_stride < c || out_stride % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long npix = static_cast<long long>(n) * H * W;
  const int lanes = static_cast<int>((npix + kPix - 1) / kPix);
  unet_up_place_kernel<T>
      <<<blocks_for(static_cast<long long>(lanes) * (c / 8)), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(up), static_cast<const T*>(bias),
          static_cast<T*>(out), out_stride, n, H, W, h, w, top, left, c,
          lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, h, w, c) and the pooled output (n, h/2, w/2, c) contiguous; out
// points at channel 0 of the slice, out_stride elements apart per pixel;
// pooled null: no pool.  Every pointer 16-byte aligned, c and out_stride
// multiples of 8.
extern "C" int unet_bn_relu_bf16(const void* x, const void* mean,
                                 const void* var, const void* weight,
                                 const void* bias, float eps, void* out,
                                 int out_stride, void* pooled, int n, int h,
                                 int w, int c, void* stream) {
  return bn_relu<__nv_bfloat16>(x, mean, var, weight, bias, eps, out,
                                out_stride, pooled, n, h, w, c, stream);
}

extern "C" int unet_bn_relu_f32(const void* x, const void* mean,
                                const void* var, const void* weight,
                                const void* bias, float eps, void* out,
                                int out_stride, void* pooled, int n, int h,
                                int w, int c, void* stream) {
  return bn_relu<float>(x, mean, var, weight, bias, eps, out, out_stride,
                        pooled, n, h, w, c, stream);
}

// up (n, h, w, c) contiguous, bias (c) in up's type; out points at channel
// 0 of the slice of an (n, H, W, out_stride) buffer; (top, left) the pad
// offset.
extern "C" int unet_up_place_bf16(const void* up, const void* bias,
                                  void* out, int out_stride, int n, int H,
                                  int W, int h, int w, int top, int left,
                                  int c, void* stream) {
  return up_place<__nv_bfloat16>(up, bias, out, out_stride, n, H, W, h, w,
                                 top, left, c, stream);
}

extern "C" int unet_up_place_f32(const void* up, const void* bias, void* out,
                                 int out_stride, int n, int H, int W, int h,
                                 int w, int top, int left, int c,
                                 void* stream) {
  return up_place<float>(up, bias, out, out_stride, n, H, W, h, w, top, left,
                         c, stream);
}
