// Fused MGHS pooling for Hopper (sm_90a): one pass over the points sorted by
// their z-minor voxel key writes both the height-gated fine voxel grid
// (vox, B*Dy*Dx*Dz rows) and the z-collapsed BEV grid (bev, B*Dy*Dx rows).
//
// Replaces dhd_tpu/ops/pallas_pool.py:_kernel_dual_fused.  What it computes
// is the same; the design is the reference's bev_pool_v2 shape, not the TPU
// kernel's one-hot MXU matmul:
//   * one block per BEV pillar, one thread per channel;
//   * the block walks the pillar's interval of sorted points
//     [starts[p], starts[p+1]); threads stage up to C points' indices, depth
//     values and gates in shared memory, then each thread gathers its
//     channel of every staged point's feature row;
//   * v = T(depth * feat) (the product rounded to the working type, as the
//     plain version computes it), summed in fp32: into a register for bev,
//     and, where the point's height-band gate is on, into a per-z fp32 row
//     in shared memory for vox;
//   * at the end the block writes all Dz vox rows and the bev row, zeros
//     included.
// Each output element has exactly one writer: no atomics, deterministic, no
// zero-fill pass.  The work is bound by bytes: writing vox dominates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void mghs_pool_kernel(const T* __restrict__ depth,
                                 const T* __restrict__ feat,
                                 const T* __restrict__ band_mask,
                                 const int32_t* __restrict__ dix_s,
                                 const int32_t* __restrict__ z_s,
                                 const int32_t* __restrict__ starts,
                                 T* __restrict__ bev, T* __restrict__ vox,
                                 int C, int D, int dz, int edge0, int edge1) {
  extern __shared__ float smem[];
  float* acc = smem;                                // dz * C fp32
  int* s_pix = reinterpret_cast<int*>(acc + dz * C);  // C staged points
  int* s_zg = s_pix + C;
  float* s_d = reinterpret_cast<float*>(s_zg + C);

  const int pillar = blockIdx.x;
  const int c = threadIdx.x;
  for (int z = 0; z < dz; ++z) acc[z * C + c] = 0.f;
  float bev_acc = 0.f;

  const int p0 = starts[pillar];
  const int p1 = starts[pillar + 1];
  for (int base = p0; base < p1; base += C) {
    const int n = min(C, p1 - base);
    __syncthreads();  // the previous chunk's staged points are consumed
    if (c < n) {
      const int dix = dix_s[base + c];
      const int pix = dix / D;
      const int z = z_s[base + c];
      int zg = -1;  // fine z where the height-band gate is on, else -1
      if (z >= 0) {
        const int band = (z >= edge0) + (z >= edge1);
        if (to_f32(band_mask[pix * 3 + band]) > 0.f) zg = z;
      }
      s_pix[c] = pix;
      s_zg[c] = zg;
      s_d[c] = to_f32(depth[dix]);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float f = to_f32(feat[static_cast<size_t>(s_pix[i]) * C + c]);
      const float v = to_f32(from_f32<T>(s_d[i] * f));
      bev_acc += v;
      const int zg = s_zg[i];
      if (zg >= 0) acc[zg * C + c] += v;  // thread c owns column c
    }
  }

  T* vrow = vox + static_cast<size_t>(pillar) * dz * C;
  for (int z = 0; z < dz; ++z) vrow[z * C + c] = from_f32<T>(acc[z * C + c]);
  bev[static_cast<size_t>(pillar) * C + c] = from_f32<T>(bev_acc);
}

template <typename T>
int launch(const void* depth, const void* feat, const void* band_mask,
           const void* dix_s, const void* z_s, const void* starts, void* bev,
           void* vox, int n_pillars, int C, int D, int dz, int edge0,
           int edge1, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(dz) * C + 3 * C);
  mghs_pool_kernel<T><<<n_pillars, C, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(depth), static_cast<const T*>(feat),
      static_cast<const T*>(band_mask), static_cast<const int32_t*>(dix_s),
      static_cast<const int32_t*>(z_s), static_cast<const int32_t*>(starts),
      static_cast<T*>(bev), static_cast<T*>(vox), C, D, dz, edge0, edge1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mghs_pool_bf16(const void* depth, const void* feat,
                              const void* band_mask, const void* dix_s,
                              const void* z_s, const void* starts, void* bev,
                              void* vox, int n_pillars, int C, int D, int dz,
                              int edge0, int edge1, void* stream) {
  return launch<__nv_bfloat16>(depth, feat, band_mask, dix_s, z_s, starts,
                               bev, vox, n_pillars, C, D, dz, edge0, edge1,
                               stream);
}

extern "C" int mghs_pool_f32(const void* depth, const void* feat,
                             const void* band_mask, const void* dix_s,
                             const void* z_s, const void* starts, void* bev,
                             void* vox, int n_pillars, int C, int D, int dz,
                             int edge0, int edge1, void* stream) {
  return launch<float>(depth, feat, band_mask, dix_s, z_s, starts, bev, vox,
                       n_pillars, C, D, dz, edge0, edge1, stream);
}
