// Native host-side data-path kernels of the data pipeline (a copy of
// dhd_tpu/native/src/dhd_native.cpp).
//
// The reference framework keeps its hot host paths in Python inside
// mmcv dataloader workers (image normalize, lidar->camera z-buffer
// projection, datasets/pipelines/loading.py:402-500, loading_new.py:29-202).
// Here those run as C++ with OpenMP across cameras, bound via ctypes
// (dhd_tpu_torch/native/__init__.py), feeding the device input pipeline.
//
// Built at first use by dhd_tpu_torch/native/__init__.py:
// g++ -O3 -fopenmp -shared -fPIC -std=c++17.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// RGB->BGR swap + mmcv imnormalize (pipeline.py IMG_MEAN/IMG_STD quirk).
// src: n images of (h, w, 3) uint8 RGB; dst: float32 same layout.
void dhd_normalize_images(const uint8_t* src, float* dst,
                          int n, int h, int w,
                          const float* mean, const float* stdv) {
    const float inv_std[3] = {1.0f / stdv[0], 1.0f / stdv[1],
                              1.0f / stdv[2]};
    const long total = (long)n * h * w;
#pragma omp parallel for schedule(static)
    for (long i = 0; i < total; ++i) {
        const uint8_t* p = src + i * 3;
        float* q = dst + i * 3;
        // channel swap: output channel c takes input channel 2-c
        q[0] = ((float)p[2] - mean[0]) * inv_std[0];
        q[1] = ((float)p[1] - mean[1]) * inv_std[1];
        q[2] = ((float)p[0] - mean[2]) * inv_std[2];
    }
}

// Project lidar points into n_cams cameras with nearest-depth z-buffers,
// producing per-camera depth and height maps (height = lidar-ego z).
//
// points:    (n_pts, 3) float32 lidar-frame xyz
// lidar2img: (n_cams, 4, 4) row-major
// lidar2ego: (4, 4) row-major (shared)
// post_rot:  (n_cams, 3, 3); post_tran: (n_cams, 3)
// depth_out / height_out: (n_cams, h, w) float32, zero-initialized by caller
void dhd_project_cameras(const float* points, long n_pts,
                         const float* lidar2img, const float* lidar2ego,
                         const float* post_rot, const float* post_tran,
                         int n_cams, int h, int w,
                         float d_min, float d_max,
                         float* depth_out, float* height_out) {
#pragma omp parallel for schedule(dynamic, 1)
    for (int cam = 0; cam < n_cams; ++cam) {
        const float* L = lidar2img + cam * 16;
        const float* R = post_rot + cam * 9;
        const float* T = post_tran + cam * 3;
        float* dmap = depth_out + (long)cam * h * w;
        float* hmap = height_out + (long)cam * h * w;
        for (long i = 0; i < n_pts; ++i) {
            const float x = points[i * 3 + 0];
            const float y = points[i * 3 + 1];
            const float z = points[i * 3 + 2];
            // lidar -> image homogeneous
            const float ud = L[0] * x + L[1] * y + L[2] * z + L[3];
            const float vd = L[4] * x + L[5] * y + L[6] * z + L[7];
            const float d = L[8] * x + L[9] * y + L[10] * z + L[11];
            if (d == 0.0f) continue;
            float u = ud / d;
            float v = vd / d;
            // image aug: (u, v, d) via post_rot/post_tran
            const float ua = R[0] * u + R[1] * v + R[2] * d + T[0];
            const float va = R[3] * u + R[4] * v + R[5] * d + T[1];
            const float da = R[6] * u + R[7] * v + R[8] * d + T[2];
            // round half-to-even to match torch.round (loading.py:420)
            const int px = (int)std::nearbyintf(ua);
            const int py = (int)std::nearbyintf(va);
            if (px < 0 || px >= w || py < 0 || py >= h) continue;
            if (da < d_min || da >= d_max) continue;
            float* dcell = dmap + (long)py * w + px;
            if (*dcell == 0.0f || da < *dcell) {
                *dcell = da;
                // height: point z in lidar-ego frame
                const float hz = lidar2ego[8] * x + lidar2ego[9] * y +
                                 lidar2ego[10] * z + lidar2ego[11];
                hmap[(long)py * w + px] = hz;
            }
        }
    }
}

// Min-pool downsample treating 0 as missing (losses/height_loss.py
// downsample_min_nonzero) — used by the input pipeline when labels are
// prepared on host.
void dhd_min_pool_nonzero(const float* src, float* dst,
                          int n, int h, int w, int ds) {
    const int oh = h / ds, ow = w / ds;
#pragma omp parallel for schedule(static)
    for (long o = 0; o < (long)n * oh * ow; ++o) {
        const int i = o / ((long)oh * ow);
        const int oy = (o / ow) % oh;
        const int ox = o % ow;
        float best = 1e5f;
        const float* base = src + (long)i * h * w;
        for (int dy = 0; dy < ds; ++dy) {
            const float* row = base + (long)(oy * ds + dy) * w + ox * ds;
            for (int dx = 0; dx < ds; ++dx) {
                const float val = row[dx];
                if (val != 0.0f && val < best) best = val;
            }
        }
        dst[o] = best;
    }
}

}  // extern "C"
