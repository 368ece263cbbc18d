// MV warp: bilinear grid sample with zero padding, NHWC.
//
// Replaces: the per-pixel gather of arseg_tpu/ops/warp.py
// (_grid_sample_planes, the JAX main path) and the TPU kernels that compute
// the same function, arseg_tpu/ops/pallas_warp.py (_blocked_pass) and
// arseg_tpu/ops/pallas_warp2.py (ref_to_lanes_h, warp_pass1, transpose_mid,
// warp_pass2). Those existed because the TPU has no per-lane gather; this
// card gathers from device memory and L2 directly, so the function is one
// plain kernel.
//
// Bound on the H100: bytes. Per output element it reads 4 corners and does
// 7 flops; the source feature of one keyframe (5.5 MB in bf16 at
// [90,120,256]) stays in the 50 MB L2 while every frame of the GOP reads
// it, so device memory sees about one read of the source and flows and
// one write of the output.
//
// Design: one thread per (output pixel, 8-channel vector); 16-byte loads and
// stores along C (two for float32); weights and sums in float32, rounded
// once to the output type. The source is not padded in memory: a corner
// outside the image gets weight 0 and is not read. The index math follows
// the JAX expression order step by step with round-to-nearest intrinsics,
// so no multiply-add is contracted and floor() sees the same value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Source coordinate along one axis, in the order of arseg_tpu/ops/warp.py:
// v = i + f; g = 2*v/max(n-1,1) - 1; then grid_sample's unnormalisation.
__device__ __forceinline__ float source_coord(int i, float f, int n, int align_corners) {
  const float v = __fadd_rn(static_cast<float>(i), f);
  const float g = __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, v), static_cast<float>(max(n - 1, 1))), 1.0f);
  if (align_corners) return __fdiv_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(n - 1)), 2.0f);
  return __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(n)), 1.0f), 2.0f);
}

template <typename T>
__global__ void warp_bilinear_kernel(T* __restrict__ out, const T* __restrict__ src,
                                     const float* __restrict__ fx,
                                     const float* __restrict__ fy, int n, int ns,
                                     int h, int w, int c, int align_corners) {
  const int cv = c / 8;
  const int64_t total = static_cast<int64_t>(n) * h * w * cv;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int v = static_cast<int>(t % cv);
  const int64_t pix = t / cv;
  const int x = static_cast<int>(pix % w);
  const int64_t r = pix / w;
  const int y = static_cast<int>(r % h);
  const int b = static_cast<int>(r / h);

  const float ix = source_coord(x, fx[pix], w, align_corners);
  const float iy = source_coord(y, fy[pix], h, align_corners);
  const float x0 = floorf(ix);
  const float y0 = floorf(iy);
  const float wx = __fsub_rn(ix, x0);
  const float wy = __fsub_rn(iy, y0);
  // per-corner validity: zero padding outside the image
  const bool vx0 = x0 >= 0.0f && x0 <= static_cast<float>(w - 1);
  const bool vx1 = __fadd_rn(x0, 1.0f) >= 0.0f && __fadd_rn(x0, 1.0f) <= static_cast<float>(w - 1);
  const bool vy0 = y0 >= 0.0f && y0 <= static_cast<float>(h - 1);
  const bool vy1 = __fadd_rn(y0, 1.0f) >= 0.0f && __fadd_rn(y0, 1.0f) <= static_cast<float>(h - 1);
  const float wx0 = vx0 ? __fsub_rn(1.0f, wx) : 0.0f;
  const float wx1 = vx1 ? wx : 0.0f;
  const float wy0 = vy0 ? __fsub_rn(1.0f, wy) : 0.0f;
  const float wy1 = vy1 ? wy : 0.0f;
  const float cw[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1), __fmul_rn(wy1, wx0),
                       __fmul_rn(wy1, wx1)};
  const bool cvalid[4] = {vy0 && vx0, vy0 && vx1, vy1 && vx0, vy1 && vx1};

  const T* img = src + static_cast<int64_t>(ns == 1 ? 0 : b) * h * w * c;
  const int xi = vx0 || vx1 ? static_cast<int>(x0) : 0;
  const int yi = vy0 || vy1 ? static_cast<int>(y0) : 0;

  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!cvalid[k]) continue;
    const int cy = yi + (k >> 1);
    const int cx = xi + (k & 1);
    float val[8];
    load8(img + (static_cast<int64_t>(cy) * w + cx) * c + v * 8, val);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(val[i], cw[k]));
  }
  store8(out + pix * c + v * 8, acc);
}

template <typename T>
int launch(void* out, const void* src, const float* fx, const float* fy, int n, int ns,
           int h, int w, int c, int align_corners, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(n) * h * w * (c / 8);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  warp_bilinear_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(src), fx, fy, n, ns, h, w, c,
      align_corners);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arseg_warp_bilinear(void* out, const void* src, const float* fx,
                                   const float* fy, int n, int ns, int h, int w, int c,
                                   int align_corners, int dtype, void* stream) {
  if (c % 8 != 0 || (ns != 1 && ns != n) || n < 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(out, src, fx, fy, n, ns, h, w, c, align_corners, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(out, src, fx, fy, n, ns, h, w, c, align_corners, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
