// MV warp (K2): bilinear grid sample with zero padding, NHWC.
//
// Replaces: the per-pixel gather of arseg_tpu/ops/warp.py
// (_grid_sample_planes, the JAX main path) and the TPU kernels that compute
// the same function, arseg_tpu/ops/pallas_warp.py (_blocked_pass) and
// arseg_tpu/ops/pallas_warp2.py (ref_to_lanes_h, warp_pass1, transpose_mid,
// warp_pass2). Those existed because the TPU has no per-lane gather; this
// card gathers from device memory and L2 directly, so the function is one
// kernel.
//
// What bounds it on the H100. Per 16-byte output vector it reads four
// 16-byte corners and does 8 float32 operations per corner and channel
// (the product and the sum are kept apart for bit-equality). The source of
// one keyframe is read by every frame of the GOP. Where it fits in the 50
// MB L2 ([90,120,256] bf16: 5.5 MB; [90,120,512]: 11.1 MB) device memory
// sees one read of it, the flows and one write of the output; the reads
// that hit L2 (four corners a vector, 64 bytes per 16 written) and the
// float32 issue rate set the pace. At [720,960,64] bf16 the source is 88.5
// MB and does not fit: a block order that ran all of one frame before the
// next would pull it from device memory once per frame.
//
// Design:
// - The block order follows the source's size against the L2, which the
//   launcher reads from the device. A source shared by all frames that
//   takes more than half the L2 is walked with the frames innermost: block
//   i takes frame i % n of pixel tile i / n, so the n blocks that read one
//   source region run together and the source in flight is a band of rows,
//   not the image. Otherwise frames are outermost (frame i / tiles, tile
//   i % tiles), so neighbouring blocks read neighbouring flows and write
//   neighbouring output. On the H100 frames outermost was 3-35% faster
//   (over three runs) at [90,120,256] and [90,120,512], where the source
//   stays in L2 in either order, and half as fast at [720,960,64].
// - Pixels go in sets of 32 consecutive pixels of one frame. One warp per
//   set first computes everything for its pixels, a lane each, once: the
//   flow loads, the source coordinates, floor, per-corner validity, the four
//   weights and the offset of the top-left corner. These go to shared
//   memory; then the set's warps walk its 32 pixels x C/8 chunks of 8
//   channels, a chunk a lane a step, neighbouring lanes on neighbouring
//   chunks of one pixel or of the next (a chunk is one 16-byte vector of
//   bfloat16, two of float32). A block holds 4 warps; at C >= 256 they share
//   one set and at C >= 128 two warps share one, so that a short image
//   still fills the card with blocks and each warp walks at most 16 steps.
// - No 64-bit division: the frame comes from the block index, offsets inside
//   one frame's [H,W,C] image are 32-bit, and the 64-bit frame base is added
//   once. The walk steps its (pixel, vector) pair without dividing.
// - Source loads take the read-only path (ld.global.nc).
// - Bit-equal to the plain version: the coordinates follow the JAX
//   expression order with round-to-nearest intrinsics and __fdiv_rn, so no
//   multiply-add is contracted and floor() sees the same value; products and
//   sums are float32 in corner order, rounded once to the output type. A
//   corner outside the image has weight 0 and is not read; it adds +0.0f,
//   which leaves the sum as it is (the sum starts at +0.0f and so is never
//   -0.0f).
// - S sources for n frames, n a multiple of S: frame b reads source
//   b / (n / S), in place. One source (S = 1) is the GOP: one keyframe
//   feature warped to each frame. S = B is the multi-GOP step: B keyframe
//   features, each warped to the G-1 frames of its GOP, with no repeated
//   copy of a source. S = n gives each frame its own source (the eval
//   engine). The grid's y index is the source and x walks its n / S
//   frames, so no thread divides to find its source (a per-thread division
//   took 8 more registers, and 5-7% at [720,960,64] bf16, on the H100).
//   The launcher refuses an n that S does not divide, and S > 65535. The
//   block order above looks at S = 1 alone: with more sources, frames of
//   one source sit next to each other in either order.
// Not done: staging a source window in shared memory (flows are unbounded,
// so every pixel would still need a device-memory path), and fusing the warp
// into the CReFF kernels' K/V staging.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kSet = 32;   // pixels whose setup one warp computes, a lane each

// 8 channels of T: load (read-only path), unpack to float32, pack and store
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  uint4 u[2];
  __device__ static Chunk zero() { return {{make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)}}; }
  __device__ static Chunk load(const float* p) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    return {{__ldg(q), __ldg(q + 1)}};
  }
  __device__ void unpack(float v[8]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[4 * i] = __uint_as_float(u[i].x);
      v[4 * i + 1] = __uint_as_float(u[i].y);
      v[4 * i + 2] = __uint_as_float(u[i].z);
      v[4 * i + 3] = __uint_as_float(u[i].w);
    }
  }
  __device__ static void store(float* p, const float v[8]) {
    uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      q[i] = make_uint4(__float_as_uint(v[4 * i]), __float_as_uint(v[4 * i + 1]),
                        __float_as_uint(v[4 * i + 2]), __float_as_uint(v[4 * i + 3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  uint4 u;
  __device__ static Chunk zero() { return {make_uint4(0u, 0u, 0u, 0u)}; }
  __device__ static Chunk load(const __nv_bfloat16* p) {
    return {__ldg(reinterpret_cast<const uint4*>(p))};
  }
  // a bfloat16 is the upper half of its float32
  __device__ void unpack(float v[8]) const {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float v[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Source coordinate along one axis, in the order of arseg_tpu/ops/warp.py:
// v = i + f; g = 2*v/max(n-1,1) - 1; then grid_sample's unnormalisation.
__device__ __forceinline__ float source_coord(int i, float f, int n, int align_corners) {
  const float v = __fadd_rn(static_cast<float>(i), f);
  const float g = __fsub_rn(__fdiv_rn(__fmul_rn(2.0f, v), static_cast<float>(max(n - 1, 1))), 1.0f);
  if (align_corners) return __fdiv_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(n - 1)), 2.0f);
  return __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(n)), 1.0f), 2.0f);
}

// kGroup warps share one set of 32 pixels
template <typename T, int kGroup>
__global__ void __launch_bounds__(32 * kWarps)
    warp_bilinear_kernel(T* __restrict__ out, const T* __restrict__ src,
                         const float* __restrict__ fx, const float* __restrict__ fy, int k,
                         int h, int w, int c, int align_corners, int frames_inner) {
  // per pixel of a set: the corner weights (tl, tr, bl, br), and the
  // element offset of the top-left corner in the frame's image with a bit
  // per corner that lies in the image
  __shared__ float4 s_weight[kWarps][kSet];
  __shared__ int2 s_corner[kWarps][kSet];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int hw = h * w;
  constexpr int pixels = kSet * kWarps / kGroup;  // per block
  const int tiles = (hw + pixels - 1) / pixels;
  // blockIdx.y is the source; its k frames are consecutive
  const int b = blockIdx.y * k + (frames_inner ? blockIdx.x % k : blockIdx.x / tiles);
  const int tile = frames_inner ? blockIdx.x / k : blockIdx.x % tiles;
  const int set = warp / kGroup;
  const int p0 = tile * pixels + set * kSet;  // the set's first pixel
  const int64_t frame = static_cast<int64_t>(b) * hw;

  if (warp % kGroup == 0) {
    const int p = p0 + lane;
    float4 cw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int off = 0, valid = 0;
    if (p < hw) {
      const int y = p / w;
      const int x = p - y * w;
      const float ix = source_coord(x, __ldg(fx + frame + p), w, align_corners);
      const float iy = source_coord(y, __ldg(fy + frame + p), h, align_corners);
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
      cw = make_float4(__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1), __fmul_rn(wy1, wx0),
                       __fmul_rn(wy1, wx1));
      valid = (vy0 && vx0) | (vy0 && vx1) << 1 | (vy1 && vx0) << 2 | (vy1 && vx1) << 3;
      const int xi = vx0 || vx1 ? static_cast<int>(x0) : 0;
      const int yi = vy0 || vy1 ? static_cast<int>(y0) : 0;
      off = (yi * w + xi) * c;
    }
    s_weight[set][lane] = cw;
    s_corner[set][lane] = make_int2(off, valid);
  }
  // a warp that walks its own set need not wait for the block's other warps
  if (kGroup == 1)
    __syncwarp();
  else
    __syncthreads();

  const T* img = src + static_cast<int64_t>(blockIdx.y) * hw * c;
  T* dst = out + frame * c;
  const int wc = w * c;
  // the walk: item i = t + stride * step is chunk v = i % cv of pixel j = i / cv
  const int cv = c / 8;
  constexpr int stride = 32 * kGroup;
  const int t = (warp % kGroup) * 32 + lane;
  const int dj = stride / cv, dv = stride % cv;
  int j = t / cv;
  int v = t - j * cv;
  const int steps = (kSet * cv + stride - 1) / stride;
#pragma unroll 2
  for (int step = 0; step < steps; ++step) {
    const int p = p0 + j;
    if (j < kSet && p < hw) {
      const float4 cw = s_weight[set][j];
      const int2 corner = s_corner[set][j];
      const int o = corner.x + v * 8;
      const Chunk<T> r0 = corner.y & 1 ? Chunk<T>::load(img + o) : Chunk<T>::zero();
      const Chunk<T> r1 = corner.y & 2 ? Chunk<T>::load(img + o + c) : Chunk<T>::zero();
      const Chunk<T> r2 = corner.y & 4 ? Chunk<T>::load(img + o + wc) : Chunk<T>::zero();
      const Chunk<T> r3 = corner.y & 8 ? Chunk<T>::load(img + o + wc + c) : Chunk<T>::zero();
      float acc[8], val[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      r0.unpack(val);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(val[i], cw.x));
      r1.unpack(val);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(val[i], cw.y));
      r2.unpack(val);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(val[i], cw.z));
      r3.unpack(val);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(val[i], cw.w));
      Chunk<T>::store(dst + p * c + v * 8, acc);
    }
    v += dv;
    j += dj;
    if (v >= cv) {
      v -= cv;
      ++j;
    }
  }
}

template <typename T>
int launch(void* out, const void* src, const float* fx, const float* fy, int n, int ns,
           int h, int w, int c, int align_corners, cudaStream_t stream) {
  if (n == 0) return 0;
  const int cv = c / 8;
  const int group = cv >= 32 ? kWarps : cv >= 16 ? 2 : 1;
  const int pixels = kSet * kWarps / group;
  void (*kernel)(T*, const T*, const float*, const float*, int, int, int, int, int, int) =
      group == kWarps ? warp_bilinear_kernel<T, kWarps>
                      : group == 2 ? warp_bilinear_kernel<T, 2> : warp_bilinear_kernel<T, 1>;
  // blocks of one source (its n / ns frames) along x, sources along y
  const int64_t blocks = (static_cast<int64_t>(h) * w + pixels - 1) / pixels * (n / ns);
  if (blocks > INT_MAX || ns > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, l2_bytes = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2_bytes, cudaDevAttrL2CacheSize, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t src_bytes = static_cast<int64_t>(h) * w * c * sizeof(T);
  const int frames_inner = ns == 1 && n > 1 && src_bytes > l2_bytes / 2;
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(ns)), 32 * kWarps, 0,
           stream>>>(static_cast<T*>(out), static_cast<const T*>(src), fx, fy, n / ns, h, w, c,
                     align_corners, frames_inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arseg_warp_bilinear(void* out, const void* src, const float* fx,
                                   const float* fy, int n, int ns, int h, int w, int c,
                                   int align_corners, int dtype, void* stream) {
  // offsets inside one frame's image, a row and a column past it, are int32
  if (c % 8 != 0 || c <= 0 || ns <= 0 || n < 0 || n % ns != 0 || h <= 0 || w <= 0 ||
      static_cast<int64_t>(h + 1) * (w + 1) * c > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(out, src, fx, fy, n, ns, h, w, c, align_corners, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(out, src, fx, fy, n, ns, h, w, c, align_corners, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
