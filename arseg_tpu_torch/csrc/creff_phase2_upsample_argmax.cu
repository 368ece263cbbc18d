// K5: the fused CReFF module + 1x1 final_conv + x8 bilinear upsample
// (align_corners=False) + argmax, NHWC in, int32 [n, 8h, 8w] out:
//   logit[k]  = round_T(sum_c fused[c] * fc_w[c,k])        per fused pixel
//   col       = round_T(lerp over columns of logit)        x8 along w
//   row       = lerp over rows of col, in float32          x8 along h
//   pred      = argmax_k(row[k] + fc_b[k])                 lowest index on ties
// with fused = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// in float32 (creff_module.cuh, shared with K1 and K3). Neither the fused
// feature nor a logit plane reaches device memory: only the class map.
//
// Replaces: arseg_tpu/ops/pallas_creff.py creff_phase2_upsample_argmax
// (_qkv_upsample_head_kernel), the BiSeNet inference head under
// USE_FUSED_UPSAMPLE_HEAD. The rounding follows that kernel: per-class
// logits summed in float32 and rounded to the input type, the column
// interpolation summed in float32 and rounded, the row interpolation in
// float32, the float32 bias added after the upsample (the interpolation
// weights of each output sum to one), a strict '>' in the argmax. The TPU
// kernel needed full-width rows (w <= 128) for its column-upsample matmul
// on 128-lane tiles; nothing here depends on the width, so that limit is
// not carried over.
//
// Neighbours' logits: output row 8r + j reads fused rows r-1..r+1, and
// the same holds for columns. So the blocks overlap (the epilogue's
// HALO = 1): each computes the module on an 8 x 16 tile that holds its
// 6 x 14 interior and a one-pixel ring, puts the tile's logits in shared
// memory, synchronises, and writes the 48 x 112 outputs of its interior.
// The module does about 1.5x the work of a partition into 8 x 16 tiles.
// At the image border the source index is clamped to [0, h-1] as
// F.interpolate clamps it; the ring outside the image is never read.
//
// Bound on the H100: at [11,90,120,256] bf16 the function reads lr_up and
// ref once (2 x 60.8 MB) and writes a 30.4 MB int32 map, about 0.045 ms at
// 3.35 TB/s; its ~8.4 GFLOP (K1's 251 per element, 2 x 12 for the 1x1
// conv, the upsample's 12 x 6 per output) would take 9 us at the bf16
// tensor rate, so bytes bound it. This first kernel inherits K1's limit,
// shared-memory reads in the window products.

#include "creff_module.cuh"
#include "kernels.h"

namespace {

constexpr int MAX_CLASSES = 19;  // CamVid 12, Cityscapes 19
constexpr int UP = 8;            // BiSeNetOutput's up_factor

// Source taps of output index `o` of a x UP align_corners=False resize of
// `in` samples, as F.interpolate computes them: src = max((o + 0.5) / UP -
// 0.5, 0), i0 = floor(src), i1 = min(i0 + 1, in - 1), weight w1 on i1. When
// the clamp folds i1 onto i0 the weights merge into 1 on i0, as in the
// JAX package's interpolation matrix.
__device__ __forceinline__ void taps(int o, int in, int& i0, int& i1, float& w1) {
  const float src = fmaxf(__fsub_rn(__fmul_rn(o + 0.5f, 1.0f / UP), 0.5f), 0.0f);
  i0 = min(static_cast<int>(floorf(src)), in - 1);
  i1 = min(i0 + 1, in - 1);
  w1 = i1 == i0 ? 0.0f : __fsub_rn(src, static_cast<float>(i0));
}

template <typename T>
struct UpsampleArgmaxHead {
  static constexpr int HALO = 1;
  int32_t* out;         // [n, UP h, UP w]
  const float* fc_w;    // [c, n_classes], values of T
  const float* fc_b;    // [n_classes] float32
  int n_classes, h, w;
  float logit[MAX_CLASSES];  // zero in the launch argument; per-thread sums

  __device__ __forceinline__ void chunk(int64_t, int c0, const float f[creff::CC]) {
#pragma unroll
    for (int cc = 0; cc < creff::CC; ++cc) {
      const float* wrow = fc_w + (c0 + cc) * n_classes;
#pragma unroll
      for (int k = 0; k < MAX_CLASSES; ++k)
        if (k < n_classes) logit[k] = fmaf(f[cc], __ldg(wrow + k), logit[k]);
    }
  }

  __device__ void finish(int64_t, bool inside) {
    using creff::TH;
    using creff::TW;
    // the module's shared memory is free once every thread is here
    extern __shared__ float smem[];
    float* lg = smem;  // [MAX_CLASSES][TH * TW] logits of the tile, rounded to T
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_CLASSES; ++k)
      if (k < n_classes) lg[k * TH * TW + threadIdx.x] = inside ? creff::round_to<T>(logit[k]) : 0.0f;
    __syncthreads();

    const int y0 = blockIdx.y * (TH - 2) - 1;  // the tile's first row and column
    const int x0 = blockIdx.x * (TW - 2) - 1;
    const int rows = min(TH - 2, h - (y0 + 1)) * UP;  // this block's outputs
    const int cols = min(TW - 2, w - (x0 + 1)) * UP;
    const int oh = UP * h, ow = UP * w;
    int32_t* o_img = out + static_cast<int64_t>(blockIdx.z) * oh * ow;
    for (int t = threadIdx.x; t < rows * cols; t += blockDim.x) {
      const int oy = (y0 + 1) * UP + t / cols;
      const int ox = (x0 + 1) * UP + t % cols;
      int r0, r1, c0, c1;
      float wy, wx;
      taps(oy, h, r0, r1, wy);
      taps(ox, w, c0, c1, wx);
      const float* a0 = lg + (r0 - y0) * TW - x0;  // tile row r0, indexed by image column
      const float* a1 = lg + (r1 - y0) * TW - x0;
      int best = 0;
      float best_v = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_CLASSES; ++k) {
        if (k < n_classes) {
          const int off = k * TH * TW;
          const float top = creff::round_to<T>(
              __fadd_rn(__fmul_rn(a0[off + c0], 1.0f - wx), __fmul_rn(a0[off + c1], wx)));
          const float bot = creff::round_to<T>(
              __fadd_rn(__fmul_rn(a1[off + c0], 1.0f - wx), __fmul_rn(a1[off + c1], wx)));
          const float v = __fadd_rn(__fadd_rn(__fmul_rn(top, 1.0f - wy), __fmul_rn(bot, wy)),
                                    __ldg(fc_b + k));
          if (k == 0 || v > best_v) {
            best_v = v;
            best = k;
          }
        }
      }
      o_img[static_cast<int64_t>(oy) * ow + ox] = best;
    }
  }
};

template <typename T>
int run(int32_t* out, const void* lr, const void* ref, const float* taps_qkv, const float* bias,
        const float* fc_w, const float* fc_b, int n, int h, int w, int c, int n_classes, int k,
        cudaStream_t stream) {
  UpsampleArgmaxHead<T> epi{};
  epi.out = out;
  epi.fc_w = fc_w;
  epi.fc_b = fc_b;
  epi.n_classes = n_classes;
  epi.h = h;
  epi.w = w;
  return creff::launch_k<T>(lr, ref, taps_qkv, bias, n, h, w, c, k, epi, stream);
}

}  // namespace

extern "C" int arseg_creff_phase2_upsample_argmax(int32_t* out, const void* lr_up,
                                                  const void* ref, const float* taps,
                                                  const float* bias, const float* fc_w,
                                                  const float* fc_b, int n, int h, int w, int c,
                                                  int n_classes, int kh, int kw, int dtype,
                                                  void* stream) {
  // the tile's logits must fit the module's shared memory (smallest: K = 3)
  static_assert(MAX_CLASSES * creff::TH * creff::TW <= creff::Geom<3>::SMEM_FLOATS, "smem");
  if (kh != kw || c % creff::CC != 0 || c <= 0 || n < 0 || h <= 0 || w <= 0 || n > 65535 ||
      n_classes < 1 || n_classes > MAX_CLASSES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(out, lr_up, ref, taps, bias, fc_w, fc_b, n, h, w, c, n_classes, kh, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(out, lr_up, ref, taps, bias, fc_w, fc_b, n, h, w, c, n_classes,
                              kh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
