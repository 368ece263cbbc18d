// K3: the fused CReFF module + 1x1 final_conv + argmax, NHWC:
//   pred[n,y,x] = argmax_k ( sum_c round_T(fused[n,y,x,c]) * fc_w[c,k] + fc_b[k] )
// with fused = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// (creff_module.cuh, shared with K1). The fused feature and the logits
// never reach device memory; the output is one int32 per pixel.
//
// Replaces: arseg_tpu/ops/pallas_creff.py creff_phase2_argmax
// (_qkv_head_kernel -> _fused_module_body, then a [C, n_classes] dot and
// argmax). The TPU kernel padded the classes to 128 lanes with a -inf bias
// and wrote int32 tiles of 128 lanes; here each thread keeps its pixel's
// logits in registers and takes the argmax with a strict '>', so the lowest
// index wins a tie, as jnp.argmax does.
//
// Bound on the H100: at [11,720,960,64] bf16 (camvid-psp18 V1) the function
// reads lr_up and ref once (2 x 973 MB) and writes 30 MB of int32, about
// 0.59 ms at 3.35 TB/s; its ~134 GFLOP (K1's 251 flops per element plus
// 2 x 12 for the 1x1 conv) would take 0.13 ms at the bf16 tensor rate, so
// bytes bound it. This first kernel inherits K1's limit, shared-memory reads
// in the window products, and adds n_classes FMAs per channel per pixel in
// registers: its design keeps only the int32 map in device memory.
//
// Epilogue: fused values arrive per channel chunk in float32, are rounded to
// the input type (the TPU kernel's fused.astype(in_dtype) before the dot),
// multiplied by fc_w (float32 holding values of the input type) and summed
// in float32, channel by channel in order; then the float32 bias.

#include "creff_module.cuh"
#include "kernels.h"

namespace {

constexpr int MAX_CLASSES = 19;  // CamVid 12, Cityscapes 19

template <typename T>
struct ArgmaxHead {
  static constexpr int HALO = 0;
  int32_t* out;         // [n, h, w]
  const float* fc_w;    // [c, n_classes]
  const float* fc_b;    // [n_classes]
  int n_classes;
  float logit[MAX_CLASSES];  // zero in the launch argument; per-thread sums

  __device__ __forceinline__ void chunk(int64_t, int c0, const float f[creff::CC]) {
#pragma unroll
    for (int cc = 0; cc < creff::CC; ++cc) {
      const float v = creff::round_to<T>(f[cc]);
      const float* wrow = fc_w + (c0 + cc) * n_classes;
#pragma unroll
      for (int k = 0; k < MAX_CLASSES; ++k)
        if (k < n_classes) logit[k] = fmaf(v, __ldg(wrow + k), logit[k]);
    }
  }

  __device__ __forceinline__ void finish(int64_t pixel, bool inside) {
    if (!inside) return;
    int best = 0;
    float best_v = logit[0] + __ldg(fc_b);
#pragma unroll
    for (int k = 1; k < MAX_CLASSES; ++k) {
      if (k < n_classes) {
        const float v = logit[k] + __ldg(fc_b + k);
        if (v > best_v) {
          best_v = v;
          best = k;
        }
      }
    }
    out[pixel] = best;
  }
};

template <typename T>
int run(int32_t* out, const void* lr, const void* ref, const float* taps, const float* bias,
        const float* fc_w, const float* fc_b, int n, int h, int w, int c, int n_classes, int k,
        cudaStream_t stream) {
  ArgmaxHead<T> epi{};
  epi.out = out;
  epi.fc_w = fc_w;
  epi.fc_b = fc_b;
  epi.n_classes = n_classes;
  return creff::launch_k<T>(lr, ref, taps, bias, n, h, w, c, k, epi, stream);
}

}  // namespace

extern "C" int arseg_creff_phase2_argmax(int32_t* out, const void* lr_up, const void* ref,
                                         const float* taps, const float* bias,
                                         const float* fc_w, const float* fc_b, int n, int h,
                                         int w, int c, int n_classes, int kh, int kw, int dtype,
                                         void* stream) {
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
