// K1: the fused CReFF module (MyAttention forward), NHWC:
//   out = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// over a K x K window. The body (tiles, halo staging, the two channel
// passes) is creff_module.cuh, shared with K3; this file's epilogue stores
// the fused feature, rounded once to the input type.
//
// Replaces: arseg_tpu/ops/pallas_creff.py creff_qkv_fused (_qkv_kernel ->
// _fused_module_body). The TPU kernel streamed halo windows by manual DMA
// and ran the window as a banded matmul on the MXU; this one keeps the
// window in shared memory and runs it on the CUDA cores.
//
// Bound on the H100: at [11,90,120,256] bf16 the function moves 91 MB
// (lr_up, ref, out) and does about 7.6 GFLOP (three 3x3 depthwise convs and
// two 49-tap window products per channel), so its least time is set by
// bytes (~27 us). This first kernel is bound instead by shared-memory reads
// in the window products: one load per multiply-add.

#include "creff_module.cuh"
#include "kernels.h"

namespace {

template <typename T>
struct StoreFused {
  static constexpr int HALO = 0;
  T* out;  // [n, h, w, c]
  int c;

  __device__ __forceinline__ void chunk(int64_t pixel, int c0, const float f[creff::CC]) {
    T* o = out + pixel * c + c0;
#pragma unroll
    for (int cc = 0; cc < creff::CC; ++cc) o[cc] = creff::from_f32<T>(f[cc]);
  }
  __device__ __forceinline__ void finish(int64_t, bool) {}
};

template <typename T>
int run(void* out, const void* lr, const void* ref, const float* taps, const float* bias, int n,
        int h, int w, int c, int k, cudaStream_t stream) {
  const StoreFused<T> epi{static_cast<T*>(out), c};
  return creff::launch_k<T>(lr, ref, taps, bias, n, h, w, c, k, epi, stream);
}

}  // namespace

extern "C" int arseg_creff_qkv_fused(void* out, const void* lr_up, const void* ref,
                                     const float* taps, const float* bias, int n, int h,
                                     int w, int c, int kh, int kw, int dtype, void* stream) {
  if (kh != kw || c % creff::CC != 0 || n < 0 || h <= 0 || w <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(out, lr_up, ref, taps, bias, n, h, w, c, kh, s);
  if (dtype == 1) return run<__nv_bfloat16>(out, lr_up, ref, taps, bias, n, h, w, c, kh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
