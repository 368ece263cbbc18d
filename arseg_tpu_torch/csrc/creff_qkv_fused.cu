// K1: the fused CReFF module (MyAttention forward), NHWC:
//   out = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// over a K x K window, rounded once to the input type.
//
// Replaces: arseg_tpu/ops/pallas_creff.py creff_qkv_fused (_qkv_kernel ->
// _fused_module_body). The TPU kernel streamed halo windows by manual DMA
// and ran the window as a banded matmul on the MXU.
//
// bfloat16 runs the tensor-core body, creff_module_mma.cuh: banded
// mma.sync window products (Q . K^T and p . V), cp.async halo staging a
// chunk ahead, 16 x 16 tiles (K/V conv halo 1.89x at K = 7). Its epilogue
// puts each 16-channel chunk of a warp's 16 pixels, rounded to bf16, in
// the warp's shared scratch and writes it with 16-byte stores. float32
// (the parity checks only) runs the CUDA-core body, creff_module.cuh: a
// TF32 product would not hold the float32 tolerance.
//
// Bound on the H100: at [11,90,120,256] bf16 the function moves 91 MB
// (lr_up, ref, out) and does about 7.6 GFLOP (three 3x3 depthwise convs and
// two 49-tap window products per channel), so its least time is set by
// bytes (~27 us). The CUDA-core body was bound by shared-memory reads, one
// per multiply-add of the window products. The tensor-core body runs the
// products on the tensor cores and the three depthwise convs on the CUDA
// cores, overlapped across warps; one block of 16 warps per SM, held there
// by its 128 registers a thread, leaves little latency hidden at each
// step's barrier (PERF.md).
//
// ptxas (tools_torch_ptxas.py, CUDA 12.8, sm_90a), bf16 body with this
// epilogue: K = 7: 128 registers, 56 bytes spilled; K = 5: 128 registers,
// 4 bytes spilled; K = 3: 128 registers, no spills. Dynamic shared memory
// 167,424 / 153,984 / 141,312 bytes (creff_module_mma.cuh).

#include "creff_module.cuh"
#include "creff_module_mma.cuh"
#include "kernels.h"

namespace {

struct StoreFused {  // float32, CUDA-core body
  static constexpr int HALO = 0;
  float* out;  // [n, h, w, c]
  int c;

  __device__ __forceinline__ void chunk(int64_t pixel, int c0, const float f[creff::CC]) {
    float* o = out + pixel * c + c0;
#pragma unroll
    for (int cc = 0; cc < creff::CC; ++cc) o[cc] = f[cc];
  }
  __device__ __forceinline__ void finish(int64_t, bool) {}
};

struct StoreFusedMma {  // bfloat16, tensor-core body
  static constexpr int HALO = 0;
  struct State {};
  __nv_bfloat16* out;  // [n, h, w, c]
  int c;

  __device__ __forceinline__ void chunk(State&, const creff_mma::Seg& seg, int c0,
                                        const float acc[2][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    __syncwarp();  // the previous chunk's stores have read the scratch
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(seg.scratch + (g + 8 * r) * creff_mma::PS + 8 * nt + 2 * t) =
            creff_mma::pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
    __syncwarp();
    const int px = lane >> 1, half = (lane & 1) * 8;
    if (px >= seg.lo && px < seg.hi)
      *reinterpret_cast<uint4*>(out + (seg.pix0 + px) * c + c0 + half) =
          *reinterpret_cast<const uint4*>(seg.scratch + px * creff_mma::PS + half);
  }
  __device__ __forceinline__ void finish(State&, const creff_mma::Seg&) const {}
};

}  // namespace

extern "C" int arseg_creff_qkv_fused(void* out, const void* lr_up, const void* ref,
                                     const float* taps, const float* bias, int n, int h,
                                     int w, int c, int kh, int kw, int dtype, void* stream) {
  if (kh != kw || c % creff::CC != 0 || c <= 0 || n < 0 || h <= 0 || w <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const StoreFused epi{static_cast<float*>(out), c};
    return creff::launch_k(lr_up, ref, taps, bias, n, h, w, c, kh, epi, s);
  }
  if (dtype == 1) {
    if (reinterpret_cast<uintptr_t>(out) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
    const StoreFusedMma epi{static_cast<__nv_bfloat16*>(out), c};
    return creff_mma::launch_k(lr_up, ref, taps, bias, n, h, w, c, kh, epi, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
