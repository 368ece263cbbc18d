// K3: the fused CReFF module + 1x1 final_conv + argmax, NHWC:
//   pred[n,y,x] = argmax_k ( sum_c round_T(fused[n,y,x,c]) * fc_w[c,k] + fc_b[k] )
// with fused = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// (K1's function). The fused feature and the logits never reach device
// memory; the output is one int32 per pixel.
//
// Replaces: arseg_tpu/ops/pallas_creff.py creff_phase2_argmax
// (_qkv_head_kernel -> _fused_module_body, then a [C, n_classes] dot and
// argmax). The TPU kernel padded the classes to 128 lanes with a -inf bias
// and wrote int32 tiles of 128 lanes.
//
// bfloat16 runs the tensor-core body, creff_module_mma.cuh (banded
// mma.sync window products, cp.async halo staging a chunk ahead, 16 x 16
// tiles, K/V conv halo 1.89x at K = 7), and the 1x1 conv on the tensor
// cores too: each chunk's fused fragment, rounded to bf16 (the TPU
// kernel's fused.astype(in_dtype)), is repacked in registers as an m16k16
// A fragment and multiplied by fc_w in bf16 (its values are bf16 already,
// pack_head) with the classes padded to 24 by zero columns: three n8
// float32 accumulator tiles summed over the channel chunks. Then the
// float32 bias, and the argmax over the quad that holds a pixel's row,
// lowest index on ties, padded classes never chosen. float32 (the parity
// checks only) runs the CUDA-core body, creff_module.cuh, whose epilogue
// keeps each pixel's logits in registers and takes a strict '>'.
//
// Bound on the H100: at [11,720,960,64] bf16 (camvid-psp18 V1) the function
// reads lr_up and ref once (2 x 973 MB) and writes 30 MB of int32, about
// 0.59 ms at 3.35 TB/s; its ~134 GFLOP (K1's 251 flops per element plus
// 2 x 12 for the 1x1 conv) would take 0.13 ms at the bf16 tensor rate, so
// bytes bound it. The tensor-core body's limit is K1's: products and
// depthwise convs overlapped across warps, one block of 16 warps per SM
// held there by its 128 registers a thread (PERF.md).
//
// ptxas (tools_torch_ptxas.py, CUDA 12.8, sm_90a), bf16 body with this
// epilogue: K = 7: 128 registers, 64 bytes spilled; K = 5: 128 registers,
// no spills; K = 3: 126 registers, no spills. Dynamic shared memory
// 167,424 / 153,984 / 141,312 bytes (creff_module_mma.cuh).
//
// The LR form (arseg_creff_phase2_argmax_lr; replaces that kernel and the
// F.interpolate x2 align_corners=True resize before it in nn/pspnet.py):
// the same body and epilogue wrapped in creff_mma::LrUp read the LR
// feature [n, h_in, w_in, c <= 64] and build each tile's lr_up halo in
// shared memory, equal to F.interpolate's on the card bit for bit, so
// lr_up never reaches device memory. Bound at [11,360,480,64] ->
// [11,720,960,64]: the LR feature (243 MB) and ref (973 MB) read once and
// 30 MB of int32 written, about 0.37 ms at 3.35 TB/s (1.49 ms at 44
// frames); bytes bound it as above. Design (creff_module_mma.cuh, "The LR
// input"): pass 1 copies each chunk's LR halo (11 x 11 positions at x2)
// and lerps it a step ahead of the convs, keeping the 16 x 16 interior
// for pass 2's residual. Timed at 44 frames on the H100: 43.58 ms against
// 42.69 for the full-size form alone and 59.25 for the resize and it.
// ptxas: K = 7: 128 registers, 64 bytes of spill stores, 80 of loads;
// K = 5: 128 registers, 4 bytes spilled; K = 3: 123 registers, no spills.
// Dynamic shared memory at x2 and c = 64: 198,160 / 184,720 / 172,048
// bytes. float32 is not built in this form: its wrapper resizes first.

#include "creff_module.cuh"
#include "creff_module_mma.cuh"
#include "kernels.h"

namespace {

constexpr int MAX_CLASSES = 19;  // CamVid 12, Cityscapes 19
constexpr int CLASS_TILES = 3;   // n8 tiles: classes padded to 24

struct ArgmaxHead {  // float32, CUDA-core body
  static constexpr int HALO = 0;
  int32_t* out;         // [n, h, w]
  const float* fc_w;    // [c, n_classes]
  const float* fc_b;    // [n_classes]
  int n_classes;
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

struct ArgmaxHeadMma {  // bfloat16, tensor-core body
  static constexpr int HALO = 0;
  struct State {
    float logit[CLASS_TILES][4];  // accumulator tiles
  };
  int32_t* out;       // [n, h, w]
  const float* fc_w;  // [c, n_classes], values of bf16
  const float* fc_b;  // [n_classes]
  int n_classes;

  // fc_w[ch][cls] as bf16, zero for padded classes
  __device__ __forceinline__ float wt(int ch, int cls) const {
    return cls < n_classes ? __ldg(fc_w + ch * n_classes + cls) : 0.0f;
  }

  __device__ __forceinline__ void chunk(State& st, const creff_mma::Seg&, int c0,
                                        const float acc[2][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const uint32_t a[4] = {creff_mma::pack_bf16(acc[0][0], acc[0][1]),
                           creff_mma::pack_bf16(acc[0][2], acc[0][3]),
                           creff_mma::pack_bf16(acc[1][0], acc[1][1]),
                           creff_mma::pack_bf16(acc[1][2], acc[1][3])};
    const int ch = c0 + 2 * t;
#pragma unroll
    for (int ct = 0; ct < CLASS_TILES; ++ct) {
      if (8 * ct >= n_classes) break;
      const int cls = 8 * ct + g;
      const uint32_t b0 = creff_mma::pack_bf16(wt(ch, cls), wt(ch + 1, cls));
      const uint32_t b1 = creff_mma::pack_bf16(wt(ch + 8, cls), wt(ch + 9, cls));
      creff_mma::mma(st.logit[ct], a, b0, b1);
    }
  }

  __device__ __forceinline__ void finish(State& st, const creff_mma::Seg& seg) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // this lane's classes 8ct + 2t + e in increasing order: strict '>'
      // keeps the lowest index of a tie; best < 0 until a class is seen
      float best_v = 0.0f;
      int best = -1;
#pragma unroll
      for (int ct = 0; ct < CLASS_TILES; ++ct)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cls = 8 * ct + 2 * t + e;
          if (cls < n_classes) {
            const float v = st.logit[ct][2 * r + e] + __ldg(fc_b + cls);
            if (best < 0 || v > best_v) {
              best_v = v;
              best = cls;
            }
          }
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, best, off);
        if (oi >= 0 && (best < 0 || ov > best_v || (ov == best_v && oi < best))) {
          best_v = ov;
          best = oi;
        }
      }
      const int px = g + 8 * r;
      if (t == 0 && px >= seg.lo && px < seg.hi) out[seg.pix0 + px] = best;
    }
  }
};

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
  if (dtype == 0) {
    ArgmaxHead epi{};
    epi.out = out;
    epi.fc_w = fc_w;
    epi.fc_b = fc_b;
    epi.n_classes = n_classes;
    return creff::launch_k(lr_up, ref, taps, bias, n, h, w, c, kh, epi, s);
  }
  if (dtype == 1) {
    const ArgmaxHeadMma epi{out, fc_w, fc_b, n_classes};
    return creff_mma::launch_k(lr_up, ref, taps, bias, n, h, w, c, kh, epi, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The LR form: lr [n, h_in, w_in, c] is the LR feature, h_in <= h,
// w_in <= w and c <= 64, and the module reads its bilinear
// align_corners=True resize to h x w (F.interpolate's on the card, bit for
// bit), built tile by tile in shared memory (creff_mma::LrUp). bfloat16
// alone: float32 (the parity checks) resizes first and launches
// arseg_creff_phase2_argmax.
extern "C" int arseg_creff_phase2_argmax_lr(int32_t* out, const void* lr, const void* ref,
                                            const float* taps, const float* bias,
                                            const float* fc_w, const float* fc_b, int n,
                                            int h_in, int w_in, int h, int w, int c,
                                            int n_classes, int kh, int kw, int dtype,
                                            void* stream) {
  if (kh != kw || c % creff_mma::CC != 0 || c <= 0 || n < 0 || h <= 0 || w <= 0 || n > 65535 ||
      n_classes < 1 || n_classes > MAX_CLASSES || h_in < 1 || w_in < 1 || h_in > h ||
      w_in > w || c > creff_mma::LR_MAX_C || dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // PyTorch's area_pixel_compute_scale for align_corners=True, in float32
  const float rh = h > 1 ? static_cast<float>(h_in - 1) / (h - 1) : 0.0f;
  const float rw = w > 1 ? static_cast<float>(w_in - 1) / (w - 1) : 0.0f;
  // the most LR rows and columns a tile reads: the staged halo's size
  int rows = 0, cols = 0;
  for (int y0 = 0; y0 < h; y0 += creff_mma::TH) {
    const int k = creff_mma::lr_count(rh, y0, h, h_in);
    rows = k > rows ? k : rows;
  }
  for (int x0 = 0; x0 < w; x0 += creff_mma::TW) {
    const int k = creff_mma::lr_count(rw, x0, w, w_in);
    cols = k > cols ? k : cols;
  }
  if (rows > creff_mma::LRS || cols > creff_mma::LRS)
    return static_cast<int>(cudaErrorInvalidValue);
  const creff_mma::LrUp<ArgmaxHeadMma> epi{
      {out, fc_w, fc_b, n_classes}, h_in, w_in, rh, rw, rows * cols * creff_mma::CC};
  return creff_mma::launch_k(lr, ref, taps, bias, n, h, w, c, kh, epi,
                             static_cast<cudaStream_t>(stream));
}
