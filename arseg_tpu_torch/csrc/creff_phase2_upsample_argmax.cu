// K5: the fused CReFF module + 1x1 final_conv + x8 bilinear upsample
// (align_corners=False) + argmax, NHWC in, int32 [n, 8h, 8w] out:
//   logit[k]  = round_T(sum_c fused[c] * fc_w[c,k])        per fused pixel
//   col       = round_T(lerp over columns of logit)        x8 along w
//   row       = lerp over rows of col, in float32          x8 along h
//   pred      = argmax_k(row[k] + fc_b[k])                 lowest index on ties
// with fused = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// in float32, not rounded before the 1x1 conv. Neither the fused feature
// nor a logit plane reaches device memory: only the class map.
//
// Replaces: arseg_tpu/ops/pallas_creff.py creff_phase2_upsample_argmax
// (_qkv_upsample_head_kernel), the BiSeNet inference head under
// USE_FUSED_UPSAMPLE_HEAD. The rounding follows that kernel: per-class
// logits summed in float32 over the unrounded fused feature (jnp.sum(fused
// * wc), unlike K3, which rounds the fused feature first) and rounded to
// the input type, the column interpolation summed in float32 and rounded,
// the row interpolation in float32, the float32 bias added after the
// upsample (the interpolation weights of each output sum to one), a strict
// '>' in the argmax. The TPU kernel needed full-width rows (w <= 128) for
// its column-upsample matmul on 128-lane tiles; nothing here depends on the
// width, so that limit is not carried over.
//
// Neighbours' logits: output row 8r + j reads fused rows r-1..r+1, and the
// same holds for columns. So the blocks overlap (the epilogue's HALO = 1):
// each computes the module on a tile that holds its interior and a
// one-pixel ring, keeps the tile's logits in shared memory and writes the
// outputs of its interior. At the image border the source index is clamped
// to [0, h-1] as F.interpolate clamps it; the ring outside the image is
// computed on zero-filled halos and never read.
//
// bfloat16 (the served path) runs the tensor-core body, creff_module_mma.cuh
// (banded mma.sync window products, cp.async staging, depthwise convs on
// the CUDA cores), with HALO = 1: 16 x 16 tiles, 14 x 14 interiors, 256 /
// 196 = 1.31x the module's work of a partition. The epilogue:
// - The 1x1 conv in float32 on the unrounded fused fragment. A chunk's
//   [16 px, 16 ch] fragment goes through the warp's shared scratch as
//   float32, and the four lanes of a quad split the classes (lane t takes
//   t, t + 4, ...; five at most) over all 16 channels of its two pixels,
//   so each lane holds whole logits, 10 float32, and needs no reduction.
// - After pass 2 and a block barrier the module's shared memory is free:
//   the tile's 16 x 16 logits per class, rounded to bf16; then the column
//   pass once per fused row, col[class][row][ox] = round_bf16(lerp of the
//   row's two source columns) for the 16 rows x 112 output columns of the
//   interior (the TPU kernel's order, columns first); then the row pass,
//   one item per 4 output rows (half of a fused row's 8, which share their
//   two source rows) x 4 output columns: lerp(col[r0], col[r1]) + fc_b in
//   float32, a strict '>' argmax class by class, 16-byte int32 stores.
//   The x8 weights are multiples of 1/16, exact in bf16.
// - Waves: at [11,90,120] the interior tiling is 9 x 7 x 11 = 693 blocks,
//   5.25 waves at one block per SM on 132 SMs; the last wave runs a quarter
//   full.
// - Registers (tools_torch_ptxas.py, CUDA 12.8, sm_90a): K = 7: 128, 188
//   bytes spilled; K = 5 and 3: 128, none. Dynamic shared memory as K1's,
//   167,424 / 153,984 / 141,312 bytes; the epilogue reuses 77,824 of them.
//   The SASS shows what the spill slots hold: the per-thread addresses of
//   the unrolled halo-copy loops, reloaded once per chunk. The classes'
//   logits (10 float32 a lane) and the epilogue's fields (a
//   __grid_constant__ parameter) are not among them, so moving the logits
//   to shared memory would not remove the spills.
//   Development builds without the 1x1 conv or the upsample epilogue put
//   its time at 0.80 ms module, ~0.23 conv, ~0.08 epilogue (PERF.md).
// float32 (the parity checks only) runs the CUDA-core body,
// creff_module.cuh, with the same epilogue on 8 x 16 tiles.
//
// Bound on the H100: at [11,90,120,256] bf16 the function reads lr_up and
// ref once (2 x 60.8 MB) and writes a 30.4 MB int32 map, about 0.045 ms at
// 3.35 TB/s; its ~8.4 GFLOP (K1's 251 per element, 2 x 12 for the 1x1
// conv, the upsample's 12 x 6 per output) would take 9 us at the bf16
// tensor rate, so bytes bound it. The module body bounds the kernel as it
// bounds K1 (PERF.md), times the 1.31x overlap.

#include "creff_module.cuh"
#include "creff_module_mma.cuh"
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

struct UpsampleArgmaxHead {  // float32, CUDA-core body
  static constexpr int HALO = 1;
  int32_t* out;         // [n, UP h, UP w]
  const float* fc_w;    // [c, n_classes]
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
    float* lg = smem;  // [MAX_CLASSES][TH * TW] logits of the tile
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MAX_CLASSES; ++k)
      if (k < n_classes) lg[k * TH * TW + threadIdx.x] = inside ? logit[k] : 0.0f;
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
          const float top =
              __fadd_rn(__fmul_rn(a0[off + c0], 1.0f - wx), __fmul_rn(a0[off + c1], wx));
          const float bot =
              __fadd_rn(__fmul_rn(a1[off + c0], 1.0f - wx), __fmul_rn(a1[off + c1], wx));
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

constexpr int CLS_PER_LANE = (MAX_CLASSES + 3) / 4;  // lane t of a quad: classes t + 4i
constexpr int FS = 20;  // float32 row stride of a warp's fused fragment in its scratch
constexpr int CO = (creff_mma::TW - 2) * UP;  // output columns of a tile's interior: 112

struct UpsampleArgmaxHeadMma {  // bfloat16, tensor-core body
  static constexpr int HALO = 1;
  struct State {
    float logit[2][CLS_PER_LANE];  // pixel g + 8r, class t + 4i
  };
  int32_t* out;       // [n, UP h, UP w]
  const float* fc_w;  // [c, n_classes], values of bf16
  const float* fc_b;  // [n_classes] float32
  int n_classes, h, w;

  // the 1x1 conv of one chunk in float32: the fragment through the warp's
  // scratch, each lane over all 16 channels of its two pixels and its classes
  __device__ __forceinline__ void chunk(State& st, const creff_mma::Seg& seg, int c0,
                                        const float acc[2][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float* f = reinterpret_cast<float*>(seg.scratch);  // [16 px][FS] float32
    __syncwarp();  // the previous chunk's reads are done
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(f + (g + 8 * r) * FS + 8 * nt + 2 * t) =
            make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    __syncwarp();
#pragma unroll
    for (int q4 = 0; q4 < creff_mma::CC / 4; ++q4) {
      const float4 a = *reinterpret_cast<const float4*>(f + g * FS + 4 * q4);
      const float4 b = *reinterpret_cast<const float4*>(f + (g + 8) * FS + 4 * q4);
      const float fa[4] = {a.x, a.y, a.z, a.w}, fb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* wrow = fc_w + (c0 + 4 * q4 + e) * n_classes + t;
#pragma unroll
        for (int i = 0; i < CLS_PER_LANE; ++i)
          if (t + 4 * i < n_classes) {
            const float wv = __ldg(wrow + 4 * i);
            st.logit[0][i] = fmaf(fa[e], wv, st.logit[0][i]);
            st.logit[1][i] = fmaf(fb[e], wv, st.logit[1][i]);
          }
      }
    }
  }

  __device__ __forceinline__ void finish(State& st, const creff_mma::Seg&) const {
    using creff_mma::NT;
    using creff_mma::TH;
    using creff_mma::TW;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, py = threadIdx.x >> 5;
    extern __shared__ __align__(16) unsigned char head_smem[];
    __nv_bfloat16* lg = reinterpret_cast<__nv_bfloat16*>(head_smem);  // [class][TH][TW]
    __nv_bfloat16* col = lg + MAX_CLASSES * TH * TW;                  // [class][TH][CO]
    __syncthreads();  // every warp is done with the module's shared memory
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < CLS_PER_LANE; ++i)
        if (t + 4 * i < n_classes)
          lg[((t + 4 * i) * TH + py) * TW + g + 8 * r] = __float2bfloat16_rn(st.logit[r][i]);
    __syncthreads();

    const int y0 = blockIdx.y * (TH - 2) - 1, x0 = blockIdx.x * (TW - 2) - 1;  // the tile's origin
    const int rows = min(TH - 2, h - (y0 + 1));      // fused rows of the interior
    const int n_ox = min(TW - 2, w - (x0 + 1)) * UP;  // output columns of the interior
    const int ox0 = (x0 + 1) * UP;
    // column pass, two output columns an item: col = round_bf16(lerp)
    const int pairs = n_ox / 2;
    for (int i = threadIdx.x; i < n_classes * TH * pairs; i += NT) {
      const int pr = i % pairs, cr = i / pairs;  // cr = class * TH + tile row
      const __nv_bfloat16* src = lg + cr * TW - x0;  // indexed by image column
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int c0, c1;
        float wx;
        taps(ox0 + 2 * pr + e, w, c0, c1, wx);
        v[e] = __fadd_rn(__fmul_rn(__bfloat162float(src[c0]), 1.0f - wx),
                         __fmul_rn(__bfloat162float(src[c1]), wx));
      }
      *reinterpret_cast<uint32_t*>(col + cr * CO + 2 * pr) = creff_mma::pack_bf16(v[0], v[1]);
    }
    __syncthreads();

    // row pass: an item is 4 output rows x 4 output columns. The 4 rows are
    // one half of a fused row's 8 and share their source rows r0, r1.
    const int quads = n_ox / 4;
    const int oh = UP * h, ow = UP * w;
    int32_t* o_img = out + static_cast<int64_t>(blockIdx.z) * oh * ow;
    for (int i = threadIdx.x; i < rows * 2 * quads; i += NT) {
      const int qd = i % quads, hf = i / quads;  // hf = 2 * interior row + half
      const int oy0 = (y0 + 1) * UP + 4 * hf;
      int r0 = 0, r1 = 0;
      float wy[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int i0, i1;
        taps(oy0 + j, h, i0, i1, wy[j]);
        if (j == 0) {
          r0 = i0;
          r1 = i1;
        }
      }
      const __nv_bfloat16* top = col + (r0 - y0) * CO + 4 * qd;
      const __nv_bfloat16* bot = col + (r1 - y0) * CO + 4 * qd;
      float best_v[4][4];
      int best[4][4];
      for (int k = 0; k < n_classes; ++k) {
        const uint2 ta = *reinterpret_cast<const uint2*>(top + k * TH * CO);
        const uint2 tb = *reinterpret_cast<const uint2*>(bot + k * TH * CO);
        const float2 a01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ta.x));
        const float2 a23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ta.y));
        const float2 b01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&tb.x));
        const float2 b23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&tb.y));
        const float a[4] = {a01.x, a01.y, a23.x, a23.y}, b[4] = {b01.x, b01.y, b23.x, b23.y};
        const float fb = __ldg(fc_b + k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v =
                __fadd_rn(__fadd_rn(__fmul_rn(a[e], 1.0f - wy[j]), __fmul_rn(b[e], wy[j])), fb);
            if (k == 0 || v > best_v[j][e]) {
              best_v[j][e] = v;
              best[j][e] = k;
            }
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<int4*>(o_img + static_cast<int64_t>(oy0 + j) * ow + ox0 + 4 * qd) =
            make_int4(best[j][0], best[j][1], best[j][2], best[j][3]);
    }
  }
};

}  // namespace

extern "C" int arseg_creff_phase2_upsample_argmax(int32_t* out, const void* lr_up,
                                                  const void* ref, const float* taps,
                                                  const float* bias, const float* fc_w,
                                                  const float* fc_b, int n, int h, int w, int c,
                                                  int n_classes, int kh, int kw, int dtype,
                                                  void* stream) {
  // the tile's logits must fit the module's shared memory (smallest: K = 3)
  static_assert(MAX_CLASSES * creff::TH * creff::TW <= creff::Geom<3>::SMEM_FLOATS, "smem");
  static_assert(2 * MAX_CLASSES * creff_mma::TH * (creff_mma::TW + CO) <=
                    creff_mma::Geom<3>::SMEM_BYTES, "smem");
  static_assert(creff_mma::TW * FS * 4 <= 2 * creff_mma::TW * creff_mma::PS * 2, "scratch");
  if (kh != kw || c % creff::CC != 0 || c <= 0 || n < 0 || h <= 0 || w <= 0 || n > 65535 ||
      n_classes < 1 || n_classes > MAX_CLASSES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    UpsampleArgmaxHead epi{};
    epi.out = out;
    epi.fc_w = fc_w;
    epi.fc_b = fc_b;
    epi.n_classes = n_classes;
    epi.h = h;
    epi.w = w;
    return creff::launch_k(lr_up, ref, taps, bias, n, h, w, c, kh, epi, s);
  }
  if (dtype == 1) {
    if (reinterpret_cast<uintptr_t>(out) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
    const UpsampleArgmaxHeadMma epi{out, fc_w, fc_b, n_classes, h, w};
    return creff_mma::launch_k(lr_up, ref, taps, bias, n, h, w, c, kh, epi, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
