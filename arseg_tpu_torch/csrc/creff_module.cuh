// The fused CReFF module body (MyAttention forward) on the CUDA cores,
// NHWC, for float32 inputs only, which only the parity checks use: K1
// (creff_qkv_fused.cu), K3 (creff_phase2_argmax.cu) and K5
// (creff_phase2_upsample_argmax.cu, HALO = 1) run it for float32, and K4's
// float32 kernel (creff_attention.cu) its staging. bfloat16 inputs run the
// tensor-core body, creff_module_mma.cuh; a TF32 product there would not
// hold the float32 tolerance. The function:
//   fused = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// over a K x K window, where dw3 is a 3x3 depthwise conv with bias and
// similar/weighting follow nn.Unfold: window positions outside the image
// contribute logit 0 and value 0 (K and V are masked to 0 there, bias
// included).
//
// Design: one block of TH x TW threads per output tile, one thread per
// output pixel. Channels go in chunks of CC. Pass 1, per chunk: stage the
// ref halo tile (tile + K + 1) and the lr_up halo tile (tile + 2) in shared
// memory, compute the K chunk over tile + K - 1 (masked to the image) and
// each thread's own Q chunk, and add q . k into the thread's K*K float32
// logits held in registers. Softmax in float32 in registers. Pass 2, per
// chunk: stage the ref halo again, compute the V chunk, and each thread sums
// p . v for its pixel, adds the residual and hands the CC float32 fused
// values to the epilogue. Shared arrays are channel-major with an odd
// channel stride, so neighbouring threads read neighbouring words. All sums
// are float32 (the TPU kernel's roundings of Q, K, V and p to the input
// type are the identity here).
//
// An epilogue is a struct with
//   static constexpr int HALO;
//   __device__ void chunk(int64_t pixel, int c0, const float f[CC]);
//   __device__ void finish(int64_t pixel, bool inside);
// `pixel` is the flat (image, row, col) index of the thread's output pixel;
// chunk() is called only for pixels inside the image, once per channel
// chunk in order; finish() once per thread after the last chunk, by every
// thread of the block (so it may synchronise the block). Each thread owns
// a copy of the epilogue, so its members live in registers. With HALO = 0
// the tiles partition the image; with HALO = 1 they overlap by one pixel
// on each side: a block's TH x TW tile starts one row and one column
// before its (TH - 2) x (TW - 2) interior, and pixels outside the image
// arrive with inside = false.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace creff {

constexpr int TH = 8;   // output tile rows
constexpr int TW = 16;  // output tile cols (TH * TW threads)
constexpr int CC = 16;  // channels per chunk

template <int K>
struct Geom {
  static constexpr int P = K / 2;
  static constexpr int RH = TH + K + 1, RW = TW + K + 1;  // ref halo tile
  static constexpr int KH = TH + K - 1, KW = TW + K - 1;  // K/V positions
  static constexpr int LH = TH + 2, LW = TW + 2;          // lr_up halo tile
  static constexpr int RS = (RH * RW) | 1;                // odd channel strides
  static constexpr int KS = (KH * KW) | 1;
  static constexpr int LS = (LH * LW) | 1;
  static constexpr int SMEM_FLOATS = CC * (RS + KS + LS);
};

// Stage rows [ty0, ty0+rows) x cols [tx0, tx0+cols) x channels [c0, c0+CC)
// of one image into dst[cc * stride + pos] as float32; zero outside it.
__device__ inline void stage_tile(float* dst, const float* __restrict__ img, int h, int w, int c,
                                  int ty0, int tx0, int rows, int cols, int stride, int c0) {
  const int total = rows * cols * CC;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int cc = t % CC;
    const int pos = t / CC;
    const int gy = ty0 + pos / cols;
    const int gx = tx0 + pos % cols;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = img[(static_cast<int64_t>(gy) * w + gx) * c + c0 + cc];
    dst[cc * stride + pos] = v;
  }
}

// Depthwise 3x3 (+bias) of the staged ref tile at every K/V position of the
// block, masked to 0 outside the image. Taps are summed in
// the TPU kernel's order (columns outer, rows inner), then the bias.
template <int K>
__device__ void dw_kv(float* kv, const float* r, const float* __restrict__ taps,
                      const float* __restrict__ bias, int h, int w, int c, int c0,
                      int y0, int x0) {
  using G = Geom<K>;
  const int total = G::KH * G::KW * CC;
  for (int t = threadIdx.x; t < total; t += blockDim.x) {
    const int pos = t % (G::KH * G::KW);
    const int cc = t / (G::KH * G::KW);
    const int kr = pos / G::KW;
    const int kc = pos % G::KW;
    const int gy = y0 - G::P + kr;
    const int gx = x0 - G::P + kc;
    float acc = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const float* rb = r + cc * G::RS + kr * G::RW + kc;
      bool first = true;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float term = __fmul_rn(rb[a * G::RW + b], taps[(a * 3 + b) * c + c0 + cc]);
          acc = first ? term : __fadd_rn(acc, term);
          first = false;
        }
      }
      acc = __fadd_rn(acc, bias[c0 + cc]);
    }
    kv[cc * G::KS + pos] = acc;
  }
}

// Grid: (ceil(w / SW), ceil(h / SH), n) with SW = TW - 2 HALO and
// SH = TH - 2 HALO; TH * TW threads; dynamic shared memory
// Geom<K>::SMEM_FLOATS floats.
template <int K, class Epi>
__global__ void __launch_bounds__(TH* TW)
    module_kernel(const float* __restrict__ lr, const float* __restrict__ ref,
                  const float* __restrict__ taps, const float* __restrict__ bias, int h, int w,
                  int c, Epi epi_arg) {
  using G = Geom<K>;
  constexpr int HALO = Epi::HALO;
  Epi epi = epi_arg;  // this thread's own epilogue state
  extern __shared__ float smem[];
  float* r_s = smem;               // [CC][RS] ref halo
  float* kv_s = r_s + CC * G::RS;  // [CC][KS] K (pass 1) or V (pass 2)
  float* l_s = kv_s + CC * G::KS;  // [CC][LS] lr_up halo

  const int py = threadIdx.x / TW;
  const int px = threadIdx.x % TW;
  const int y0 = blockIdx.y * (TH - 2 * HALO) - HALO;
  const int x0 = blockIdx.x * (TW - 2 * HALO) - HALO;
  const int64_t plane = static_cast<int64_t>(h) * w * c;
  const float* lr_img = lr + blockIdx.z * plane;
  const float* ref_img = ref + blockIdx.z * plane;
  const float* q_taps = taps;
  const float* k_taps = taps + 9 * c;
  const float* v_taps = taps + 18 * c;

  float s[K * K];
#pragma unroll
  for (int o = 0; o < K * K; ++o) s[o] = 0.0f;

  // ---- pass 1: logits --------------------------------------------------
  for (int c0 = 0; c0 < c; c0 += CC) {
    __syncthreads();  // the previous chunk's readers are done
    stage_tile(r_s, ref_img, h, w, c, y0 - G::P - 1, x0 - G::P - 1, G::RH, G::RW, G::RS, c0);
    stage_tile(l_s, lr_img, h, w, c, y0 - 1, x0 - 1, G::LH, G::LW, G::LS, c0);
    __syncthreads();
    dw_kv<K>(kv_s, r_s, k_taps, bias + c, h, w, c, c0, y0, x0);
    float q[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const float* lb = l_s + cc * G::LS + py * G::LW + px;
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float term = __fmul_rn(lb[a * G::LW + b], q_taps[(a * 3 + b) * c + c0 + cc]);
          acc = (a == 0 && b == 0) ? term : __fadd_rn(acc, term);
        }
      }
      q[cc] = __fadd_rn(acc, bias[c0 + cc]);
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const float* kb = kv_s + cc * G::KS + py * G::KW + px;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) s[dy * K + dx] = fmaf(q[cc], kb[dy * G::KW + dx], s[dy * K + dx]);
      }
    }
  }

  // ---- softmax in float32 ------------------------------------------------
  float m = s[0];
#pragma unroll
  for (int o = 1; o < K * K; ++o) m = fmaxf(m, s[o]);
  float sum = 0.0f;
#pragma unroll
  for (int o = 0; o < K * K; ++o) {
    s[o] = expf(s[o] - m);
    sum += s[o];
  }
#pragma unroll
  for (int o = 0; o < K * K; ++o) s[o] = s[o] / sum;

  // ---- pass 2: p . v + residual -> epilogue ------------------------------
  const int gy = y0 + py;
  const int gx = x0 + px;
  const bool inside = gy >= 0 && gx >= 0 && gy < h && gx < w;
  const int64_t pixel = (static_cast<int64_t>(blockIdx.z) * h + gy) * w + gx;
  for (int c0 = 0; c0 < c; c0 += CC) {
    __syncthreads();
    stage_tile(r_s, ref_img, h, w, c, y0 - G::P - 1, x0 - G::P - 1, G::RH, G::RW, G::RS, c0);
    __syncthreads();
    dw_kv<K>(kv_s, r_s, v_taps, bias + 2 * c, h, w, c, c0, y0, x0);
    __syncthreads();
    if (inside) {
      float acc[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) acc[cc] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float p = s[dy * K + dx];
          const float* vb = kv_s + (py + dy) * G::KW + px + dx;
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) acc[cc] = fmaf(p, vb[cc * G::KS], acc[cc]);
        }
      }
      const float* res = lr_img + (static_cast<int64_t>(gy) * w + gx) * c + c0;
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) acc[cc] = res[cc] + acc[cc];
      epi.chunk(pixel, c0, acc);
    }
  }
  epi.finish(pixel, inside);
}

template <int K, class Epi>
int launch(const void* lr, const void* ref, const float* taps, const float* bias, int n, int h,
           int w, int c, const Epi& epi, cudaStream_t stream) {
  if (n == 0) return 0;
  const size_t smem = sizeof(float) * Geom<K>::SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(module_kernel<K, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int SH = TH - 2 * Epi::HALO, SW = TW - 2 * Epi::HALO;  // tile strides
  const dim3 grid((w + SW - 1) / SW, (h + SH - 1) / SH, n);
  module_kernel<K, Epi><<<grid, TH * TW, smem, stream>>>(
      static_cast<const float*>(lr), static_cast<const float*>(ref), taps, bias, h, w, c, epi);
  return static_cast<int>(cudaGetLastError());
}

// K in {3, 5, 7}; any other window is refused.
template <class Epi>
int launch_k(const void* lr, const void* ref, const float* taps, const float* bias, int n, int h,
             int w, int c, int k, const Epi& epi, cudaStream_t stream) {
  switch (k) {
    case 3: return launch<3>(lr, ref, taps, bias, n, h, w, c, epi, stream);
    case 5: return launch<5>(lr, ref, taps, bias, n, h, w, c, epi, stream);
    case 7: return launch<7>(lr, ref, taps, bias, n, h, w, c, epi, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace creff
