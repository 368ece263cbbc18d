// K4: windowed local attention, NHWC:
//   out[n,y,x,:] = sum_o p[o] * v[n, y+dy-P, x+dx-P, :],
//   p = softmax_o(sum_c q[n,y,x,c] * k[n, y+dy-P, x+dx-P, c])
// over a K x K window (o = dy*K + dx, P = K/2). Window positions outside
// the image give logit 0 and value 0, as nn.Unfold's zero padding does.
// q, k, v and out share one shape; the caller computes Q, K and V, so there
// is no depthwise conv and no residual (K1 adds both).
//
// Replaces: arseg_tpu/ops/pallas_creff.py creff_fused_pallas (_kernel), the
// TPU kernel behind ops/local_attention.creff_attention that every fusion
// variant of the "local" family but "local" itself runs. The TPU kernel
// streamed K/V halo windows by manual DMA and ran the window as a banded
// matmul on the MXU, with the band mask as -inf logits; here the window
// sits in shared memory and each thread walks its own 7x7 neighbourhood on
// the CUDA cores, so no band and no mask are needed.
//
// Design: K1's window loop without its first stage (creff_module.cuh). One
// block of TH x TW threads per output tile, one thread per pixel; channels
// in chunks of CC. Pass 1, per chunk: stage the K halo tile
// (TH + K - 1) x (TW + K - 1) in shared memory (zero outside the image),
// read the thread's own Q chunk, and add q . k into K*K float32 logits held
// in registers. Softmax in float32; p rounded to the input type, as the
// TPU kernel does before its second product. Pass 2, per chunk: stage the
// V halo tile and sum p . v in float32; the output is rounded once.
//
// Bound on the H100: at [11,90,120,256] bf16 the function reads q, k, v
// and writes out once (4 x 60.8 MB), about 0.073 ms at 3.35 TB/s; its
// 2 x 49 multiply-adds per element (~5.9 GFLOP) would take 6 us at the bf16
// tensor rate, so bytes bound it. This first kernel is bound instead, as
// K1 is, by one shared-memory load per multiply-add in the window products.

#include "creff_module.cuh"
#include "kernels.h"

namespace {

using creff::CC;
using creff::TH;
using creff::TW;

template <typename T, int K>
__global__ void __launch_bounds__(TH* TW)
    attention_kernel(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, int h, int w, int c) {
  using G = creff::Geom<K>;
  __shared__ float kv_s[CC * G::KS];  // [CC][KS] K (pass 1) or V (pass 2)

  const int py = threadIdx.x / TW;
  const int px = threadIdx.x % TW;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int gy = y0 + py;
  const int gx = x0 + px;
  const bool inside = gy < h && gx < w;
  const int64_t plane = static_cast<int64_t>(h) * w * c;
  const int64_t at = blockIdx.z * plane + (static_cast<int64_t>(gy) * w + gx) * c;
  const T* k_img = k + blockIdx.z * plane;
  const T* v_img = v + blockIdx.z * plane;

  float s[K * K];
#pragma unroll
  for (int o = 0; o < K * K; ++o) s[o] = 0.0f;

  // ---- pass 1: logits --------------------------------------------------
  for (int c0 = 0; c0 < c; c0 += CC) {
    __syncthreads();  // the previous chunk's readers are done
    creff::stage_tile(kv_s, k_img, h, w, c, y0 - G::P, x0 - G::P, G::KH, G::KW, G::KS, c0);
    __syncthreads();
    float qc[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) qc[cc] = inside ? creff::to_f32(q[at + c0 + cc]) : 0.0f;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {
      const float* kb = kv_s + cc * G::KS + py * G::KW + px;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) s[dy * K + dx] = fmaf(qc[cc], kb[dy * G::KW + dx], s[dy * K + dx]);
      }
    }
  }

  // ---- softmax in float32, p rounded to T ------------------------------
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
  for (int o = 0; o < K * K; ++o) s[o] = creff::round_to<T>(s[o] / sum);

  // ---- pass 2: p . v -----------------------------------------------------
  for (int c0 = 0; c0 < c; c0 += CC) {
    __syncthreads();
    creff::stage_tile(kv_s, v_img, h, w, c, y0 - G::P, x0 - G::P, G::KH, G::KW, G::KS, c0);
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
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) out[at + c0 + cc] = creff::from_f32<T>(acc[cc]);
    }
  }
}

template <typename T, int K>
int launch(void* out, const void* q, const void* k, const void* v, int n, int h, int w, int c,
           cudaStream_t stream) {
  if (n == 0) return 0;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  attention_kernel<T, K><<<grid, TH * TW, 0, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), h, w, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(void* out, const void* q, const void* k, const void* v, int n, int h, int w, int c,
             int kk, cudaStream_t stream) {
  switch (kk) {
    case 3: return launch<T, 3>(out, q, k, v, n, h, w, c, stream);
    case 5: return launch<T, 5>(out, q, k, v, n, h, w, c, stream);
    case 7: return launch<T, 7>(out, q, k, v, n, h, w, c, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int arseg_creff_attention(void* out, const void* q, const void* k, const void* v,
                                     int n, int h, int w, int c, int kh, int kw, int dtype,
                                     void* stream) {
  if (kh != kw || c % CC != 0 || c <= 0 || n < 0 || h <= 0 || w <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_k<float>(out, q, k, v, n, h, w, c, kh, s);
  if (dtype == 1) return launch_k<__nv_bfloat16>(out, q, k, v, n, h, w, c, kh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
