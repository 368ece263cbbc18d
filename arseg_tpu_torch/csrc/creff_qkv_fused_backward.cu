// K1B: the backward of K1, the fused CReFF module (MyAttention), NHWC.
// Given g = d out for
//   q = dw3(lr_up; Wq, bq), k = dw3(ref; Wk, bk), v = dw3(ref; Wv, bv)
//   s[p,o] = q[p] . k[p+o],  P = softmax_o(s),  out = lr_up + sum_o P[p,o] v[p+o]
// over a K x K window (K and V zero at window positions outside the image,
// so logit 0 and value 0 there, as K1 and nn.Unfold), it computes
//   dP[p,o] = g[p] . v[p+o],  dS = P (dP - sum_o P dP)
//   dq[p] = sum_o dS[p,o] k[p+o]
//   dk[r] = sum_o dS[r-o,o] q[r-o],  dv[r] = sum_o P[r-o,o] g[r-o]
//   d lr_up = g + dw3^T(dq; Wq),  d ref = dw3^T(dk; Wk) + dw3^T(dv; Wv)
//   dW[c, a*3+b], db[c] of each conv: pixel sums of dq, dk, dv times the
//   input shifted by (a-1, b-1), and of dq, dk, dv alone.
// Q, K, V and P are rounded to the input type as K1 rounds them (the
// identity for float32); every sum is float32; d lr_up and d ref are
// rounded once to the input type, the weight gradients are float32.
//
// Replaces no TPU kernel: the JAX package's custom_vjp
// (arseg_tpu/ops/local_attention.py creff_local_module) re-derives the
// gradients through composed ops, and the port did the same
// (torch.autograd.grad over module_composed). At an FST stage-2 step's
// [16,90,120,256] bf16 that re-run took half the step, in about a thousand
// launches that each wrote a [16,90,120,256] tensor. K1B was added to take
// its place.
//
// Bound on the H100: at [16,90,120,256] bf16 the function must read lr_up,
// ref and g and write d lr_up (354 MB), and d ref where asked (442 MB):
// 0.106-0.132 ms at 3.35 TB/s. Its window products are 5 x 49 multiply-adds
// an element (s, dP, dq, dk, dv; 10.8 GMAC at that shape), its convs 72
// (recomputed q, k, v; three transposed convs; three weight gradients).
//
// Design: five launches on the caller's stream, all in float32 arithmetic
// on the CUDA cores for both input types, writing their intermediates to a
// workspace the caller allocates (arseg_creff_qkv_fused_backward_workspace):
//   1. qkv_convs: q, k, v in the input type (K1's convs, summed in its
//      order, so the same bits).
//   2. window_pass1, a thread a pixel over 4 x 32 tiles: the logits and dP
//      over 16-channel chunks of the K and V halos staged in shared memory,
//      the softmax and dS in registers, P and dS written as float32 planes
//      [n, K*K, h, w] (stores coalesced along a row), then dq from a second
//      sweep over the K halo.
//   3. window_pass2, a thread a key position over the same tiles: the K*K
//      values of dS that reach it, read once from their plane (each
//      (pixel, offset) pair is read by exactly one key position, so the
//      gather needs no halo of dS and no atomics), then dk over chunks of
//      the Q halo; then dv from P and the g halo the same way.
//   4. conv_t: d lr_up, d ref (skipped when not asked for) and the 30
//      weight-gradient sums of each channel; the 16 rows of a block are
//      summed in shared memory in a fixed order and written as one partial
//      per block, [parts, 30, c].
//   5. reduce_parts: the partials summed over blocks in a fixed order.
// Both conv kernels give a thread a (row, channel) that walks a 64-column
// segment with 3 x 3 register windows, so each input value is loaded
// about three times (once a row of its window) and the taps once.
// No float atomics: two launches on the same inputs give the same bits.
// The window products run on the CUDA cores, one shared-memory read a
// multiply-add (the float32 body of K1, creff_module.cuh, is held to the
// same rate): at the cell's shape ~10.8 G reads, ~0.9 ms of the H100's
// shared-memory bandwidth, against ~0.35 ms of memory traffic for the
// workspace. Within a 16-channel chunk window_pass1 takes 4 channels at a
// time and window_pass2 makes one product a sweep, which keeps each
// unrolled body to at most 16 x K x K multiply-adds (both passes' whole
// chunks unrolled took nvcc a minute for this file). The tensor-core route
// (K1's creff_module_mma.cuh) would also need dS and g rounded to bf16 for
// mma.sync, and dk and dv as transposed band products.
//
// ptxas (tools_torch_ptxas.py, CUDA 12.8, sm_90a), bf16 (float32 where
// it differs); dynamic shared memory from Win<K>:
//   window_pass1, K = 7 / 5 / 3: 168 / 128 (127) / 72 registers, no
//     spills; 65,152 / 53,376 / 42,624 bytes (two halos, own q and g).
//   window_pass2, K = 7 / 5 / 3: 128 registers with 236 bytes spilled /
//     96 (111) / 80; 24,384 / 18,496 / 13,120 bytes (one halo).
//   qkv_convs 71 (72) registers; conv_t 120 (124), with d ref 156 (158),
//   30,720 bytes of static shared memory; reduce_parts 32; no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int CC = 16;          // channels per chunk
constexpr int CG = 4;           // window_pass1: channels of a chunk taken at once
constexpr int TH = 4, TW = 32;  // window passes: pixel tile, a thread a pixel
constexpr int NT = TH * TW;
constexpr int WIN_BLOCKS = 3;   // blocks per SM window_pass1 is built for
constexpr int WIN2_BLOCKS = 4;  // and window_pass2
constexpr int CT_ROWS = 16;     // conv kernels: rows of a block, a thread a (row, channel)
constexpr int CT_NT = CT_ROWS * CC;
constexpr int CT_SEG = 64;      // conv kernels: columns a thread walks
constexpr int NW = 30;          // weight-gradient sums: 3 convs x (9 taps + bias)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T (the identity for float32)
template <class T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// 16 channels at p (16-byte aligned) as float32
__device__ __forceinline__ void load16(const float* p, float (&v)[CC]) {
#pragma unroll
  for (int i = 0; i < CC / 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[CC]) {
#pragma unroll
  for (int i = 0; i < CC / 8; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t word[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of its float32
      v[8 * i + 2 * j] = __uint_as_float(word[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(word[j] & 0xffff0000u);
    }
  }
}
// ---- 2, 3. the window passes ---------------------------------------------

// 16 or 4 float32 channels to p (16-byte aligned)
__device__ __forceinline__ void store16(float* p, const float (&v)[CC]) {
#pragma unroll
  for (int i = 0; i < CC / 4; ++i)
    reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[CG]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <int K>
struct Win {
  static constexpr int P = K / 2, KK = K * K;
  static constexpr int HH = TH + K - 1, HW = TW + K - 1;  // halo of a tile
  static constexpr int HS = (HH * HW) | 1;                // odd channel stride
  static constexpr int HALOS = 2 * CC * HS * 4;           // two halos, float32
  static constexpr int OWN = 2 * CC * NT * 4;             // two [CC][NT] tiles, float32
};

// rows [y0, y0 + rows) x cols [x0, x0 + cols) x channels [c0, c0 + 16) of
// one image into dst[cc * stride + row * cols + col] as float32, zero
// outside the image; a thread a position
template <class T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ img, int h, int w, int c,
                                      int y0, int x0, int rows, int cols, int stride, int c0) {
  for (int pos = threadIdx.x; pos < rows * cols; pos += blockDim.x) {
    const int gy = y0 + pos / cols, gx = x0 + pos % cols;
    float v[CC];
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      load16(img + (static_cast<int64_t>(gy) * w + gx) * c + c0, v);
    } else {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) v[cc] = 0.0f;
    }
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) dst[cc * stride + pos] = v[cc];
  }
}

// Grid (ceil(w / TW), ceil(h / TH), n), NT threads, HALOS + OWN bytes.
// Pixel p = (y, x) of this thread; window position o = dy * K + dx reads
// p + (dy - P, dx - P), halo position (ty + dy, tx + dx). A chunk's 16
// channels go CG at a time, so that the unrolled body stays small.
template <class T, int K>
__global__ void __launch_bounds__(NT, WIN_BLOCKS)
    window_pass1(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ g, float* __restrict__ p_out, float* __restrict__ ds_out,
                 float* __restrict__ dq, int h, int w, int c) {
  using G = Win<K>;
  extern __shared__ float smem[];
  float* k_s = smem;               // [CC][HS] K halo
  float* v_s = k_s + CC * G::HS;   // [CC][HS] V halo
  float* q_s = v_s + CC * G::HS;   // [CC][NT] this thread's q and g
  float* g_s = q_s + CC * NT;
  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < h && x < w;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t img = blockIdx.z * hw;  // the image's first pixel
  const int64_t pix = img + static_cast<int64_t>(y) * w + x;
  const T* k_img = k + img * c;
  const T* v_img = v + img * c;
  const int base = ty * G::HW + tx;

  float s[G::KK], dp[G::KK];
#pragma unroll
  for (int o = 0; o < G::KK; ++o) s[o] = dp[o] = 0.0f;
  for (int c0 = 0; c0 < c; c0 += CC) {
    __syncthreads();  // the previous chunk's readers are done
    stage(k_s, k_img, h, w, c, y0 - G::P, x0 - G::P, G::HH, G::HW, G::HS, c0);
    stage(v_s, v_img, h, w, c, y0 - G::P, x0 - G::P, G::HH, G::HW, G::HS, c0);
    {
      float qv[CC], gv[CC];
      if (inside) {
        load16(q + pix * c + c0, qv);
        load16(g + pix * c + c0, gv);
      } else {
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) qv[cc] = gv[cc] = 0.0f;
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        q_s[cc * NT + threadIdx.x] = qv[cc];
        g_s[cc * NT + threadIdx.x] = gv[cc];
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int c1 = 0; c1 < CC; c1 += CG) {
      const float* kb = k_s + c1 * G::HS + base;
      const float* vb = v_s + c1 * G::HS + base;
#pragma unroll
      for (int cc = 0; cc < CG; ++cc) {
        const float qc = q_s[(c1 + cc) * NT + threadIdx.x];
        const float gc = g_s[(c1 + cc) * NT + threadIdx.x];
#pragma unroll
        for (int dy = 0; dy < K; ++dy)
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const int o = dy * K + dx, at = cc * G::HS + dy * G::HW + dx;
            s[o] = fmaf(qc, kb[at], s[o]);
            dp[o] = fmaf(gc, vb[at], dp[o]);
          }
      }
    }
  }

  // softmax in float32, P rounded to T as K1 rounds it; then dS into dp
  float m = s[0];
#pragma unroll
  for (int o = 1; o < G::KK; ++o) m = fmaxf(m, s[o]);
  float sum = 0.0f;
#pragma unroll
  for (int o = 0; o < G::KK; ++o) {
    s[o] = expf(s[o] - m);
    sum += s[o];
  }
  float pdp = 0.0f;
#pragma unroll
  for (int o = 0; o < G::KK; ++o) {
    s[o] = round_to<T>(s[o] / sum);
    pdp = fmaf(s[o], dp[o], pdp);
  }
#pragma unroll
  for (int o = 0; o < G::KK; ++o) dp[o] = s[o] * (dp[o] - pdp);
  if (inside) {
    const int64_t at = blockIdx.z * G::KK * hw + static_cast<int64_t>(y) * w + x;
#pragma unroll
    for (int o = 0; o < G::KK; ++o) {
      p_out[at + o * hw] = s[o];
      ds_out[at + o * hw] = dp[o];
    }
  }

  // dq = sum_o dS[o] k[p + o]
  for (int c0 = 0; c0 < c; c0 += CC) {
    __syncthreads();
    stage(k_s, k_img, h, w, c, y0 - G::P, x0 - G::P, G::HH, G::HW, G::HS, c0);
    __syncthreads();
#pragma unroll 1
    for (int c1 = 0; c1 < CC; c1 += CG) {
      const float* kb = k_s + c1 * G::HS + base;
      float acc[CG];
#pragma unroll
      for (int cc = 0; cc < CG; ++cc) acc[cc] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float d = dp[dy * K + dx];
#pragma unroll
          for (int cc = 0; cc < CG; ++cc)
            acc[cc] = fmaf(d, kb[cc * G::HS + dy * G::HW + dx], acc[cc]);
        }
      if (inside) store4(dq + pix * c + c0 + c1, acc);
    }
  }
}

// Grid and threads as window_pass1, HALOS / 2 bytes. Key position r =
// (y, x) of this thread; offset o = dy * K + dx reaches it from pixel
// r - (dy - P, dx - P), halo position (ty + K - 1 - dy, tx + K - 1 - dx).
// Two sweeps over the channels, dk (from dS and the Q halo) then dv (from
// P and the g halo), so that only K * K weights and 16 sums are live.
template <class T, int K>
__global__ void __launch_bounds__(NT, WIN2_BLOCKS)
    window_pass2(const T* __restrict__ q, const T* __restrict__ g, const float* __restrict__ p_in,
                 const float* __restrict__ ds_in, float* __restrict__ dk, float* __restrict__ dv,
                 int h, int w, int c) {
  using G = Win<K>;
  extern __shared__ float x_s[];  // [CC][HS] Q or g halo
  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < h && x < w;
  const int64_t hw = static_cast<int64_t>(h) * w;
  const int64_t img = blockIdx.z * hw;
  const int64_t pix = img + static_cast<int64_t>(y) * w + x;
  const int base = ty * G::HW + tx;

#pragma unroll 1
  for (int sweep = 0; sweep < 2; ++sweep) {
    const float* wt_in = sweep == 0 ? ds_in : p_in;
    const T* src = (sweep == 0 ? q : g) + img * c;
    float* out = sweep == 0 ? dk : dv;
    float wt[G::KK];  // dS or P of the pixels whose windows reach r
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        const int o = dy * K + dx, py = y + G::P - dy, px = x + G::P - dx;
        wt[o] = 0.0f;
        if (inside && py >= 0 && py < h && px >= 0 && px < w)
          wt[o] = wt_in[(blockIdx.z * G::KK + o) * hw + static_cast<int64_t>(py) * w + px];
      }
    for (int c0 = 0; c0 < c; c0 += CC) {
      __syncthreads();
      stage(x_s, src, h, w, c, y0 - G::P, x0 - G::P, G::HH, G::HW, G::HS, c0);
      __syncthreads();
      float acc[CC];
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) acc[cc] = 0.0f;
#pragma unroll
      for (int dy = 0; dy < K; ++dy)
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int at = base + (K - 1 - dy) * G::HW + (K - 1 - dx);
#pragma unroll
          for (int cc = 0; cc < CC; ++cc)
            acc[cc] = fmaf(wt[dy * K + dx], x_s[cc * G::HS + at], acc[cc]);
        }
      if (inside) store16(out + pix * c + c0, acc);
    }
  }
}

// ---- 1, 4. the convs: q, k, v; the transposed convs and weight sums ------

// x[(img + yy * w + xx) * c + ch] as float32, 0 outside the image
template <class T>
__device__ __forceinline__ float at_or_0(const T* __restrict__ x, int64_t img, int yy, int xx,
                                         int h, int w, int c, int ch) {
  if (yy < 0 || yy >= h || xx < 0 || xx >= w) return 0.0f;
  return to_f(x[(img + static_cast<int64_t>(yy) * w + xx) * c + ch]);
}

// Both conv kernels: grid (c / CC, ceil(h / CT_ROWS), n * segs), CT_NT
// threads; thread (row, channel) walks columns [seg * CT_SEG, ...) of its
// row with 3 x 3 register windows ([a][b] is (y - 1 + a, x - 1 + b);
// column 3 is loaded a step before its use, so its loads overlap the step).

// q = dw3(lr; taps[0]) + bias[0], k and v from ref, rounded to T; taps
// summed columns outer, rows inner, then the bias, as K1 sums them.
template <class T>
__global__ void __launch_bounds__(CT_NT)
    qkv_convs(T* __restrict__ q, T* __restrict__ k, T* __restrict__ v, const T* __restrict__ lr,
              const T* __restrict__ ref, const float* __restrict__ taps,
              const float* __restrict__ bias, int h, int w, int c, int segs) {
  const int cl = threadIdx.x % CC, row = threadIdx.x / CC;
  const int ch = blockIdx.x * CC + cl;
  const int y = blockIdx.y * CT_ROWS + row;
  if (y >= h) return;
  const int seg = blockIdx.z % segs;
  const int64_t img = static_cast<int64_t>(blockIdx.z / segs) * h * w;
  const int xa = seg * CT_SEG, xb = min(w, xa + CT_SEG);
  float tq[9], tk[9], tv[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    tq[t] = taps[t * c + ch];
    tk[t] = taps[(9 + t) * c + ch];
    tv[t] = taps[(18 + t) * c + ch];
  }
  const float bq = bias[ch], bk = bias[c + ch], bv = bias[2 * c + ch];
  float wl[3][4], wr[3][4];
  auto load_col = [&](int b, int xx) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      wl[a][b] = at_or_0(lr, img, y - 1 + a, xx, h, w, c, ch);
      wr[a][b] = at_or_0(ref, img, y - 1 + a, xx, h, w, c, ch);
    }
  };
  load_col(0, xa - 1);
  load_col(1, xa);
  load_col(2, xa + 1);
  for (int x = xa; x < xb; ++x) {
    load_col(3, x + 2);
    float aq = 0.0f, ak = 0.0f, av = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int t = a * 3 + b;
        const float pq = __fmul_rn(wl[a][b], tq[t]);
        const float pk = __fmul_rn(wr[a][b], tk[t]);
        const float pv = __fmul_rn(wr[a][b], tv[t]);
        const bool first = t == 0;
        aq = first ? pq : __fadd_rn(aq, pq);
        ak = first ? pk : __fadd_rn(ak, pk);
        av = first ? pv : __fadd_rn(av, pv);
      }
    const int64_t at = (img + static_cast<int64_t>(y) * w + x) * c + ch;
    q[at] = from_f<T>(__fadd_rn(aq, bq));
    k[at] = from_f<T>(__fadd_rn(ak, bk));
    v[at] = from_f<T>(__fadd_rn(av, bv));
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        wl[a][b] = wl[a][b + 1];
        wr[a][b] = wr[a][b + 1];
      }
  }
}

// d lr_up, d ref and the weight sums, a thread a (row, channel):
//   d_lr[y,x] = g + sum_{a,b} dq[y+1-a, x+1-b] Wq[a,b]
//   d_ref[y,x] = sum_{a,b} dk[...] Wk[a,b] + dv[...] Wv[a,b]   (REF only)
// and sums dW?[a*3+b] += d?[y,x] * input[y+a-1, x+b-1], db? += d?[y,x].
// Block b = blockIdx.z * gridDim.y + blockIdx.y writes part[b][30][c].
template <class T, bool REF>
__global__ void __launch_bounds__(CT_NT)
    conv_t(T* __restrict__ d_lr, T* __restrict__ d_ref, float* __restrict__ part,
           const float* __restrict__ dq, const float* __restrict__ dk, const float* __restrict__ dv,
           const T* __restrict__ g, const T* __restrict__ lr, const T* __restrict__ ref,
           const float* __restrict__ taps, int h, int w, int c, int segs) {
  __shared__ float red[CT_ROWS][NW][CC];
  const int cl = threadIdx.x % CC, row = threadIdx.x / CC;
  const int ch = blockIdx.x * CC + cl;
  const int y = blockIdx.y * CT_ROWS + row;
  const int seg = blockIdx.z % segs;
  const int64_t img = static_cast<int64_t>(blockIdx.z / segs) * h * w;
  const int xa = seg * CT_SEG, xb = min(w, xa + CT_SEG);
  float acc[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) acc[j] = 0.0f;
  if (y < h) {
    float tq[9], tk[9], tv[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      tq[t] = taps[t * c + ch];
      tk[t] = taps[(9 + t) * c + ch];
      tv[t] = taps[(18 + t) * c + ch];
    }
    float wq[3][4], wk[3][4], wv[3][4], wl[3][4], wr[3][4];
    // column b of the windows from image column xx; without REF only the
    // middle row of dk and dv is read
    auto load_col = [&](int b, int xx) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int yy = y - 1 + a;
        wq[a][b] = at_or_0(dq, img, yy, xx, h, w, c, ch);
        wl[a][b] = at_or_0(lr, img, yy, xx, h, w, c, ch);
        wr[a][b] = at_or_0(ref, img, yy, xx, h, w, c, ch);
        wk[a][b] = REF || a == 1 ? at_or_0(dk, img, yy, xx, h, w, c, ch) : 0.0f;
        wv[a][b] = REF || a == 1 ? at_or_0(dv, img, yy, xx, h, w, c, ch) : 0.0f;
      }
    };
    load_col(0, xa - 1);
    load_col(1, xa);
    load_col(2, xa + 1);
    for (int x = xa; x < xb; ++x) {
      load_col(3, x + 2);
      const int64_t at = (img + static_cast<int64_t>(y) * w + x) * c + ch;
      float dl = to_f(g[at]), dr = 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const int t = a * 3 + b;
          dl = fmaf(wq[2 - a][2 - b], tq[t], dl);
          if (REF) dr = fmaf(wv[2 - a][2 - b], tv[t], fmaf(wk[2 - a][2 - b], tk[t], dr));
          acc[t] = fmaf(wq[1][1], wl[a][b], acc[t]);
          acc[10 + t] = fmaf(wk[1][1], wr[a][b], acc[10 + t]);
          acc[20 + t] = fmaf(wv[1][1], wr[a][b], acc[20 + t]);
        }
      acc[9] += wq[1][1];
      acc[19] += wk[1][1];
      acc[29] += wv[1][1];
      d_lr[at] = from_f<T>(dl);
      if (REF) d_ref[at] = from_f<T>(dr);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          wq[a][b] = wq[a][b + 1];
          wk[a][b] = wk[a][b + 1];
          wv[a][b] = wv[a][b + 1];
          wl[a][b] = wl[a][b + 1];
          wr[a][b] = wr[a][b + 1];
        }
    }
  }
#pragma unroll
  for (int j = 0; j < NW; ++j) red[row][j][cl] = acc[j];
  __syncthreads();
  const int64_t blk = static_cast<int64_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  for (int i = threadIdx.x; i < NW * CC; i += CT_NT) {
    const int j = i / CC, cc = i % CC;
    float s = 0.0f;
    for (int r = 0; r < CT_ROWS; ++r) s += red[r][j][cc];  // a fixed order
    part[(blk * NW + j) * c + blockIdx.x * CC + cc] = s;
  }
}

// ---- 5. the weight gradients ---------------------------------------------

// out[i] = sum_b part[b][i] over i < n30c = 30 c, b in order
__global__ void reduce_parts(float* __restrict__ out, const float* __restrict__ part, int parts,
                             int n30c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n30c) return;
  float s = 0.0f;
  for (int b = 0; b < parts; ++b) s += part[static_cast<int64_t>(b) * n30c + i];
  out[i] = s;
}

// ---- the workspace and the launches ----------------------------------------

size_t up256(size_t b) { return (b + 255) & ~static_cast<size_t>(255); }

struct Layout {
  int segs, parts;
  size_t qkv, planes, grads, part, total;  // byte offsets of each region; total size
  Layout(int n, int h, int w, int c, int k, int dtype) {
    const size_t elems = static_cast<size_t>(n) * h * w * c;
    segs = (w + CT_SEG - 1) / CT_SEG;
    parts = n * segs * ((h + CT_ROWS - 1) / CT_ROWS);
    qkv = 0;  // q, k, v in the input type
    planes = qkv + 3 * up256(elems * (dtype == 1 ? 2 : 4));
    grads = planes + 2 * up256(static_cast<size_t>(n) * k * k * h * w * 4);  // P, dS
    part = grads + 3 * up256(elems * 4);  // dq, dk, dv
    total = part + up256(static_cast<size_t>(parts) * NW * c * 4);
  }
};

template <class T, int K>
int run(T* d_lr, T* d_ref, float* d_taps, unsigned char* ws, const T* lr, const T* ref, const T* g,
        const float* taps, const float* bias, int n, int h, int w, int c, cudaStream_t s) {
  using G = Win<K>;
  const Layout L(n, h, w, c, K, sizeof(T) == 2 ? 1 : 0);
  const size_t elems = static_cast<size_t>(n) * h * w * c;
  T* q = reinterpret_cast<T*>(ws + L.qkv);
  T* k = q + up256(elems * sizeof(T)) / sizeof(T);
  T* v = k + up256(elems * sizeof(T)) / sizeof(T);
  float* p_pl = reinterpret_cast<float*>(ws + L.planes);
  float* ds_pl = p_pl + up256(static_cast<size_t>(n) * K * K * h * w * 4) / 4;
  float* dq = reinterpret_cast<float*>(ws + L.grads);
  float* dk = dq + up256(elems * 4) / 4;
  float* dv = dk + up256(elems * 4) / 4;
  float* part = reinterpret_cast<float*>(ws + L.part);

  const dim3 ct_grid(c / CC, (h + CT_ROWS - 1) / CT_ROWS, n * L.segs);
  qkv_convs<T><<<ct_grid, CT_NT, 0, s>>>(q, k, v, lr, ref, taps, bias, h, w, c, L.segs);

  cudaError_t err = cudaFuncSetAttribute(
      window_pass1<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::HALOS + G::OWN);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(window_pass2<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G::HALOS / 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 win_grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  window_pass1<T, K><<<win_grid, NT, G::HALOS + G::OWN, s>>>(q, k, v, g, p_pl, ds_pl, dq, h, w,
                                                            c);
  window_pass2<T, K><<<win_grid, NT, G::HALOS / 2, s>>>(q, g, p_pl, ds_pl, dk, dv, h, w, c);
  if (d_ref != nullptr)
    conv_t<T, true><<<ct_grid, CT_NT, 0, s>>>(d_lr, d_ref, part, dq, dk, dv, g, lr, ref, taps, h,
                                              w, c, L.segs);
  else
    conv_t<T, false><<<ct_grid, CT_NT, 0, s>>>(d_lr, d_ref, part, dq, dk, dv, g, lr, ref, taps, h,
                                               w, c, L.segs);
  reduce_parts<<<(NW * c + 255) / 256, 256, 0, s>>>(d_taps, part, L.parts, NW * c);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int run_k(void* d_lr, void* d_ref, float* d_taps, void* ws, const void* lr, const void* ref,
          const void* g, const float* taps, const float* bias, int n, int h, int w, int c, int k,
          cudaStream_t s) {
  T* dl = static_cast<T*>(d_lr);
  T* dr = static_cast<T*>(d_ref);
  unsigned char* wb = static_cast<unsigned char*>(ws);
  const T* l = static_cast<const T*>(lr);
  const T* r = static_cast<const T*>(ref);
  const T* gg = static_cast<const T*>(g);
  switch (k) {
    case 3: return run<T, 3>(dl, dr, d_taps, wb, l, r, gg, taps, bias, n, h, w, c, s);
    case 5: return run<T, 5>(dl, dr, d_taps, wb, l, r, gg, taps, bias, n, h, w, c, s);
    case 7: return run<T, 7>(dl, dr, d_taps, wb, l, r, gg, taps, bias, n, h, w, c, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" size_t arseg_creff_qkv_fused_backward_workspace(int n, int h, int w, int c, int k,
                                                           int dtype) {
  if (n < 0 || h <= 0 || w <= 0 || c <= 0 || k <= 0) return 0;
  return Layout(n, h, w, c, k, dtype).total;
}

extern "C" int arseg_creff_qkv_fused_backward(void* d_lr, void* d_ref, float* d_taps,
                                              void* workspace, const void* lr_up, const void* ref,
                                              const void* g, const float* taps, const float* bias,
                                              int n, int h, int w, int c, int kh, int kw,
                                              int dtype, void* stream) {
  if (kh != kw || c % CC != 0 || c <= 0 || n < 0 || h <= 0 || w <= 0 || n > 65535 ||
      static_cast<int64_t>(n) * ((w + CT_SEG - 1) / CT_SEG) > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(lr_up) | reinterpret_cast<uintptr_t>(ref) |
       reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(taps) |
       reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(workspace)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);  // 16-byte loads
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(d_taps, 0, sizeof(float) * NW * c, s));
  if (dtype == 0)
    return run_k<float>(d_lr, d_ref, d_taps, workspace, lr_up, ref, g, taps, bias, n, h, w, c, kh,
                        s);
  return run_k<__nv_bfloat16>(d_lr, d_ref, d_taps, workspace, lr_up, ref, g, taps, bias, n, h, w,
                              c, kh, s);
}
