// K4: windowed local attention, NHWC:
//   out[n,y,x,:] = sum_o p[o] * v[n, y+dy-P, x+dx-P, :],
//   p = softmax_o(sum_c q[n,y,x,c] * k[n, y+dy-P, x+dx-P, c])
// over a K x K window (o = dy*K + dx, P = K/2). Window positions outside
// the image give logit 0 and value 0, as nn.Unfold's zero padding does.
// q, k, v and out share one shape; the caller computes Q, K and V, so there
// is no depthwise conv and no residual (K1 adds both). Logits are summed in
// float32, p is rounded to the input type before the second product (the
// TPU kernel's p.astype), the window sum is float32, and the output is
// rounded once.
//
// Replaces: arseg_tpu/ops/pallas_creff.py creff_fused_pallas (_kernel), the
// TPU kernel behind ops/local_attention.creff_attention that every fusion
// variant of the "local" family but "local" itself runs. The TPU kernel
// streamed K/V halo windows by manual DMA and ran the window as a banded
// matmul on the MXU, with the band mask as -inf logits.
//
// bfloat16 (the served paths) runs the window products of the tensor-core
// CReFF body, creff_module_mma.cuh (window_logits, band_softmax,
// window_pv), without its depthwise convs and residual:
// - A warp owns 16 pixels of one output row (the m16 of mma.sync); a block
//   is ROWS x 16 pixels (ROWS = 8), one warp per row. Q.K^T runs as three n8
//   tiles per window row over 24 K positions, the softmax on the
//   accumulator fragments, p . V with p repacked as the A operand.
// - Staging without convs: cp.async 16-byte copies, zero-filled outside the
//   image through src-size 0 (Q, K and V carry no bias, so zero fill is
//   exactly nn.Unfold's padding), go straight into the [position][PS]
//   layouts that ldmatrix reads: per 16-channel chunk the Q tile
//   (ROWS x 16 positions, pass 1) and the K (pass 1) or V (pass 2)
//   halo, (ROWS + K - 1) rows x (16 + K - 1) positions.
// - There is no CUDA-core work to overlap with the products, so what hides
//   the copies is copies issued two chunks ahead into a ring of three slots
//   (one barrier per chunk) and the warps in flight.
// - Epilogue: each chunk's [16 px, 16 ch] float32 fragment rounded to bf16
//   and written through the warp's scratch (the slot's Q tile, free in pass
//   2) with 16-byte stores.
// - Tile: 8 rows (8 warps, 66,816 bytes of shared memory at K = 7, two
//   blocks per SM at 128 registers; K/V halo 14 x 22 / 128 = 2.41x at
//   K = 7, 1,056 blocks at [11,90,120]). A 16-row tile (16 warps, one block
//   per SM, 112,896 bytes, halo 22 x 22 / 256 = 1.89x, 528 blocks) reads
//   less. Both were timed in turns in three development runs (NVIDIA H100
//   80GB HBM3, 700 W), 16 rows against 8, in ms:
//     [11,90,120,256]: 0.2687 / 0.2547, 0.2726 / 0.2679, 0.2629 / 0.2486
//     [11,45,60,256]:  0.0913 / 0.0917, 0.0951 / 0.0891, 0.0966 / 0.0929
//   8 rows won five of six; with two blocks per SM one block's copies and
//   barrier waits overlap the other's products. Only the 8-row tile is kept.
// - Registers (tools_torch_ptxas.py, CUDA 12.8, sm_90a): 128 at K = 7 and
//   5, 110 at K = 3, no spills.
//
// float32 (the parity checks only) keeps the CUDA-core kernel below: a
// thread per pixel walks its window in shared memory; a TF32 product would
// not hold the float32 tolerance.
//
// Bound on the H100: at [11,90,120,256] bf16 the function reads q, k, v
// and writes out once (4 x 60.8 MB), about 0.073 ms at 3.35 TB/s; its
// 2 x 49 multiply-adds per element (~5.9 GFLOP) would take 6 us at the bf16
// tensor rate, so bytes bound it. The kernel stages 1 + 2 x 2.41 times the
// input (the K/V halos, partly from L2) and has little besides copies to
// hide their latency behind.

#include "creff_module.cuh"
#include "creff_module_mma.cuh"
#include "kernels.h"

namespace {

// ---- float32: the CUDA-core window loop ----------------------------------
namespace cuda_core {

using creff::CC;
using creff::TH;
using creff::TW;

template <int K>
__global__ void __launch_bounds__(TH* TW)
    attention_kernel(float* __restrict__ out, const float* __restrict__ q,
                     const float* __restrict__ k, const float* __restrict__ v, int h, int w,
                     int c) {
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
  const float* k_img = k + blockIdx.z * plane;
  const float* v_img = v + blockIdx.z * plane;

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
    for (int cc = 0; cc < CC; ++cc) qc[cc] = inside ? q[at + c0 + cc] : 0.0f;
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
      for (int cc = 0; cc < CC; ++cc) out[at + c0 + cc] = acc[cc];
    }
  }
}

template <int K>
int launch(void* out, const void* q, const void* k, const void* v, int n, int h, int w, int c,
           cudaStream_t stream) {
  if (n == 0) return 0;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, n);
  attention_kernel<K><<<grid, TH * TW, 0, stream>>>(
      static_cast<float*>(out), static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cuda_core

// ---- bfloat16: the tensor-core window products ---------------------------
namespace tensor_core {

using creff_mma::CC;
using creff_mma::KVP;
using creff_mma::PS;
using creff_mma::TW;
using bf16 = __nv_bfloat16;

constexpr int ROWS = 8;  // output rows per block, one warp each
constexpr int NT = ROWS * 32;
constexpr int MIN_BLOCKS = 2;  // blocks per SM at 128 registers

template <int K>
struct Geom {
  static constexpr int P = K / 2;
  static constexpr int KH = ROWS + K - 1, KW = TW + K - 1;  // K/V halo positions
  static constexpr int KV = KH * KVP * PS, Q = ROWS * TW * PS;  // bf16 each
  static constexpr int SLOT = KV + Q;  // K or V [KH][KVP][PS], then Q [ROWS * TW][PS]
  static constexpr int SMEM_BYTES = 2 * 3 * SLOT;  // a ring of three slots
};

// Start the copies of channels c0..c0+15 into a ring slot: the Q tile (rows
// y0.., cols x0..) if with_q, and the K or V halo (rows y0-P.., cols
// x0-P..), zero outside the image.
template <int K>
__device__ __forceinline__ void stage(bf16* slot, const bf16* q_img, const bf16* kv_img,
                                      bool with_q, int h, int w, int c, int c0, int y0, int x0) {
  using G = Geom<K>;
  if (with_q) {
    for (int i = threadIdx.x; i < ROWS * TW * 2; i += NT) {
      const int pos = i >> 1, half = (i & 1) * 8;
      const int gy = y0 + pos / TW, gx = x0 + pos % TW;
      const bool in = gy < h && gx < w;
      const bf16* src = in ? q_img + (static_cast<int64_t>(gy) * w + gx) * c + c0 + half : q_img;
      creff_mma::cp_async16(slot + G::KV + pos * PS + half, src, in);
    }
  }
  for (int i = threadIdx.x; i < G::KH * G::KW * 2; i += NT) {
    const int pos = i >> 1, half = (i & 1) * 8;
    const int row = pos / G::KW, col = pos % G::KW;
    const int gy = y0 - G::P + row, gx = x0 - G::P + col;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const bf16* src = in ? kv_img + (static_cast<int64_t>(gy) * w + gx) * c + c0 + half : kv_img;
    creff_mma::cp_async16(slot + (row * KVP + col) * PS + half, src, in);
  }
}

// Grid: (ceil(w / 16), ceil(h / ROWS), n); NT threads; Geom<K>::SMEM_BYTES
// of dynamic shared memory. Chunks 0..nc-1 are pass 1 (Q and K), nc..2nc-1
// pass 2 (V). Step j, between one barrier and the next: start the copies of
// chunk j + 2 into the slot that chunk j - 1 used, and multiply chunk j.
template <int K>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    attention_mma_kernel(bf16* __restrict__ out, const bf16* __restrict__ q,
                         const bf16* __restrict__ k, const bf16* __restrict__ v, int h, int w,
                         int c) {
  using G = Geom<K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [3][SLOT]

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int py = threadIdx.x >> 5;  // the warp's output row in the tile
  const int y0 = blockIdx.y * ROWS, x0 = blockIdx.x * TW;
  const int64_t plane = static_cast<int64_t>(h) * w * c;
  const bf16* q_img = q + blockIdx.z * plane;
  const bf16* k_img = k + blockIdx.z * plane;
  const bf16* v_img = v + blockIdx.z * plane;
  const int nc = c / CC;

#pragma unroll
  for (int sl = 0; sl < 3; ++sl) creff_mma::zero_kv_pad<G::KW, NT>(ring + sl * G::SLOT, G::KH);

  auto issue = [&](int j) {  // start the copies of chunk j into ring slot j % 3
    if (j < 2 * nc)
      stage<K>(ring + (j % 3) * G::SLOT, q_img, j < nc ? k_img : v_img, j < nc, h, w, c,
               (j % nc) * CC, y0, x0);
    creff_mma::cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  auto begin_step = [&](int j) {  // chunk j has landed; chunk j + 1 may still be in flight
    creff_mma::cp_async_wait_one();
    __syncthreads();  // chunk j is visible to every warp, and step j - 1 is done
    issue(j + 2);
  };

  float s[K][3][4];  // logits: window row dy, n8 tile of positions, fragment
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[dy][nt][e] = 0.0f;
  uint32_t p[K][3][2];  // p in bf16 pairs: window row, n8 tile, pixel row g + 8r

  issue(0);
  issue(1);
  // ---- pass 1: S_dy += Q . K_dy^T, 16 channels a step -------------------
  for (int j = 0; j < nc; ++j) {
    begin_step(j);
    const bf16* slot = ring + (j % 3) * G::SLOT;
    creff_mma::window_logits<K>(s, slot + G::KV + py * TW * PS, slot + py * KVP * PS);
  }
  creff_mma::band_softmax<K>(s, p);

  // ---- pass 2: p . V_dy -> out, 16 channels a step -----------------------
  const int gy = y0 + py;
  const int n_valid = gy < h ? min(TW, w - x0) : 0;
  const int64_t pix0 = (static_cast<int64_t>(blockIdx.z) * h + gy) * w + x0;
  for (int j = nc; j < 2 * nc; ++j) {
    begin_step(j);
    bf16* slot = ring + (j % 3) * G::SLOT;
    float pv[2][4] = {};
    creff_mma::window_pv<K>(pv, p, slot + py * KVP * PS);
    // the slot's Q tile is not staged in pass 2: the warp's rows of it are
    // its scratch, [16 px][PS]
    bf16* scratch = slot + G::KV + py * TW * PS;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(scratch + (g + 8 * r) * PS + 8 * nt + 2 * t) =
            creff_mma::pack_bf16(pv[nt][2 * r], pv[nt][2 * r + 1]);
    __syncwarp();
    const int px = lane >> 1, half = (lane & 1) * 8;
    if (px < n_valid)
      *reinterpret_cast<uint4*>(out + (pix0 + px) * c + (j - nc) * CC + half) =
          *reinterpret_cast<const uint4*>(scratch + px * PS + half);
  }
}

template <int K>
int launch(void* out, const void* q, const void* k, const void* v, int n, int h, int w, int c,
           cudaStream_t stream) {
  if (n == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(q) |
       reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);  // 16-byte copies and stores
  constexpr int smem = Geom<K>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + TW - 1) / TW, (h + ROWS - 1) / ROWS, n);
  attention_mma_kernel<K><<<grid, NT, smem, stream>>>(
      static_cast<bf16*>(out), static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), h, w, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tensor_core

template <int K>
int launch(void* out, const void* q, const void* k, const void* v, int n, int h, int w, int c,
           int dtype, cudaStream_t stream) {
  if (dtype == 0) return cuda_core::launch<K>(out, q, k, v, n, h, w, c, stream);
  if (dtype == 1) return tensor_core::launch<K>(out, q, k, v, n, h, w, c, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int arseg_creff_attention(void* out, const void* q, const void* k, const void* v,
                                     int n, int h, int w, int c, int kh, int kw, int dtype,
                                     void* stream) {
  if (kh != kw || c % creff_mma::CC != 0 || c <= 0 || n < 0 || h <= 0 || w <= 0 || n > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kh) {
    case 3: return launch<3>(out, q, k, v, n, h, w, c, dtype, s);
    case 5: return launch<5>(out, q, k, v, n, h, w, c, dtype, s);
    case 7: return launch<7>(out, q, k, v, n, h, w, c, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
