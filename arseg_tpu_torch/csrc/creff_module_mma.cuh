// The fused CReFF module body (MyAttention forward) for bfloat16 on the
// tensor cores, NHWC:
//   fused = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// over a K x K window (K in {3, 5, 7}), any h, w >= 1, C % 16 == 0. Same
// function and rounding points as creff_module.cuh (which serves the
// float32 inputs): Q, K, V and p rounded to bf16, every sum float32.
//
// Its users, all for bf16 inputs:
// - module_kernel with an epilogue: K1 (creff_qkv_fused.cu, HALO = 0,
//   stores the fused feature), K3 (creff_phase2_argmax.cu, HALO = 0, 1x1
//   conv on the tensor cores and argmax; its LR form wraps the epilogue in
//   LrUp and reads the LR feature, see below) and K5
//   (creff_phase2_upsample_argmax.cu, HALO = 1: overlapping tiles, 1x1
//   conv in float32, x8 upsample and argmax in shared memory).
// - The window products and the band softmax alone, as device functions
//   (window_logits, band_softmax, window_pv, zero_kv_pad): module_kernel
//   and K4 (creff_attention.cu, on Q, K and V the caller computed, with no
//   convs and no residual) run the same code.
//
// Design for Hopper:
// - Warp = one pixel-row segment. A warp owns 16 consecutive pixels of one
//   output row, the m16 of mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//   A block is TH = 16 rows x TW = 16 columns, 16 warps, one block per SM
//   at 128 registers a thread. With HALO = 1 a tile starts one row and one
//   column before its 14 x 14 interior (Seg gives each segment its valid
//   columns, the first of which may lie at image column -1); the ring
//   outside the image is computed on zero-filled halos. Its K/V depthwise
//   convs cover (16 + K - 1)^2 positions for 256 outputs: 484 / 256 =
//   1.89x at K = 7 (the CUDA-core body's 8 x 16 tile: 308 / 128 =
//   2.41x). The other
//   shapes tried on the card (8 x 16, 8 x 32, 4 x 32) were not faster;
//   16 x 16 has the smallest halo of them.
// - Logits on the tensor cores. For each window row dy the warp forms
//   S_dy = Q[16 px, C] . K[row y+dy, 24 positions, C]^T: three n8 tiles per
//   16-channel k step, summed over all channel chunks in registers
//   (K * 12 float32 a thread). The window is the band px <= j < px + K of
//   those 24 columns (7 of 24 at K = 7); columns off the band are left
//   out of the softmax, as the TPU kernel's -inf mask does. In-band
//   positions outside the image hold K = 0 (bias included), so they enter
//   with logit 0, as nn.Unfold does.
// - Softmax on the accumulator fragments: a pixel's row lives on the four
//   lanes of a quad, reduced with __shfl_xor_sync over 1 and 2. p is
//   rounded to bf16 and off-band entries are exactly 0.
// - p . v on the tensor cores: the logit tiles are repacked in registers
//   as A fragments (as FlashAttention-2 does): positions 0..15 as one
//   m16k16 fragment, 16..23 as one m16k8 fragment (the band ends at
//   15 + K - 1 <= 21), multiplied by V[positions, 16 channels] read with
//   ldmatrix.trans from the same [position][channel] tile. Positions past
//   the tile's 16 + K - 1 (up to 24) are written as zeros once, so
//   0 x stale memory never makes a NaN.
// - K/V and Q tiles are [position][16 channels] with a 48-byte position
//   stride, so the eight 16-byte rows of every ldmatrix fall on distinct
//   banks.
// - A pipeline of 16-channel chunks over both passes. Step j, between one
//   barrier and the next: start the cp.async 16-byte copies of chunk j + 2
//   (the raw bf16 ref and lr_up halos, zero-filled outside the image
//   through src-size 0, and the chunk's taps and biases) into a ring of
//   three slots; convolve chunk j + 1 on the CUDA cores into one of two
//   K/V and Q buffers; multiply chunk j on the tensor cores. One warp's
//   products overlap another's convs, and every copy has a whole step to
//   land. The ref halo is staged again in pass 2 (mostly from L2); keeping
//   all of it resident (C = 64 would fit) is not used, so one body serves
//   every C.
// - The 3x3 depthwise convs stay on the CUDA cores in float32, summed in
//   the TPU kernel's order, so Q, K and V equal the plain version's bit for
//   bit. A thread takes a channel pair and two vertically adjacent outputs,
//   which share three of their four loaded rows.
// - Shared memory (dynamic): 167,424 bytes at K = 7, 153,984 at K = 5,
//   141,312 at K = 3; LrUp: see below.
// - The LR input (an epilogue wrapped in LrUp): lr is the LR feature
//   [n, h_in, w_in, c], h_in <= h, w_in <= w, c <= LR_MAX_C, and lr_up is
//   its bilinear align_corners=True resize to h x w, which never reaches
//   device memory. Each pass-1 chunk copies the LR positions that its
//   (TH + 2) x (TW + 2) lr_up halo reads (at most LRS x LRS for any ratio,
//   11 x 11 at x2) a step earlier than the ref halo, and lerps them into
//   the lr_up halo buffer a step before its convs, so the lerps overlap
//   other warps' products like the convs. The lerp also keeps the halo's
//   16 x 16 interior of every chunk (32 KB at c = 64), pass 2's residual:
//   pass 2 stages and lerps nothing. Shared memory at K = 7, c = 64, x2:
//   198,160 bytes (the lr_up ring two slots, not three; the tile's LR
//   geometry 592; an LR ring of two 3,872-byte slots; the interiors), under
//   the 196 KB carve-out that leaves the L1 60 KB for the spills. Timed on
//   the H100 at [44,360,480,64] -> [44,720,960,64]: 43.6 ms; 44.0 with
//   three-slot rings (212 KB, a 28 KB L1) and 47.1 lerping the interior
//   again in pass 2 in place of keeping it, against 42.1-42.7 for the
//   full-size K3 alone.
//
// Why not wgmma: a 64-row warpgroup tile would span four pixel rows whose
// key bands differ, wasting more of the product; the function is bytes
// bound, and at ~29% band use mma.sync is not the limit by count.
//
// Epilogue interface (per warp, per 16-channel chunk): a struct with
//   static constexpr int HALO;   // 0: tiles partition the image; 1: they overlap
//   struct State;                // per-thread sums, zero-initialised
//   __device__ void chunk(State&, const Seg& seg, int c0, const float acc[2][4]) const;
//   __device__ void finish(State&, const Seg& seg) const;
// The struct itself is a __grid_constant__ kernel parameter: its fields
// (pointers, sizes) are read from the parameter bank and hold no
// registers through the chunk loop; only State lives in registers. acc is
// the chunk's [16 px, 16 ch] float32 fused fragment in mma.sync's
// accumulator layout: acc[nt][2r + e] is pixel g + 8r, channel
// c0 + 8nt + 2t + e, with g = lane / 4, t = lane % 4. chunk() is called by
// every lane of every warp once per chunk in order (so it may use
// __syncwarp and the segment's shared scratch); finish() once after the
// last chunk, by every thread of the block (so it may synchronise the
// block, after which the module's shared memory is free). Seg says which
// of the 16 pixels lie in the image.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace creff_mma {

constexpr int TH = 16;              // output tile rows
constexpr int TW = 16;              // output tile cols: one 16-pixel segment
constexpr int NT = TH * 32;         // threads per block: one warp per row
constexpr int MIN_BLOCKS = 65536 / (NT * 128);  // blocks per SM at 128 registers
constexpr int VR = 2;         // conv output rows per item (their rows share loads)
constexpr int CC = 16;        // channels per chunk: one k step
constexpr int PS = 24;        // bf16 per staged position (16 + 8 pad: 48 B)
constexpr int KVP = TW + 8;   // K/V row stride in positions: the 24 a segment's band spans
// LR positions a lr_up halo's TH + 2 rows (or TW + 2 columns) read, at most:
// 17 steps of at most one LR step each, and the last one's neighbour
constexpr int LRS = TH + 3;

template <int K>
struct Geom {
  static constexpr int P = K / 2;
  static constexpr int RH = TH + K + 1, RW = TW + K + 1;  // raw ref halo
  static constexpr int LH = TH + 2, LW = TW + 2;          // raw lr_up halo
  static constexpr int KH = TH + K - 1, KW = TW + K - 1;  // K/V positions
  static constexpr int RBUF = RH * RW * CC, LBUF = LH * LW * CC;  // bf16 each
  static constexpr int KV = KH * KVP * PS, Q = TH * TW * PS;
  static constexpr int TB = 3 * 10 * CC;  // float32: q, k, v x (9 taps, bias) x channel
  // raw halos in a ring of three, K/V and Q double-buffered
  static constexpr int SMEM_BYTES = 2 * (3 * (RBUF + LBUF) + 2 * (KV + Q)) + 4 * 3 * TB;
  static_assert(KW <= KVP, "K/V row too short");
};

// An epilogue whose module reads the LR feature lr [n, h_in, w_in, c]
// (c <= LR_MAX_C) in place of lr_up; rh, rw: the align_corners=True scales
// (h_in - 1) / (h - 1) and (w_in - 1) / (w - 1) in float32 (0 for an
// output of one row or column), computed on the host as PyTorch computes
// them; slot: bf16 elements of one staged LR halo (the most rows times the
// most columns any tile reads, times 16).
template <class Epi>
struct LrUp : Epi {
  int h_in, w_in;
  float rh, rw;
  int slot;
};
template <class E>
struct is_lr_up : std::false_type {};
template <class E>
struct is_lr_up<LrUp<E>> : std::true_type {};

// One tile's LR geometry (LrUp), in shared memory: the first LR row and
// column its lr_up halo reads and how many; for each halo row (column) the
// offsets in a staged LR halo, in bf16 elements, of the two LR rows
// (columns) it reads, -1 outside the image, and their weights l0, l1 as
// float bits.
struct LrTile {
  int ly0, lx0, rows, cols;
  int4 row[TH + 2], col[TW + 2];
};

constexpr int LR_MAX_C = 64;  // LrUp: channels whose lr_up interiors shared memory holds

// dynamic shared memory of module_kernel<K, Epi> for c channels: LrUp
// takes one lr_up slot less, the tile's LR geometry, two LR halos and the
// interiors
template <int K, class Epi>
int smem_bytes(const Epi& epi, int c) {
  if constexpr (is_lr_up<Epi>::value)
    return Geom<K>::SMEM_BYTES + 2 * (-Geom<K>::LBUF + 2 * epi.slot + TH * TW * c) +
           static_cast<int>(sizeof(LrTile));
  else
    return Geom<K>::SMEM_BYTES;
}

// this warp's segment: the flat index pix0 of its pixel 0 (output row gy,
// column gx0, which may be -1 with HALO = 1); its pixels lo <= px < hi lie
// in the image (lo = hi = 0 if the row is outside). scratch: 2 x 16 x PS
// bf16 (1,536 bytes) of shared memory of its own, free in pass 2.
struct Seg {
  int64_t pix0;
  int lo, hi;
  __nv_bfloat16* scratch;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }
// all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n"); }

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b, m16n8k8, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_k8(float d[4], const uint32_t a[2], uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b0));
}

// two float32 values rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 load_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Start the copies of one 16-channel chunk (channels c0..c0+15) of the raw
// ref halo (rows y0-P-1.., cols x0-P-1..) and, with UP, the lr_up halo
// (rows y0-1.., cols x0-1..) into [position][16] bf16 buffers, zero outside
// the image, and of the chunk's taps and biases into tb[conv][tap or 9 =
// bias][16].
template <int K, bool UP = true>
__device__ __forceinline__ void stage_chunk(__nv_bfloat16* rb, __nv_bfloat16* lb, float* tb,
                                            const __nv_bfloat16* ref_img,
                                            const __nv_bfloat16* lr_img,
                                            const float* __restrict__ taps,
                                            const float* __restrict__ bias, int h, int w, int c,
                                            int c0, int y0, int x0) {
  using G = Geom<K>;
  for (int i = threadIdx.x; i < 3 * 10 * (CC / 4); i += NT) {
    const int conv = i / (10 * (CC / 4)), o = i / (CC / 4) % 10, quarter = 4 * (i % (CC / 4));
    const float* src = o < 9 ? taps + (conv * 9 + o) * c : bias + conv * c;
    cp_async16(tb + (conv * 10 + o) * CC + quarter, src + c0 + quarter, true);
  }
  for (int i = threadIdx.x; i < G::RH * G::RW * 2; i += NT) {
    const int pos = i >> 1, half = (i & 1) * 8;
    const int gy = y0 - G::P - 1 + pos / G::RW, gx = x0 - G::P - 1 + pos % G::RW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const __nv_bfloat16* src =
        in ? ref_img + (static_cast<int64_t>(gy) * w + gx) * c + c0 + half : ref_img;
    cp_async16(rb + pos * CC + half, src, in);
  }
  if constexpr (UP) {
    for (int i = threadIdx.x; i < G::LH * G::LW * 2; i += NT) {
      const int pos = i >> 1, half = (i & 1) * 8;
      const int gy = y0 - 1 + pos / G::LW, gx = x0 - 1 + pos % G::LW;
      const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
      const __nv_bfloat16* src =
          in ? lr_img + (static_cast<int64_t>(gy) * w + gx) * c + c0 + half : lr_img;
      cp_async16(lb + pos * CC + half, src, in);
    }
  }
}

// ---- the LR input (LrUp). Along one axis, lr_up index o reads LR indices
// i = int(r * o) and i + 1 (i alone if it is the last), PyTorch's
// area_pixel_compute_source_index in float32.

// The first LR index that a tile's lr_up halo (indices o0 - 1 .. o0 + 16,
// clipped to [0, out)) reads, and how many it reads (at most LRS for
// in <= out; the launcher checks every tile). A lone float32 product is
// rounded alike on the host and the card.
__host__ __device__ __forceinline__ int lr_first(float r, int o0) {
  return static_cast<int>(r * static_cast<float>(o0 > 0 ? o0 - 1 : 0));
}
__host__ __device__ __forceinline__ int lr_count(float r, int o0, int out, int in) {
  const int last = static_cast<int>(r * static_cast<float>(o0 + TH < out ? o0 + TH : out - 1));
  return (last + 1 < in ? last + 1 : in - 1) - lr_first(r, o0) + 1;
}

// One axis of LrTile: halo index k (image index o0 - 1 + k) reads LR
// indices i and i + 1 (i alone if it is the last) with weights l0 = 1 - l1
// and l1 = r * o - i, as PyTorch's kernel computes them; offsets
// (i - first) * stride.
__device__ __forceinline__ int4 lr_axis(float r, int o0, int k, int out, int in, int first,
                                        int stride) {
  const int o = o0 - 1 + k;
  if (o < 0 || o >= out) return make_int4(-1, -1, 0, 0);
  const float s = __fmul_rn(r, static_cast<float>(o));
  const int i = static_cast<int>(s);
  const float l1 = __fsub_rn(s, static_cast<float>(i)), l0 = __fsub_rn(1.0f, l1);
  const int off = (i - first) * stride;
  return make_int4(off, i < in - 1 ? off + stride : off, __float_as_int(l0), __float_as_int(l1));
}

// The tile at (y0, x0): its LrTile, by the first threads of the block.
template <class Epi>
__device__ __forceinline__ void lr_tile(LrTile& t, const Epi& epi, int h, int w, int y0,
                                        int x0) {
  const int k = threadIdx.x, ly0 = lr_first(epi.rh, y0), lx0 = lr_first(epi.rw, x0);
  const int cols = lr_count(epi.rw, x0, w, epi.w_in);
  if (k < TH + 2)
    t.row[k] = lr_axis(epi.rh, y0, k, h, epi.h_in, ly0, cols * CC);
  else if (k < TH + TW + 4)
    t.col[k - TH - 2] = lr_axis(epi.rw, x0, k - TH - 2, w, epi.w_in, lx0, CC);
  else if (k == TH + TW + 4) {
    t.ly0 = ly0;
    t.lx0 = lx0;
    t.rows = lr_count(epi.rh, y0, h, epi.h_in);
    t.cols = cols;
  }
}

// Start the copies of one 16-channel chunk (channels c0..c0+15) of the LR
// positions that the tile's lr_up halo reads into lb[(row * t.cols + col)
// * 16]; all of them lie inside the LR image.
__device__ __forceinline__ void stage_lr(__nv_bfloat16* lb, const __nv_bfloat16* lr_img,
                                         const LrTile& t, int w_in, int c, int c0) {
  const int rows = t.rows, cols = t.cols;
  const __nv_bfloat16* src = lr_img + (static_cast<int64_t>(t.ly0) * w_in + t.lx0) * c + c0;
  for (int i = threadIdx.x; i < rows * LRS * 2; i += NT) {
    const int pos = i >> 1, half = (i & 1) * 8, row = pos / LRS, col = pos % LRS;
    if (col < cols)
      cp_async16(lb + (row * cols + col) * CC + half,
                 src + static_cast<int64_t>(row * w_in + col) * c + half, true);
  }
}

// The lr_up halo of one 16-channel chunk from the chunk's staged LR
// positions lb (stage_lr) into dst[(row * (TW + 2) + col) * 16] bf16, 0
// outside the image, and its 16 x 16 interior into keep[(row * TW + col)
// * 16]. PyTorch's arithmetic (upsample_bilinear2d_nhwc): a row's lerp
// fma(lw0, x0, lw1 * x1), then fma(lh0, row0, lh1 * row1), rounded once to
// bf16. That is the contraction of PyTorch's compiled kernel, so each
// value equals F.interpolate's on the card bit for bit. A thread takes one
// column, one channel pair and a third of the rows top down, and keeps the
// lerps of the two LR rows it read for the next output row (at x2 they
// serve two).
__device__ __forceinline__ void lerp_halo(__nv_bfloat16* dst, __nv_bfloat16* keep,
                                          const __nv_bfloat16* lb, const LrTile& t) {
  constexpr int LH = TH + 2, LW = TW + 2, RUNS = 3, RUN = LH / RUNS;
  static_assert(LH % RUNS == 0 && LW * (CC / 2) * RUNS <= NT, "one item a thread");
  const int it = threadIdx.x;
  if (it >= LW * (CC / 2) * RUNS) return;
  const int cl = 2 * (it % (CC / 2)), col = it / (CC / 2) % LW;
  const int row0 = RUN * (it / (CC / 2) / LW);
  const bool inner_col = col >= 1 && col <= TW;
  const int4 ce = t.col[col];
  const float lw0 = __int_as_float(ce.z), lw1 = __int_as_float(ce.w);
  const __nv_bfloat16 *p0 = lb + ce.x + cl, *p1 = lb + ce.y + cl;
  auto row_lerp = [&](int off) {
    const float2 x0 = load_bf16x2(p0 + off), x1 = load_bf16x2(p1 + off);
    return make_float2(__fmaf_rn(lw0, x0.x, __fmul_rn(lw1, x1.x)),
                       __fmaf_rn(lw0, x0.y, __fmul_rn(lw1, x1.y)));
  };
  int have = -1, have1 = -1;  // the offsets of the LR rows whose lerps a and b hold
  float2 a = make_float2(0.0f, 0.0f), b = a;
#pragma unroll
  for (int k = 0; k < RUN; ++k) {
    const int row = row0 + k;
    const int4 re = t.row[row];
    uint32_t v = 0u;
    if (ce.x >= 0 && re.x >= 0) {
      if (re.x != have) {
        a = re.x == have1 ? b : row_lerp(re.x);
        b = re.y == re.x ? a : row_lerp(re.y);
        have = re.x;
        have1 = re.y;
      }
      const float lh0 = __int_as_float(re.z), lh1 = __int_as_float(re.w);
      v = pack_bf16(__fmaf_rn(lh0, a.x, __fmul_rn(lh1, b.x)),
                    __fmaf_rn(lh0, a.y, __fmul_rn(lh1, b.y)));
    }
    *reinterpret_cast<uint32_t*>(dst + (row * LW + col) * CC + cl) = v;
    if (inner_col && row >= 1 && row <= TH)
      *reinterpret_cast<uint32_t*>(keep + ((row - 1) * TW + col - 1) * CC + cl) = v;
  }
}

// 3x3 depthwise conv (+bias) of a staged raw halo `src` (row width SW) at
// rows x cols positions into dst[(row * DSTRIDE + col) * PS + ch], rounded to
// bf16; with MASK, positions outside the image (origin gy0, gx0) are 0,
// bias included. tb: the conv's staged [9 taps + bias][16] float32. Each
// thread takes one channel pair and VR output rows at a time; taps are
// summed columns outer, rows inner, then the bias, as the TPU kernel and
// the plain version sum them.
template <int SW, int ROWS, int COLS, int DSTRIDE, bool MASK>
__device__ __forceinline__ void dw3(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                    const float* tb, int h, int w, int gy0, int gx0) {
  static_assert(ROWS % VR == 0, "rows per item must divide the rows");
  const int cl = 2 * (threadIdx.x & 7);
  const float2* tp = reinterpret_cast<const float2*>(tb + cl);  // tap o at tp[o * CC / 2]
  const float2 bs = tp[9 * CC / 2];
  for (int it = threadIdx.x >> 3; it < (ROWS / VR) * COLS; it += NT / 8) {
    const int r0 = VR * (it / COLS), q = it % COLS;
    float ax[VR], ay[VR];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      float2 v[VR + 2];  // column q + b, rows r0 .. r0 + VR + 1
#pragma unroll
      for (int a = 0; a < VR + 2; ++a) v[a] = load_bf16x2(src + ((r0 + a) * SW + q + b) * CC + cl);
#pragma unroll
      for (int o = 0; o < VR; ++o)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float2 tap = tp[(a * 3 + b) * CC / 2];
          const float tx = __fmul_rn(v[o + a].x, tap.x);
          const float ty = __fmul_rn(v[o + a].y, tap.y);
          ax[o] = (a == 0 && b == 0) ? tx : __fadd_rn(ax[o], tx);
          ay[o] = (a == 0 && b == 0) ? ty : __fadd_rn(ay[o], ty);
        }
    }
#pragma unroll
    for (int o = 0; o < VR; ++o) {
      const int r = r0 + o;
      const bool in = !MASK || (gy0 + r >= 0 && gy0 + r < h && gx0 + q >= 0 && gx0 + q < w);
      *reinterpret_cast<uint32_t*>(dst + (r * DSTRIDE + q) * PS + cl) =
          in ? pack_bf16(__fadd_rn(ax[o], bs.x), __fadd_rn(ay[o], bs.y)) : 0u;
    }
  }
}

// ---- the window products and the band softmax, shared by module_kernel
// and K4 (creff_attention.cu). A warp owns the 16 pixels of one segment;
// q_seg points at their 16 staged Q positions ([position][PS]), kv_row at
// the first of the K rows of K or V that their windows read (row stride
// KVP positions; position 0 is the first window column of pixel 0).

// s[dy] += Q[16 px, 16 ch] . K[row dy, 24 positions, 16 ch]^T: one
// 16-channel chunk of the logits, three n8 tiles per window row.
template <int K>
__device__ __forceinline__ void window_logits(float (&s)[K][3][4], const __nv_bfloat16* q_seg,
                                              const __nv_bfloat16* kv_row) {
  const int lane = threadIdx.x & 31;
  uint32_t a[4];
  ldsm_x4(a, q_seg + ((lane & 7) + ((lane >> 3) & 1) * 8) * PS + (lane >> 4) * 8);
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const __nv_bfloat16* kb = kv_row + dy * KVP * PS;
    uint32_t b[4], b2[2];
    ldsm_x4(b, kb + ((lane & 7) + (lane >> 4) * 8) * PS + ((lane >> 3) & 1) * 8);
    ldsm_x2(b2, kb + (16 + (lane & 7)) * PS + ((lane >> 3) & 1) * 8);
    mma(s[dy][0], a, b[0], b[1]);
    mma(s[dy][1], a, b[2], b[3]);
    mma(s[dy][2], a, b2[0], b2[1]);
  }
}

// Softmax over the band, p rounded to bf16. Column col = 8 nt + 2t + e of
// row r is window position col - px of pixel px = g + 8r, inside the
// window iff px <= col < px + K; off-band entries of p are exactly 0. A
// pixel's row lives on the four lanes of a quad.
template <int K>
__device__ __forceinline__ void band_softmax(float (&s)[K][3][4], uint32_t (&p)[K][3][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int px = g + 8 * r;
    float m = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * nt + 2 * t + e;
          if (col >= px && col < px + K) m = fmaxf(m, s[dy][nt][2 * r + e]);
        }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    float sum = 0.0f;
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * nt + 2 * t + e;
          const float ex = (col >= px && col < px + K) ? expf(s[dy][nt][2 * r + e] - m) : 0.0f;
          s[dy][nt][2 * r + e] = ex;
          sum += ex;
        }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
#pragma unroll
    for (int dy = 0; dy < K; ++dy)
#pragma unroll
      for (int nt = 0; nt < 3; ++nt)
        p[dy][nt][r] = pack_bf16(s[dy][nt][2 * r] / sum, s[dy][nt][2 * r + 1] / sum);
  }
}

// pv += p . V[row dy, positions, 16 ch] over the window rows: positions
// 0..15 of the band as one k16 step, 16..23 as one k8 step (a pixel's
// window ends at position 15 + K - 1 <= 21). pv[nt][2r + e] is pixel
// g + 8r, channel 8 nt + 2t + e of the chunk.
template <int K>
__device__ __forceinline__ void window_pv(float (&pv)[2][4], const uint32_t (&p)[K][3][2],
                                          const __nv_bfloat16* kv_row) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    const __nv_bfloat16* vb = kv_row + dy * KVP * PS;
    uint32_t b[4], b2[2];
    ldsm_x4_t(b, vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * PS + (lane >> 4) * 8);
    ldsm_x2_t(b2, vb + (16 + (lane & 7)) * PS + ((lane >> 3) & 1) * 8);
    const uint32_t a[4] = {p[dy][0][0], p[dy][0][1], p[dy][1][0], p[dy][1][1]};
    const uint32_t a2[2] = {p[dy][2][0], p[dy][2][1]};
    mma(pv[0], a, b[0], b[1]);
    mma(pv[1], a, b[2], b[3]);
    mma_k8(pv[0], a2, b2[0]);
    mma_k8(pv[1], a2, b2[1]);
  }
}

// K/V positions KW..KVP-1 of `rows` rows at kv: read by the products,
// never written by a copy or a conv; zeroed once so that p = 0 never meets
// stale memory (0 x NaN).
template <int KW, int THREADS>
__device__ __forceinline__ void zero_kv_pad(__nv_bfloat16* kv, int rows) {
  constexpr int PAD = KVP - KW;
  for (int i = threadIdx.x; i < rows * PAD * (CC / 2); i += THREADS) {
    const int ch = 2 * (i % (CC / 2)), pos = i / (CC / 2);
    const int row = pos / PAD, col = KW + pos % PAD;
    *reinterpret_cast<uint32_t*>(kv + (row * KVP + col) * PS + ch) = 0u;
  }
}

// Grid: (ceil(w / SW), ceil(h / SH), n) with SW = TW - 2 HALO and
// SH = TH - 2 HALO; NT threads; smem_bytes<K>(epi) of dynamic shared
// memory. With Epi::HALO = 0 the tiles partition the image; with HALO = 1
// a block's 16 x 16 tile starts one row and one column before its 14 x 14
// interior, so neighbouring tiles overlap by two pixels. Chunks 0..nc-1
// are pass 1 (the logits), chunks nc..2nc-1 pass 2 (p . v + residual ->
// epilogue). Step j of one pipeline over both passes, between one barrier
// and the next: start the copies of chunk j + 2, convolve chunk j + 1 (K
// and Q, or V) on the CUDA cores, and multiply chunk j on the tensor
// cores, so one warp's products overlap another's convs. With LrUp, pass-1
// step j also starts the copies of chunk j + 3's LR halo and lerps chunk
// j + 2's lr_up halo from it.
template <int K, class Epi>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    module_kernel(const __nv_bfloat16* __restrict__ lr, const __nv_bfloat16* __restrict__ ref,
                  const float* __restrict__ taps, const float* __restrict__ bias, int h, int w,
                  int c, const __grid_constant__ Epi epi) {
  using G = Geom<K>;
  constexpr int HALO = Epi::HALO;
  constexpr bool LR = is_lr_up<Epi>::value;  // lr is the LR feature; lr_up is built here
  static_assert(!LR || (HALO == 0 && TH == TW), "the LR input takes partitioning square tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* rbuf = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [3][RBUF] raw ref
  constexpr int LSLOTS = LR ? 2 : 3;  // LR: the lr_up halo is read in pass 1 alone
  __nv_bfloat16* lbuf = rbuf + 3 * G::RBUF;  // [LSLOTS][LBUF] raw lr_up
  __nv_bfloat16* kv_s = lbuf + LSLOTS * G::LBUF;  // [2][KH][KVP][PS]: K (pass 1) or V (pass 2)
  __nv_bfloat16* q_s = kv_s + 2 * G::KV;     // [2][TH * TW][PS]: Q; pass 2: epilogue scratch
  float* t_s = reinterpret_cast<float*>(q_s + 2 * G::Q);  // [3][TB] taps and biases
  // LR: the tile's geometry, [2][slot] raw LR halos, [nc][TH * TW][CC]
  // lr_up interiors
  LrTile* lt = reinterpret_cast<LrTile*>(t_s + 3 * G::TB);
  __nv_bfloat16* lrbuf = reinterpret_cast<__nv_bfloat16*>(lt + 1);
  __nv_bfloat16* keep = lrbuf;
  if constexpr (LR) keep += 2 * epi.slot;

  const int warp = threadIdx.x >> 5;
  const int py = warp;  // the warp's output row in the tile
  const int y0 = blockIdx.y * (TH - 2 * HALO) - HALO, x0 = blockIdx.x * (TW - 2 * HALO) - HALO;
  const int64_t plane = static_cast<int64_t>(h) * w * c;
  const __nv_bfloat16* lr_img;
  if constexpr (LR)
    lr_img = lr + blockIdx.z * (static_cast<int64_t>(epi.h_in) * epi.w_in * c);
  else
    lr_img = lr + blockIdx.z * plane;
  const __nv_bfloat16* ref_img = ref + blockIdx.z * plane;
  const int nc = c / CC;

  zero_kv_pad<G::KW, NT>(kv_s, 2 * G::KH);  // rows of both buffers
  if constexpr (LR) {
    lr_tile(*lt, epi, h, w, y0, x0);
    __syncthreads();
  }

  auto issue = [&](int j) {  // start the copies of chunk j into ring slot j % 3
    if (j < 2 * nc)
      stage_chunk<K, !LR>(rbuf + (j % 3) * G::RBUF, lbuf + (j % 3) * G::LBUF,
                          t_s + (j % 3) * G::TB, ref_img, lr_img, taps, bias, h, w, c,
                          (j % nc) * CC, y0, x0);
    if constexpr (LR)  // and pass-1 chunk j + 1's LR halo, lerped a step before its convs
      if (j + 1 < nc)
        stage_lr(lrbuf + ((j + 1) & 1) * epi.slot, lr_img, *lt, epi.w_in, c, (j + 1) * CC);
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };
  // LR: pass-1 chunk j's lr_up halo into lr_up slot j & 1, its interior kept
  auto lerp = [&](int j) {
    if constexpr (LR)
      if (j < nc)
        lerp_halo(lbuf + (j & 1) * G::LBUF, keep + j * (TH * TW * CC), lrbuf + (j & 1) * epi.slot,
                  *lt);
  };
  auto convolve = [&](int j) {  // chunk j's K and Q, or V, into buffer j & 1
    const __nv_bfloat16* rb = rbuf + (j % 3) * G::RBUF;
    const float* tb = t_s + (j % 3) * G::TB;
    __nv_bfloat16* kv = kv_s + (j & 1) * G::KV;
    if (j < nc) {
      dw3<G::RW, G::KH, G::KW, KVP, true>(kv, rb, tb + 10 * CC, h, w, y0 - G::P, x0 - G::P);
      dw3<G::LW, TH, TW, TW, false>(q_s + (j & 1) * G::Q, lbuf + (j % LSLOTS) * G::LBUF, tb, h,
                                    w, 0, 0);
    } else {
      dw3<G::RW, G::KH, G::KW, KVP, true>(kv, rb, tb + 20 * CC, h, w, y0 - G::P, x0 - G::P);
    }
  };
  // one step: chunk j + 1 has landed, start chunk j + 2's copies into the
  // ring slot of chunk j - 1 and convolve chunk j + 1
  auto begin_step = [&](int j) {
    cp_async_wait_all();
    __syncthreads();  // step j - 1 is done: chunk j's convs are visible
    issue(j + 2);
    lerp(j + 2);
    if (j + 1 < 2 * nc) convolve(j + 1);
  };

  float s[K][3][4];  // logits: window row dy, n8 tile of positions, fragment
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int nt = 0; nt < 3; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[dy][nt][e] = 0.0f;
  uint32_t p[K][3][2];  // p in bf16 pairs: window row, n8 tile, pixel row g + 8r

  if constexpr (LR) {  // chunk 0's LR halo, in chunk 0's group with chunk 1's
    stage_lr(lrbuf, lr_img, *lt, epi.w_in, c, 0);
    issue(0);
    cp_async_wait_all();
    __syncthreads();
    lerp(0);
    lerp(1);
    __syncthreads();  // both LR slots free: chunk 1's copies bring chunk 2's
    issue(1);
  } else {
    issue(0);
    issue(1);
    cp_async_wait_all();
    __syncthreads();
  }
  convolve(0);
  // ---- pass 1: S_dy += Q . K_dy^T, 16 channels a step -------------------
  for (int j = 0; j < nc; ++j) {
    begin_step(j);
    window_logits<K>(s, q_s + (j & 1) * G::Q + py * TW * PS,
                     kv_s + (j & 1) * G::KV + py * KVP * PS);
  }
  band_softmax<K>(s, p);

  // ---- pass 2: p . V_dy + residual -> epilogue, 16 channels a step -------
  // The epilogue's state comes to registers only now, when the logits are
  // gone.
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  typename Epi::State st{};
  Seg seg;
  {
    const int gy = y0 + py;
    const bool row_in = gy >= 0 && gy < h;
    seg.lo = row_in ? max(0, -x0) : 0;
    seg.hi = row_in ? max(seg.lo, min(TW, w - x0)) : 0;
    seg.pix0 = (static_cast<int64_t>(blockIdx.z) * h + gy) * w + x0;
    seg.scratch = q_s + py * 2 * TW * PS;  // both Q buffers: free in pass 2
  }
  for (int j = nc; j < 2 * nc; ++j) {
    begin_step(j);
    const __nv_bfloat16* lb = lbuf + (j % 3) * G::LBUF;  // the residual lr_up
    // LR: the halo's interior kept in pass 1
    const __nv_bfloat16* kb = keep + ((j - nc) * TH * TW + py * TW) * CC;
    float acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v =
            LR ? load_bf16x2(kb + (g + 8 * r) * CC + 8 * nt + 2 * t)
               : load_bf16x2(lb + ((py + 1) * G::LW + g + 8 * r + 1) * CC + 8 * nt + 2 * t);
        acc[nt][2 * r] = v.x;
        acc[nt][2 * r + 1] = v.y;
      }
    float pv[2][4] = {};
    window_pv<K>(pv, p, kv_s + (j & 1) * G::KV + py * KVP * PS);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += pv[nt][e];
    epi.chunk(st, seg, (j - nc) * CC, acc);
  }
  epi.finish(st, seg);
}

template <int K, class Epi>
int launch(const void* lr, const void* ref, const float* taps, const float* bias, int n, int h,
           int w, int c, const Epi& epi, cudaStream_t stream) {
  if (n == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(lr) | reinterpret_cast<uintptr_t>(ref) |
       reinterpret_cast<uintptr_t>(taps) | reinterpret_cast<uintptr_t>(bias)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);  // 16-byte cp.async sources
  const int smem = smem_bytes<K>(epi, c);
  cudaError_t err = cudaFuncSetAttribute(module_kernel<K, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int SH = TH - 2 * Epi::HALO, SW = TW - 2 * Epi::HALO;  // tile strides
  const dim3 grid((w + SW - 1) / SW, (h + SH - 1) / SH, n);
  module_kernel<K, Epi><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(lr), static_cast<const __nv_bfloat16*>(ref), taps, bias,
      h, w, c, epi);
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

}  // namespace creff_mma
