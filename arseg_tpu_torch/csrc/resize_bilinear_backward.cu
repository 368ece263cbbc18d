// The backward of bilinear resize (F.interpolate, mode "bilinear",
// align_corners True and False), in gather form: NCHW and NHWC.
//
// Replaces no TPU kernel: the JAX package leaves this backward to XLA (the
// transpose of its resize's gathers). It was added because PyTorch's own
// backward on the card scatters: one thread per element of the incoming
// gradient g (at the output size) makes four atomic adds into the gradient
// at the input size, in the input's type. At the x8 and x16 factors of
// BiSeNet's heads 256 to 1,024 adds contend for each input element, each
// rounded to bfloat16, and it took half of an FST training step.
//
// The function. With Ah, Aw the forward's per-axis weights (output index o
// reads input indices i0(o), i1(o) with weights 1 - w(o), w(o)):
//   dx[p, i, j] = sum_oh Ah[oh, i] * sum_ow Aw[ow, j] * g[p, oh, ow].
// The output indices that read input index j form one contiguous run, since
// i0 is monotonic. The launcher gets those runs as transposed tables, built
// on the host from the forward's own float32 weights: per input index, the
// first output index of its run and the run's length ([in][2] int32), and
// the run's weights ([in][L] float32, L the longest run: 20 at x8 and 40
// at x16 align_corners=False, where the clamped first coordinates pile on).
//
// What bounds it on the H100: bytes. Each element of g is read once and each
// element of dx written once; the sums are 2 to 4 float32 multiply-adds per
// element of g. At the FST step's shapes g is 4 to 16 times dx.
//
// Design: two separable stages in one launch, no atomics, no zero-fill pass,
// no float32 buffer in device memory; float32 sums and one rounding to the
// input's type.
// - Stage 1 reads output rows once from device memory and contracts them
//   along W into shared memory, float32: T[oh, j] = sum over j's run of
//   Aw * g. Stage 2 contracts T along H and writes each element of dx once.
// - NCHW: a block owns a band of input rows of one plane and walks down the
//   output rows that read it, a chunk at a time: whole rows (contiguous in
//   memory), up to 4 16-byte loads a thread held in registers, the next
//   chunk's loads in flight while the block contracts the last one. Rows
//   sit in shared memory at a stride that skips one word every 32, so that
//   lanes (one j each) reading runs that start s words apart (s = 2, 8, 16)
//   hit distinct banks; a lane takes 4 rows of its j, so that a run's
//   weights and offsets, read once, serve 4 independent sums (instruction
//   issue, not the bytes, held these shapes back with a lane per element).
//   The column tables are copied into shared memory once a block, the
//   weights at an odd pitch. T's rows go to a ring that holds a chunk and
//   a run; after each chunk the block writes the input rows whose runs have
//   ended, a lane per element (4 rows a lane gained nothing there and took
//   79 registers). So a band can be tall: the launcher cuts a plane into a
//   few bands, enough for the grid to fill the card, and the tables and the
//   rows two bands share (read from L2: neighbouring bands are neighbouring
//   blocks) cost little.
//   Not done: at x2 (the OHEM resize) the float32 staging's shared-memory
//   traffic is about as long as the bytes from device memory, and the
//   kernel reaches ~21% of its bound there (x8: ~38%); lanes reading runs
//   straight from L1 would skip the staging at that factor.
// - NHWC: a block owns a band of input rows of one tile of channels of one
//   image, and T for all the output rows that read it (`rmax`); a lane per
//   (row, j, 16 bytes of channels) reads its run of pixels with 16-byte
//   loads, neighbouring lanes on neighbouring channels, so a warp reads
//   whole 32-byte sectors; stage 2 a lane per 16 bytes of dx.
// - Input indices that no output reads (a resize to a smaller size) get 0.
// The launcher takes the band height and the tile (rows a chunk, NCHW; 16-
// byte vectors of channels a tile, NHWC) from the caller, which sizes them
// against the shared memory and the number of blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;         // 16-byte loads of a chunk a thread holds in registers
constexpr int kRows = 4;          // staged rows one lane contracts along W together
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may take on the H100

// one word skipped every 32, so that stride-2^k lanes hit distinct banks
__device__ __forceinline__ int skew(int x) { return x + (x >> 5); }

// 16 bytes of T as raw bits and as float32, and single elements
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static uint4 raw(const float* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ static void unpack(uint4 u, float v[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  __device__ static void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float load1(const float* p) { return __ldg(p); }
  __device__ static void store1(float* p, float v) { *p = v; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static uint4 raw(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // a bfloat16 is the upper half of its float32
  __device__ static void unpack(uint4 u, float v[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float v[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load1(const __nv_bfloat16* p) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<uint32_t>(u) << 16);
  }
  __device__ static void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
};

// The output rows [o0, o1) that read input rows [i0, i1); empty if none
// does. Runs' starts and ends never fall, so the first run starts it and
// the last one ends it.
__device__ __forceinline__ void band_rows(const int2* __restrict__ th, int i0, int i1, int& o0,
                                          int& o1) {
  const int2 first = __ldg(th + i0), last = __ldg(th + i1 - 1);
  o0 = first.x;
  o1 = last.x + last.y;
  if (o1 <= o0) o0 = o1 = 0;
}

__host__ __device__ inline int row_pitch(int wout) { return wout + ((wout - 1) >> 5) + 1; }

// NCHW shared memory, in floats: the column tables (runs; weights at an odd
// pitch), 16-byte aligned, then the staged rows, then the ring of T's rows
__host__ __device__ inline int column_floats(int win, int lw) {
  return (2 * win + win * (lw | 1) + 3) / 4 * 4;
}

__host__ __device__ inline int ring_rows(int chunk, int lh) {
  int r = 1;
  while (r < chunk + lh) r *= 2;
  return r;
}

// NCHW: g [planes][hout][wout] -> dx [planes][hin][win]. Block b: plane
// b / nbands, band b % nbands. The block walks down its band's output rows
// `chunk` at a time: stages them in shared memory (with `vec`, 16-byte
// rows, the next chunk's loads are in flight in registers meanwhile),
// contracts them along W into a ring of T's rows, then writes each input
// row whose run has ended. Runs' ends never fall, so those rows are the
// next few; the ring holds a chunk and a run (ring_rows), so no row is
// overwritten before the last input row that reads it is written.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    resize_backward_nchw(T* __restrict__ dx, const T* __restrict__ g,
                         const int2* __restrict__ th, const float* __restrict__ wh, int lh,
                         const int2* __restrict__ tw, const float* __restrict__ ww, int lw,
                         int hin, int win, int hout, int wout, int bh, int nbands, int chunk,
                         int ring, int vec) {
  constexpr int V = Vec<T>::n;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lwp = lw | 1;
  const int gp = row_pitch(wout);
  int2* s_tw = reinterpret_cast<int2*>(smem);
  float* s_ww = smem + 2 * win;
  float* s_g = smem + column_floats(win, lw);  // [chunk][gp], skewed
  float* s_t = s_g + chunk * gp;               // [ring][win]

  const int band = blockIdx.x % nbands;
  const int64_t plane = blockIdx.x / nbands;
  const int i0 = band * bh, i1 = min(i0 + bh, hin);
  int o0, o1;
  band_rows(th, i0, i1, o0, o1);
  for (int k = threadIdx.x; k < win; k += kThreads) s_tw[k] = __ldg(tw + k);
  for (int k = threadIdx.x; k < win * lw; k += kThreads) {
    const int j = k / lw;
    s_ww[j * lwp + (k - j * lw)] = __ldg(ww + k);
  }
  const T* gpl = g + plane * hout * wout;
  T* dpl = dx + plane * hin * win;
  const int per_row = wout / V;  // 16-byte vectors a row (vec)

  // the vec path: a chunk's rows are contiguous, wout % V == 0, so no
  // vector crosses a row or a 32-word group of the skewed layout; the
  // launcher keeps chunk * per_row <= kLoads * kThreads
  uint4 buf[kLoads];
  auto fetch = [&](int c0, int rc) {
    const T* src = gpl + static_cast<int64_t>(c0) * wout;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int v = threadIdx.x + u * kThreads;
      if (v < rc * per_row) buf[u] = Vec<T>::raw(src + static_cast<int64_t>(v) * V);
    }
  };
  // input rows [from, to): their runs' rows are in the ring (none for an
  // empty run, which gets 0)
  auto emit = [&](int from, int to) {
    for (int item = threadIdx.x; item < (to - from) * win; item += kThreads) {
      const int r = item / win, j = item - r * win, i = from + r;
      const int2 t = __ldg(th + i);
      const float* wi = wh + static_cast<int64_t>(i) * lh;
      float acc = 0.f;
      for (int k = 0; k < t.y; ++k)
        acc = fmaf(__ldg(wi + k), s_t[((t.x + k - o0) & (ring - 1)) * win + j], acc);
      Vec<T>::store1(dpl + i * win + j, acc);
    }
  };

  int next = i0;  // the first input row not written yet
  int c0 = o0, rc = min(chunk, o1 - o0);
  if (vec && rc > 0) fetch(c0, rc);
  while (c0 < o1) {
    __syncthreads();  // the last chunk's readers are done (and the tables are in)
    if (vec) {
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int v = threadIdx.x + u * kThreads;
        if (v < rc * per_row) {
          const int r = v / per_row;
          float x[V];
          Vec<T>::unpack(buf[u], x);
          float* d = s_g + r * gp + skew((v - r * per_row) * V);
#pragma unroll
          for (int q = 0; q < V; ++q) d[q] = x[q];
        }
      }
    } else {
      const T* src = gpl + static_cast<int64_t>(c0) * wout;
      for (int e = threadIdx.x; e < rc * wout; e += kThreads) {
        const int r = e / wout;
        s_g[r * gp + skew(e - r * wout)] = Vec<T>::load1(src + e);
      }
    }
    __syncthreads();
    const int done = c0 + rc, nrc = min(chunk, o1 - done);
    if (vec && nrc > 0) fetch(done, nrc);
    // a lane per (kRows rows, j): the run's weights and offsets serve
    // kRows independent sums
    for (int item = threadIdx.x; item < (rc + kRows - 1) / kRows * win; item += kThreads) {
      const int r0 = item / win * kRows, j = item - item / win * win;
      const int2 t = s_tw[j];
      const float* wj = s_ww + j * lwp;
      const float* rows = s_g + r0 * gp;
      float acc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] = 0.f;
      for (int k = 0; k < t.y; ++k) {
        const float w = wj[k];
        const int x = skew(t.x + k);
#pragma unroll
        for (int q = 0; q < kRows; ++q)
          if (r0 + q < rc) acc[q] = fmaf(w, rows[q * gp + x], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (r0 + q < rc) s_t[((c0 + r0 + q - o0) & (ring - 1)) * win + j] = acc[q];
    }
    __syncthreads();
    int last = next;
    while (last < i1) {
      const int2 t = __ldg(th + last);
      if (t.x + t.y > done) break;
      ++last;
    }
    emit(next, last);
    next = last;
    c0 = done;
    rc = nrc;
  }
  emit(next, i1);  // rows that no output row of the band reads
}

// NHWC: g [n][hout][wout][c] -> dx [n][hin][win][c], c % V == 0; a tile is
// `cv` 16-byte vectors of channels. Block b: tile b % ntiles, then band,
// then image.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    resize_backward_nhwc(T* __restrict__ dx, const T* __restrict__ g,
                         const int2* __restrict__ th, const float* __restrict__ wh, int lh,
                         const int2* __restrict__ tw, const float* __restrict__ ww, int lw,
                         int hin, int win, int hout, int wout, int c, int bh, int nbands,
                         int cv, int ntiles) {
  constexpr int V = Vec<T>::n;
  extern __shared__ float4 smem4[];
  float* s_t = reinterpret_cast<float*>(smem4);  // [rows][win][ct]
  const int ct = cv * V;  // channels in a full tile: the pitch of T's pixels

  const int tile = blockIdx.x % ntiles;
  const int rest = blockIdx.x / ntiles;
  const int band = rest % nbands;
  const int64_t img = rest / nbands;
  const int c0 = tile * ct;
  const int cvt = min(cv, (c - c0) / V);  // vectors in this tile
  const int i0 = band * bh, i1 = min(i0 + bh, hin);
  int o0, o1;
  band_rows(th, i0, i1, o0, o1);

  const int per_row = win * cvt;
  const T* gi = g + img * hout * wout * c + c0;
  for (int item = threadIdx.x; item < (o1 - o0) * per_row; item += kThreads) {
    const int r = item / per_row, rem = item - r * per_row;
    const int j = rem / cvt, v = rem - j * cvt;
    const int2 t = __ldg(tw + j);
    const float* wj = ww + j * lw;
    const T* src = gi + (static_cast<int64_t>(o0 + r) * wout + t.x) * c + v * V;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    for (int k = 0; k < t.y; ++k) {
      float x[V];
      Vec<T>::unpack(Vec<T>::raw(src + static_cast<int64_t>(k) * c), x);
      const float w = __ldg(wj + k);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = fmaf(w, x[q], acc[q]);
    }
    float* d = s_t + (r * win + j) * ct + v * V;
#pragma unroll
    for (int q = 0; q < V; q += 4)
      *reinterpret_cast<float4*>(d + q) = make_float4(acc[q], acc[q + 1], acc[q + 2], acc[q + 3]);
  }
  __syncthreads();
  T* di = dx + img * hin * win * c + c0;
  for (int item = threadIdx.x; item < (i1 - i0) * per_row; item += kThreads) {
    const int r = item / per_row, rem = item - r * per_row;
    const int j = rem / cvt, v = rem - j * cvt, i = i0 + r;
    const int2 t = __ldg(th + i);
    const float* wi = wh + static_cast<int64_t>(i) * lh;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    for (int k = 0; k < t.y; ++k) {
      const float w = __ldg(wi + k);
      const float4* s = reinterpret_cast<const float4*>(s_t + ((t.x + k - o0) * win + j) * ct +
                                                        v * V);
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        const float4 y = s[q];
        acc[4 * q] = fmaf(w, y.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(w, y.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(w, y.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(w, y.w, acc[4 * q + 3]);
      }
    }
    Vec<T>::store(di + (static_cast<int64_t>(i) * win + j) * c + v * V, acc);
  }
}

template <typename T>
int launch(void* dx, const void* g, const int* th, const float* wh, int lh, const int* tw,
           const float* ww, int lw, int n, int c, int hin, int win, int hout, int wout, int bh,
           int rmax, int tile, int layout, cudaStream_t stream) {
  constexpr int V = Vec<T>::n;
  const int nbands = (hin + bh - 1) / bh;
  // 16-byte rows whose chunk fits the registers' loads
  const int vec = wout % V == 0 && wout / V <= kLoads * kThreads &&
                  reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const int ring = ring_rows(tile, lh);
  int64_t blocks, floats;
  if (layout == 0) {
    if (vec && static_cast<int64_t>(tile) * (wout / V) > kLoads * kThreads)
      return static_cast<int>(cudaErrorInvalidValue);
    floats = column_floats(win, lw) + static_cast<int64_t>(tile) * row_pitch(wout) +
             static_cast<int64_t>(ring) * win;
    blocks = static_cast<int64_t>(n) * c * nbands;
  } else {
    if (c % V != 0 || reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(dx) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    floats = static_cast<int64_t>(rmax) * win * tile * V;
    blocks = static_cast<int64_t>(n) * nbands * ((c / V + tile - 1) / tile);
  }
  const int64_t smem = floats * 4;
  if (smem > kMaxSmem || blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  const int2* th2 = reinterpret_cast<const int2*>(th);
  const int2* tw2 = reinterpret_cast<const int2*>(tw);
  cudaError_t err;
  if (layout == 0) {
    err = cudaFuncSetAttribute(resize_backward_nchw<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    resize_backward_nchw<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<T*>(dx), static_cast<const T*>(g), th2, wh, lh, tw2, ww, lw, hin, win, hout,
        wout, bh, nbands, tile, ring, vec);
  } else {
    err = cudaFuncSetAttribute(resize_backward_nhwc<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    resize_backward_nhwc<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
        static_cast<T*>(dx), static_cast<const T*>(g), th2, wh, lh, tw2, ww, lw, hin, win, hout,
        wout, c, bh, nbands, tile, (c / V + tile - 1) / tile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arseg_resize_bilinear_backward(void* dx, const void* g, const int* th,
                                              const float* wh, int lh, const int* tw,
                                              const float* ww, int lw, int n, int c, int hin,
                                              int win, int hout, int wout, int bh, int rmax,
                                              int tile, int layout, int dtype, void* stream) {
  // offsets inside one plane or image are int32
  if (n < 0 || c <= 0 || hin <= 0 || win <= 0 || hout <= 0 || wout <= 0 || lh <= 0 || lw <= 0 ||
      bh <= 0 || rmax < 0 || tile <= 0 || (layout != 0 && layout != 1) ||
      static_cast<int64_t>(hout) * wout * (layout ? c : 1) > INT_MAX ||
      static_cast<int64_t>(hin) * win * (layout ? c : 1) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(dx, g, th, wh, lh, tw, ww, lw, n, c, hin, win, hout, wout, bh, rmax,
                         tile, layout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(dx, g, th, wh, lh, tw, ww, lw, n, c, hin, win, hout, wout, bh,
                                 rmax, tile, layout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
