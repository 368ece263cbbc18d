// The resize-and-argmax head: class logits at the feature grid in, the int32
// argmax of their bilinear resize (F.interpolate, mode "bilinear",
// align_corners True or False) out, with no resized logits in device memory.
//
// Replaces no TPU kernel: the JAX package leaves the head's resize and
// argmax to XLA. On the card PyTorch runs them as two kernels: the resize
// writes the logits at the output size (19 classes of 88 frames at
// 1024x2048 in bf16: 7.0 GB), and the argmax reads them all back. Its
// resize also refuses an output of 2^31 elements, so that head ran over
// chunks of frames.
//
// What bounds it on the H100. Bytes: the logits are read once (88 x 19 x
// 128 x 256 bf16: 110 MB) and the maps written once (88 x 1024 x 2048
// int32: 738 MB), ~0.25 ms at 3.35 TB/s. Instructions: per output pixel
// and class a multiply, a multiply-add, a rounding to the logits' type and
// a compare (3.5e9 class-pixels at that shape), ~0.42 ms on the CUDA cores
// at one instruction each. The second bound is the larger; nothing is
// staged through device memory.
//
// The function, bit for bit PyTorch's. Along each axis, output index o
// reads source indices i = int(s) and i + (i < in - 1) with weights
// l0 = 1 - l1 and l1 = s - i, where s = r * o (align_corners) or
// max(0, fma(r, o + 0.5, -0.5)), r the float32 scale the launcher computes
// as PyTorch's host code does. The value is
//   v = fma(lh0, top, lh1 * bottom),  top, bottom = fma(lw0, x0, lw1 * x1)
// in float32, rounded once to the logits' type: the contraction of
// PyTorch's compiled kernels, found on the card by emulating the candidate
// contractions exactly and written with round-to-nearest intrinsics so that
// nvcc cannot contract it otherwise. One exception, the float32
// channels_last kernel: its top row is fma(lw1, x1, lw0 * x0); the caller
// says which kernel to match (`top_right`). The argmax keeps the lowest
// class on ties (a strict > over ascending classes) and the first NaN, as
// torch.argmax does.
//
// Design: the resize is separable with the same bits, since a row's lerp
// depends only on the source row and the output column.
// - A block takes one frame and a tile of 64 output rows by 128 columns:
//   8 warps of 8 rows, each lane 4 adjacent columns of its warp's rows. It
//   stages the source window the tile reads (at x8 ~11 rows by ~19 columns
//   of every class) in shared memory as float32, class-major, so that the
//   lanes of a warp read consecutive words. Where the window would not fit
//   (a resize to a much smaller size, or hundreds of classes) the lanes read
//   the logits from device memory instead, through the same code.
// - A lane computes its columns' and rows' indices and weights once. It
//   walks the classes; for each class it walks its 8 rows keeping the two
//   source rows' lerps of its 4 columns in registers, so that output rows
//   that read the same pair of source rows (about 8 a pair at x8) lerp them
//   once; the warp's rows are one, so the branch is uniform.
// - The running argmax of the lane's 32 pixels stays in registers. In
//   bfloat16 two pixels share a register: the values are rounded two at a
//   time (one instruction), compared as bfloat16 pairs and kept by bit
//   selects, the two classes 16 bits each. On the H100 that cut an
//   88-frame launch from 3.9 to 1.6 ms against a float32 value and class a
//   pixel (whose conversion and NaN test of each value cost more than the
//   lerp), and fits two blocks an SM.
// - Each lane writes its 4 columns of a row as one 16-byte int32 store
//   where the row's width is a multiple of 4 (a warp writes 512
//   contiguous bytes a row), else element by element.
// - Output offsets are 64-bit (an 88-frame launch writes 1.8e8 pixels of
//   3.5e9 class-values); the grid's z index walks frames, 65535 a launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "kernels.h"

namespace {

constexpr int kRows = 8;                // output rows a warp
constexpr int kCols = 4;                // adjacent output columns a lane
constexpr int kWarps = 8;               // warps a block
constexpr int kTileW = 32 * kCols;      // output columns a block
constexpr int kTileH = kWarps * kRows;  // output rows a block
constexpr int kStageMax = 48 * 1024;    // bytes of staged source a block may take

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// One axis: output index o reads source indices i0 and i1 with weights l0, l1.
struct Tap {
  int i0, i1;
  float l0, l1;
};

// PyTorch's area_pixel_compute_source_index in float32 (as contracted by
// its compiled kernel), then the index and weights of its bilinear kernels.
__device__ __forceinline__ Tap axis_tap(float r, int o, int in, bool align) {
  float s;
  if (align) {
    s = __fmul_rn(r, static_cast<float>(o));
  } else {
    s = __fmaf_rn(r, __fadd_rn(static_cast<float>(o), 0.5f), -0.5f);
    s = s < 0.0f ? 0.0f : s;
  }
  const int i = static_cast<int>(s);
  const float l1 = __fsub_rn(s, static_cast<float>(i));
  return Tap{i, i < in - 1 ? i + 1 : i, __fsub_rn(1.0f, l1), l1};
}

// The source window of a block, and how its lanes read it: staged in
// shared memory as float32 [row][class][col] (pitch `cols`), or straight
// from the NHWC logits of the frame.
template <typename T, bool kStaged>
struct Source {
  const T* frame;   // the frame's logits [h_in, w_in, c]
  const float* sm;  // the staged window
  int row0, col0;   // the window's first source row and column
  int cols, c, w_in;

  __device__ __forceinline__ float at(int row, int k, int col) const {
    if constexpr (kStaged)
      return sm[((row - row0) * c + k) * cols + (col - col0)];
    else
      return to_float(__ldg(frame + (static_cast<int64_t>(row) * w_in + col) * c + k));
  }
};

// The running argmax of a lane's kRows x kCols pixels over ascending
// classes: a strict >, and a NaN wins unless a NaN already has
// (torch.argmax's order). float32: a value and a class a pixel.
template <typename T>
struct Argmax {
  float best[kRows][kCols];
  int cls[kRows][kCols];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        best[r][j] = -INFINITY;
        cls[r][j] = 0;
      }
  }
  __device__ __forceinline__ void update(int r, const float (&v)[kCols], int k) {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (!(v[j] <= best[r][j]) && best[r][j] == best[r][j]) {
        best[r][j] = v[j];
        cls[r][j] = k;
      }
  }
  __device__ __forceinline__ int get(int r, int j) const { return cls[r][j]; }
};

// bfloat16: the values rounded to bfloat16 two at a time, as the resize's
// output is, compared as bfloat16 pairs; the best pair and its two classes
// (16 bits each) held in one register each, updated by bit selects.
template <>
struct Argmax<__nv_bfloat16> {
  uint32_t best[kRows][kCols / 2], cls[kRows][kCols / 2];

  static __device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
  }
  static __device__ __forceinline__ __nv_bfloat162 pair(uint32_t x) {
    return *reinterpret_cast<__nv_bfloat162*>(&x);
  }
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int p = 0; p < kCols / 2; ++p) {
        best[r][p] = 0xff80ff80u;  // -inf, -inf
        cls[r][p] = 0u;
      }
  }
  __device__ __forceinline__ void update(int r, const float (&v)[kCols], int k) {
    const uint32_t k2 = static_cast<uint32_t>(k) * 0x10001u;
#pragma unroll
    for (int p = 0; p < kCols / 2; ++p) {
      const __nv_bfloat162 x = __floats2bfloat162_rn(v[2 * p], v[2 * p + 1]);
      const __nv_bfloat162 b = pair(best[r][p]);
      const uint32_t m = __hgtu2_mask(x, b) & __heq2_mask(b, b);
      best[r][p] = (bits(x) & m) | (best[r][p] & ~m);
      cls[r][p] = (k2 & m) | (cls[r][p] & ~m);
    }
  }
  __device__ __forceinline__ int get(int r, int j) const {
    return static_cast<int>(j & 1 ? cls[r][j / 2] >> 16 : cls[r][j / 2] & 0xffffu);
  }
};

// A block: kWarps warps of kRows output rows, each lane kCols adjacent
// columns of its warp's rows. kTopRight: the top row's lerp multiplies-adds
// the right tap (PyTorch's float32 channels_last kernel); the top and
// bottom lerps of one source row then differ, and neither is reused for
// the other.
template <typename T, bool kStaged, bool kTopRight>
__global__ void __launch_bounds__(32 * kWarps, kStaged ? 2 : 1)
    resize_bilinear_argmax_kernel(int32_t* __restrict__ out, const T* __restrict__ logits,
                                  int c, int h_in, int w_in, int h, int w, float rh, float rw,
                                  int align, int win_rows, int win_cols) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int64_t n = blockIdx.z;
  const T* frame = logits + n * h_in * w_in * c;

  // the window: from the tile's first source index to its last's neighbour
  const int row0 = axis_tap(rh, y0, h_in, align).i0;
  const int col0 = axis_tap(rw, x0, w_in, align).i0;
  Source<T, kStaged> src{frame, sm, row0, col0, win_cols, c, w_in};
  if constexpr (kStaged) {
    // a thread a source pixel: its classes to words the window's width
    // apart, so that neighbouring lanes store to neighbouring words
    const int rows = min(win_rows, h_in - row0), cols = min(win_cols, w_in - col0);
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, col = i - r * cols;
      const T* p = frame + (static_cast<int64_t>(row0 + r) * w_in + col0 + col) * c;
      float* d = sm + r * c * win_cols + col;
      for (int k = 0; k < c; ++k) d[k * win_cols] = to_float(p[k]);
    }
    __syncthreads();
  }

  // the lane's columns and rows (clamped into the image; not stored past it)
  const int xl = x0 + lane * kCols, yl = y0 + warp * kRows;
  int ca[kCols], cb[kCols];
  float lw0[kCols], lw1[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const Tap t = axis_tap(rw, min(xl + j, w - 1), w_in, align);
    ca[j] = t.i0;
    cb[j] = t.i1;
    lw0[j] = t.l0;
    lw1[j] = t.l1;
  }
  int ra[kRows], rb[kRows];
  float lh0[kRows], lh1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const Tap t = axis_tap(rh, min(yl + r, h - 1), h_in, align);
    ra[r] = t.i0;
    rb[r] = t.i1;
    lh0[r] = t.l0;
    lh1[r] = t.l1;
  }

  Argmax<T> am;
  am.init();

  // the lerp along W of the lane's columns on one source row; `right`:
  // the right tap's product fused into the add
  auto lerp_row = [&](int row, int k, bool right, float (&v)[kCols]) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float x0 = src.at(row, k, ca[j]), x1 = src.at(row, k, cb[j]);
      v[j] = right ? __fmaf_rn(lw1[j], x1, __fmul_rn(lw0[j], x0))
                   : __fmaf_rn(lw0[j], x0, __fmul_rn(lw1[j], x1));
    }
  };

  for (int k = 0; k < c; ++k) {
    float va[kCols], vb[kCols];
    int have_a = -1, have_b = -1;  // the source rows va and vb hold
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (ra[r] != have_a) {
        if (!kTopRight && ra[r] == have_b) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) va[j] = vb[j];
        } else {
          lerp_row(ra[r], k, kTopRight, va);
        }
        if (!kTopRight && rb[r] == ra[r]) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) vb[j] = va[j];
        } else {
          lerp_row(rb[r], k, false, vb);
        }
        have_a = ra[r];
        have_b = rb[r];
      }
      float v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[j] = __fmaf_rn(lh0[r], va[j], __fmul_rn(lh1[r], vb[j]));
      am.update(r, v, k);
    }
  }

  const bool vec = (w & 3) == 0 && xl + kCols <= w;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = yl + r;
    if (y >= h) break;
    int32_t* dst = out + (n * h + y) * w + xl;
    if (vec) {
      *reinterpret_cast<int4*>(dst) = make_int4(am.get(r, 0), am.get(r, 1), am.get(r, 2),
                                                am.get(r, 3));
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (xl + j < w) dst[j] = am.get(r, j);
    }
  }
}

// PyTorch's area_pixel_compute_scale in float32, sizes given (no scale factor)
float area_scale(int in, int out, int align) {
  if (align) return out > 1 ? static_cast<float>(in - 1) / static_cast<float>(out - 1) : 0.0f;
  return static_cast<float>(in) / static_cast<float>(out);
}

// the most source indices a tile of `tile` output indices reads along an
// axis: the span of its first and last source index, plus the last's
// neighbour, plus one for float32 rounding of the coordinates
int window(float r, int tile, int in) {
  const int span = static_cast<int>(ceil(static_cast<double>(r) * (tile - 1))) + 3;
  return span < in ? span : in;
}

template <typename T, bool kTopRight>
int launch(int32_t* out, const void* logits, int n, int c, int h_in, int w_in, int h, int w,
           int align, cudaStream_t stream) {
  if (h > 65535 * kTileH) return static_cast<int>(cudaErrorInvalidValue);
  const float rh = area_scale(h_in, h, align), rw = area_scale(w_in, w, align);
  const int win_rows = window(rh, kTileH, h_in), win_cols = window(rw, kTileW, w_in);
  const int64_t smem = static_cast<int64_t>(win_rows) * win_cols * c * sizeof(float);
  const bool staged = smem <= kStageMax;
  void (*kernel)(int32_t*, const T*, int, int, int, int, int, float, float, int, int, int) =
      staged ? resize_bilinear_argmax_kernel<T, true, kTopRight>
             : resize_bilinear_argmax_kernel<T, false, kTopRight>;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const T* src = static_cast<const T*>(logits);
  for (int n0 = 0; n0 < n; n0 += 65535) {
    const int frames = n - n0 < 65535 ? n - n0 : 65535;
    kernel<<<dim3(grid.x, grid.y, frames), 32 * kWarps, staged ? smem : 0, stream>>>(
        out + static_cast<int64_t>(n0) * h * w, src + static_cast<int64_t>(n0) * h_in * w_in * c,
        c, h_in, w_in, h, w, rh, rw, align, win_rows, win_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int arseg_resize_bilinear_argmax(int32_t* out, const void* logits, int n, int c,
                                            int h_in, int w_in, int h, int w,
                                            int align_corners, int top_right, int dtype,
                                            void* stream) {
  // classes are held in 16 bits for bfloat16
  if (n < 0 || c <= 0 || c > 65535 || h_in <= 0 || w_in <= 0 || h <= 0 || w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int align = align_corners != 0;
  if (dtype == 0)
    return top_right ? launch<float, true>(out, logits, n, c, h_in, w_in, h, w, align, s)
                     : launch<float, false>(out, logits, n, c, h_in, w_in, h, w, align, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(out, logits, n, c, h_in, w_in, h, w, align, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
