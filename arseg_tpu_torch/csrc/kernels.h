// Plain C interface of the port's CUDA kernels.
//
// Each launcher checks its arguments, launches on `stream` and returns
// cudaGetLastError() as an int (0 on success). It allocates nothing and
// does not synchronise: the caller owns every buffer. `dtype` is 0 for
// float32 and 1 for bfloat16; all pointers are to contiguous NHWC data.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// out = lr_up + softmax(similar(dw3(lr_up; q), dw3(ref; k))) . dw3(ref; v)
// over a kh x kw window. lr_up, ref, out: [n, h, w, c].
// taps: [3][9][c] float32 (q, k, v; tap a*3+b of the 3x3 kernel).
// bias: [3][c] float32. c % 16 == 0; kh == kw in {3, 5, 7}.
int arseg_creff_qkv_fused(void* out, const void* lr_up, const void* ref,
                          const float* taps, const float* bias, int n, int h,
                          int w, int c, int kh, int kw, int dtype,
                          void* stream);

// The backward of arseg_creff_qkv_fused for an incoming gradient g of its
// output: d_lr = d lr_up and d_ref = d ref ([n, h, w, c] of the input
// type; d_ref may be null, and is then not computed), d_taps = the
// gradients of taps and bias as [3][10][c] float32 (q, k, v; taps 0-8,
// then the bias). workspace: arseg_creff_qkv_fused_backward_workspace(...)
// bytes, owned by the caller. Every input and the workspace are 16-byte
// aligned. No float atomics: the same inputs give the same bits.
// c % 16 == 0; kh == kw in {3, 5, 7}.
size_t arseg_creff_qkv_fused_backward_workspace(int n, int h, int w, int c,
                                                int k, int dtype);
int arseg_creff_qkv_fused_backward(void* d_lr, void* d_ref, float* d_taps,
                                   void* workspace, const void* lr_up,
                                   const void* ref, const void* g,
                                   const float* taps, const float* bias, int n,
                                   int h, int w, int c, int kh, int kw,
                                   int dtype, void* stream);

// out[n,y,x] = argmax_k(sum_c round(fused[n,y,x,c]) * fc_w[c,k] + fc_b[k]),
// fused as in arseg_creff_qkv_fused, rounded to the input type; lowest
// index on ties. fc_w: [c][n_classes] float32, fc_b: [n_classes] float32;
// out: [n, h, w] int32. 1 <= n_classes <= 19.
int arseg_creff_phase2_argmax(int32_t* out, const void* lr_up, const void* ref,
                              const float* taps, const float* bias,
                              const float* fc_w, const float* fc_b, int n, int h,
                              int w, int c, int n_classes, int kh, int kw,
                              int dtype, void* stream);

// arseg_creff_phase2_argmax with lr_up the bilinear align_corners=True
// resize of lr [n, h_in, w_in, c] to h x w (h_in <= h, w_in <= w,
// c <= 64), which the kernel builds in shared memory; ref: [n, h, w, c];
// out: [n, h, w] int32. bfloat16 (dtype 1) alone.
int arseg_creff_phase2_argmax_lr(int32_t* out, const void* lr, const void* ref,
                                 const float* taps, const float* bias,
                                 const float* fc_w, const float* fc_b, int n,
                                 int h_in, int w_in, int h, int w, int c,
                                 int n_classes, int kh, int kw, int dtype,
                                 void* stream);

// out = softmax(similar(q, k)) . v over a kh x kw window: logits summed in
// float32, p rounded to the input type, float32 window sum, one final
// rounding; window positions outside the image give logit 0 and value 0.
// q, k, v, out: [n, h, w, c]. c % 16 == 0; kh == kw in {3, 5, 7}.
int arseg_creff_attention(void* out, const void* q, const void* k,
                          const void* v, int n, int h, int w, int c, int kh,
                          int kw, int dtype, void* stream);

// out[n,Y,X] = argmax_k(up8(round(fused . fc_w))[n,Y,X,k] + fc_b[k]), fused
// as in arseg_creff_qkv_fused (float32, not rounded); up8 is the x8
// bilinear align_corners=False resize, columns first (rounded to the input
// type), then rows (float32). Lowest index on ties. fc_w: [c][n_classes]
// float32 holding values of the input type, fc_b: [n_classes] float32;
// out: [n, 8h, 8w] int32. 1 <= n_classes <= 19.
int arseg_creff_phase2_upsample_argmax(int32_t* out, const void* lr_up,
                                       const void* ref, const float* taps,
                                       const float* bias, const float* fc_w,
                                       const float* fc_b, int n, int h, int w,
                                       int c, int n_classes, int kh, int kw,
                                       int dtype, void* stream);

// out[b] = bilinear zero-padding sample of src[b / (n / ns)] at
// (x + fx, y + fy), grid_sample semantics. src: [ns, h, w, c] with n a
// multiple of ns and ns <= 65535; fx, fy: [n, h, w] float32; out:
// [n, h, w, c]. c % 8 == 0 and (h + 1) * (w + 1) * c < 2^31 (offsets inside
// one frame are int32).
int arseg_warp_bilinear(void* out, const void* src, const float* fx,
                        const float* fy, int n, int ns, int h, int w, int c,
                        int align_corners, int dtype, void* stream);

// dx = the gradient of F.interpolate(x, (hout, wout), mode "bilinear") with
// respect to x [n, c, hin, win], for an incoming gradient g of its output:
// dx[., i, j] = sum_oh Ah[oh, i] * sum_ow Aw[ow, j] * g[., oh, ow], float32
// sums rounded once to the input type; no atomics. The transposed tables
// of each axis (rows: th, wh, lh; columns: tw, ww, lw): per input index,
// the first output index that reads it and how many do ([in][2] int32), and
// their weights ([in][l] float32, 0 past the run). layout 0: g and dx
// NCHW-contiguous; layout 1: NHWC-contiguous (channels_last), c a multiple
// of 16 bytes of the type, g and dx 16-byte aligned. A block owns bh input
// rows; tile is the output rows staged at a time (layout 0) or the 16-byte
// vectors of channels a block takes (layout 1); rmax (layout 1) is the most
// output rows any band of bh input rows reads.
int arseg_resize_bilinear_backward(void* dx, const void* g, const int* th,
                                   const float* wh, int lh, const int* tw,
                                   const float* ww, int lw, int n, int c,
                                   int hin, int win, int hout, int wout,
                                   int bh, int rmax, int tile, int layout,
                                   int dtype, void* stream);

#ifdef __cplusplus
}
#endif
