// Plain C interface of the port's CUDA kernels.
//
// Each launcher checks its arguments, launches on `stream` and returns
// cudaGetLastError() as an int (0 on success). It allocates nothing and
// does not synchronise: the caller owns every buffer. `dtype` is 0 for
// float32 and 1 for bfloat16; all pointers are to contiguous NHWC data.
#pragma once

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

// out[n,y,x] = argmax_k(sum_c round(fused[n,y,x,c]) * fc_w[c,k] + fc_b[k]),
// fused as in arseg_creff_qkv_fused, rounded to the input type; lowest
// index on ties. fc_w: [c][n_classes] float32, fc_b: [n_classes] float32;
// out: [n, h, w] int32. 1 <= n_classes <= 19.
int arseg_creff_phase2_argmax(int32_t* out, const void* lr_up, const void* ref,
                              const float* taps, const float* bias,
                              const float* fc_w, const float* fc_b, int n, int h,
                              int w, int c, int n_classes, int kh, int kw,
                              int dtype, void* stream);

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

#ifdef __cplusplus
}
#endif
