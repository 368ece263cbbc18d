"""On-card smoke test of the PyTorch/CUDA port (arseg_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card must be present; prints nvidia-smi's name and
     power limit.
  2. build: builds the kernels of arseg_tpu_torch/csrc, prints the seconds.
  3. kernels: each kernel against its plain PyTorch version at the shapes
     each driven path gives it, in float32 and bfloat16, with the tolerance
     stated: K1 and K2 at camvid-bise18's and camvid-psp18 V2's, K2 and K3
     at camvid-psp18 V1's, K4 at the localNoGroup and local5 shapes, K5 at
     camvid-bise18's fused head, K1 and K2 at cityscapes-bise18's and
     cityscapes-psp18's (1024x2048 frames, fused at 128x256), K1 and K2 at
     the multi-GOP step's (8 GOPs: K1 over 88 frames, K2 from 8 sources to
     88 frames), camvid-psp18 V1's multi-GOP step (K3 over a chunk of 44
     frames, K2 from 8 sources to 88 frames at 720x960x64, an output past
     2^31 elements in one launch; their plain versions run a GOP's frames
     at a time, which is all the card's memory holds beside them),
     K3's LR form (the LR feature at 360x480, the x2 resize built in shared
     memory) at camvid-psp18 V1's and its chunk's, its maps equal to the
     resize and K3's and timed beside them (resize_k3_ms),
     streaming's (one frame), EvalAlterRes's (a batch of 2 frames, K2 with
     one source per frame) and the training step's (a
     batch of 16, K2 with one source per frame), K1B (K1's backward) at the
     training step's (hr takes no gradient) and psp18 V2's, and K1 at V1's
     C=64 shape for information
     (no path runs it there); kernel, plain and library times (CUDA events,
     median of 20 kernel runs, of 5 plain runs at the 720x960 shapes, each
     run over back-to-back calls filling about 1 ms); K2 must equal its
     plain version exactly, and is timed on block-constant 4x8 flows as
     well, for information. Then K2 on the flow cases of
     tests/test_pallas_warp*.py and at the edges of its tiling (sizes off
     its 32-pixel sets and 32- to 128-pixel blocks, a single row or column,
     n = 1, 11 frames from one source, one source per frame, flows of
     +-60) at C of 8, 64, 136, 256 and 512 (one, two or four warps a set),
     and a source past half the L2 in both block orders, exactly; K2 with
     S sources (3 for 33 frames at C 8, 64 and 136, and S = n) exactly,
     and the wrapper and the C launcher refusing 3 sources for 32 frames.
     Then K1, K3, K4 and K5 in bfloat16 (the tensor-core kernels) at edge
     shapes (sizes no multiple of the tile or of K5's 14-pixel interior, a
     single row or column, n = 1, C of 16, 64 and 512, windows 3, 5 and 7,
     12 and 19 classes), K3 and K5 with a tie of two classes and with
     every logit below zero, and K3's LR form at other ratios and ragged
     tiles (maps equal to the resize and K3's), printed with its seconds. The gather backward
     of bilinear resize (ops/resize_kernel.py) at the shapes of an FST
     stage-2 step at batch 16 (the heads' x8 and x16, the OHEM resize, K1's
     lr resize, the context and spatial paths'), in the layout of its
     incoming gradient there, against its plain version, beside PyTorch's
     own backward (aten upsample_bilinear2d_backward) as library_ms.
  4. camvid-bise18 AR 0.5x, GOP 12, 720x960, bf16, full width, random
     seeded weights: scan_step over 3 GOPs of uint8 frames, with the launch
     counts of every kernel read around that run; then one GOP on the CPU
     (plain versions, float32) against the card in float32.
  5. camvid-psp18 V1 AR, the same traffic: scan_step over 3 GOPs with its
     launch counts (K3's LR form and K2 once per GOP, K1 and full-size K3
     never); a short GOP
     (keyframe + 2 frames) on the CPU in float32 against the card in
     float32; camvid-psp18 V2: one GOP on the card with its launch counts
     (K1 and K2 once), and a short GOP on the CPU against the card, both in
     float32.
  6. camvid-bise18 with other CReFF fusions, the same traffic: the
     localNoGroup fusion (K4) by scan_step over 3 GOPs with its launch
     counts, one GOP of local5 (K4 on four sub-grids), and one localNoGroup
     GOP on the CPU against the card in float32; then the fused upsample
     head (K5, the USE_FUSED_UPSAMPLE_HEAD setting that is not the default)
     by scan_step over 3 GOPs with its launch counts, and one GOP on the
     CPU against the card in float32.
  7. cityscapes-bise18 and cityscapes-psp18 AR 0.5x, GOP 12, 1024x2048,
     bf16: scan_step over 3 GOPs with its launch counts (K1 and K2 once per
     GOP; bise18 the planes head, psp18 forward_phase2 -> resize ->
     argmax), then a short GOP (keyframe + 2 frames) at 512x1024 on the CPU
     in float32 against the card in float32.
  8. multi-GOP: camvid-bise18, 8 GOPs in one gop_step call (720x960), its
     launch counts (K1 and K2 once), its maps against scan_step over the
     same GOPs in bf16 and in float32, and the ms per frame of both; then
     camvid-psp18 V1 the same way, whose 88 frames at 720x960x64 pass 2^31
     elements, so K3's LR form runs in two chunks of 44 (twice, K2 once);
     then cityscapes-psp18, 8 GOPs at 1024x2048, whose 88 frames' 19-class
     logits at full size pass 2^31 elements, so the resize-and-argmax head
     runs in two chunks of 44 (two gop.head_chunk spans, K1 and K2 once):
     its maps against scan_step in float32, and in bf16 no further from the
     float32 maps than scan_step's; ms per frame and peak memory.
  9. streaming: camvid-bise18, one GOP as key_step + 11 frame_step calls
     against gop_step (float32), and the median ms per frame_step in bf16
     with its launch counts.
 10. eval: EvalConstRes (0.5x) and EvalAlterRes for camvid-bise18 at
     720x960, 4 batches of 2 frames, bf16: each histogram counts every
     scored pixel exactly; EvalAlterRes's launch counts; then both engines
     at 256x320 in float32 on the card against the CPU: class maps agree
     >= 0.999, mIoU within 1e-3, no histogram cell apart by more than 0.1%
     of the scored pixels.
 11. training: camvid-bise18 FST phase 2 on the trainers' objective, the
     camvid policy's 720x960 crop, LR 0.5x, the teacher the fused class in
     eval mode, the student's final conv copied from it and frozen: 2
     stage-1 then 4 stage-2 Adam steps in bf16 at batch 16 on one repeated
     batch (K1, K1B and K2 never in stage 1, once per stage-2 step; the
     gather backward of bilinear resize 9 times a stage-1 step and 8 times
     a stage-2 step, once for each resize that takes a gradient; each
     loss finite, the 4th stage-2 loss below the 1st; float32 master
     parameters, optimizer state and BN statistics; the frozen conv equal
     to the teacher's; the median ms per step of each stage after its
     first, the peak device memory, and K1's backward (K1B) at the step's
     shape beside its bound and autograd over the composed module); one
     SGD step of each stage at 128x160, batch 2, in float32 on the card
     against the CPU (the loss within 1e-4, each
     gradient within the larger of 1e-3 and 4 x its float32 error against
     the CPU in float64, the BN running statistics within 1e-4);
     TrainLoop.run_epoch over 3 in-memory batches with its launch counts
     (the resize backward 8 times a batch),
     then EvalAlterRes validation whose histogram counts every scored
     pixel; a checkpoint saved and loaded into a fresh model and
     optimizer, every tensor bit-equal.
 12. data parallel (arseg_tpu_torch.parallel over torch.distributed): (a)
     an nccl group of one rank through every data-parallel entry point,
     each equal to its one-process path (a float32 sync and master stage-2
     step at 128x160, batch 8: loss and BN statistics bit-equal, each
     gradient within the larger of 1e-5 relative L2 and 4 x the
     one-process step's own difference between two calls, since float32
     atomic adds in the backward run in another order each call; the
     group built from the device None, "cuda" and "cuda:0" alike on
     cuda:0; TrainLoop with the group over 2 such batches, its mean loss
     within 1e-6 relative of the one-process loop's, K1 and K2 once a
     batch; sharded_step on 2 streams against multi_gop_step,
     gop_parallel_step against gop_step and both eval engines, bf16 at
     720x960: maps and histograms bit-equal); (b) two
     gloo ranks spawned on the same card (NCCL refuses two ranks on one
     device), each building its group from the device "cuda", the kernels
     built before the spawn: the sync-BN stage-2 step
     of camvid-bise18 at 720x960, global batch 16 (8 a rank), bf16, 5 Adam
     steps (K1 and K2 once a step on each rank; the ranks' losses equal,
     finite, the last below the first); a float32 sync step at 128x160,
     global batch 8, against the one-rank step on the card (loss and BN
     statistics within 1e-4 relative, each gradient within the larger of
     1e-3 and 4 x its float32 error against the CPU in float64); the master
     step (every rank left with rank 0's running statistics, which are the
     one-rank step's on rank 0's rows, within 1e-4); sharded_step on 2
     streams (1 GOP each, 720x960) against two gop_step calls and
     gop_parallel_step (11 frames padded to 12) against gop_step, maps
     agreeing >= 0.9999 in float32 and >= 0.999 in bf16; EvalAlterRes
     (float32, 4 batches of 2 frames) with a histogram equal to one rank's
     over the same frames a frame a call (the shape each rank runs); the
     2-rank and 1-rank step times (two ranks sharing one card measure no
     scaling). Any rank's failure fails the run.
 13. the command line (arseg_tpu_torch/cli) on a synthetic CamVid tree
     (tests/synthetic_data.py) at 720x960, GOP 2, 4 samples a split,
     camvid-bise18: (a) `torchrun --nproc_per_node 1 -m
     arseg_tpu_torch.cli.train` (phase 1, HR, 1 epoch, bf16, a one-rank
     nccl group) as a subprocess, then its --resume for epoch 2 in this
     process ("resuming from", epoch 2 alone); (b) cli.train_pair stage 2
     with (a)'s checkpoint as the teacher on the device "cuda" (K1 and K2
     once a step and once a validation batch); (c) two gloo ranks spawned
     on the card, each with its group initialised, run cli.train_pair
     --num_devices 2 --bn_mode sync for one epoch (K1 and K2 once a step
     and a validation batch on each rank; rank 0 alone logs and writes the
     checkpoint); (d) cli.evaluation --mode 1 1 1 over (a)'s and (b)'s
     checkpoints in float32 and bfloat16 under a one-rank nccl group
     (--num_devices 1; K1 and K2 once per AR frame), the float32 files
     within 1e-6 of the same command on the CPU; (e) cli.convert --to_torch
     and back, bit-equal. Each leg's seconds.
 14. the other PSPNet backbones the trainers accept: one GOP (GOP 12, LR
     0.5x, bf16, full width) of camvid PSPNet V1 on ResNet-50/101/152,
     DenseNet-121 and SqueezeNet at 720x960 (K3 and K2 once) and of the
     cityscapes PSPNetSemseg on ResNet-50 at 1024x2048 (K1 and K2 once),
     seeded random weights made trained-like (BN statistics from the short
     GOP's frames, residual branches damped), the median ms/GOP of 3; a
     short GOP (keyframe + 2 frames, 240x320 or 256x512) on the card in
     float32 against the CPU (maps agree >= 0.999, fused features within
     1e-3 of their largest on >= 0.999 of their elements).
 15. video inference through arseg_tpu_torch.cli.infer_video (720x960, GOP
     12, 0.5x, bf16, seeded random weights saved as the port's .pth): (a)
     file-fed over a synthetic decoded sequence of 3 GOPs (PNG frames
     panning 2 px a frame, int16 merged-MV bins), camvid-bise18 and the
     default camvid-psp18 V1: the PNGs bit-equal to gop_step over the same
     GOPs in this process, K1 (or K3) and K2 once a GOP; --prefetch 0 and 2
     bit-equal over 8 GOPs, with StepTimer's p50/p95 ms per GOP and
     frames/s of each, beside gop_step alone (wall ms/GOP, and its device
     kernels' ms/GOP from torch.profiler); --gop_batch 2 (a stack and the
     tail) against --gop_batch 1, maps >= 0.999 in bf16 and bit-equal in
     float32; --colorize PNGs equal index_to_rgb of the maps; --stats_json
     holds every StepTimer key; (b) --video with --mv_carrier and with
     --mv_analysis, bit-equal to the file-fed command over the same
     streams' decoded frames and merged MVs, when the native decoder
     (native/, FFmpeg) builds, else a line "video leg: not run: <why>";
     (c) two gloo ranks on the card: --streams over 2 file-fed streams with
     --num_devices 2 (each stream bit-equal to it served alone) and
     --gop_devices 2 (maps >= 0.999 of the one-card run's); (d)
     EvalAlterRes's histogram with prefetch 2 equal to prefetch 0.
 16. labelled synthetic scenes and the data variants: (a)
     tools.synth_scenes.generate writes the test split (4 chapters) at
     720x960, GOP 12, seed 0, with its seconds and bytes; (b) K2
     (ops/warp.warp_feature) warps one chapter's keyframe by the
     ground-truth merged MVs at every distance d = 1..11 at full
     resolution, the RGB frame in float32 padded with zero channels to 8
     (K2 takes C % 8 == 0): exactly equal to the plain warp on the CPU, and
     its PSNR against the annotated frame above the unwarped keyframe's by
     more than 3 dB at every d (the bar of the JAX package's mv_fidelity
     tests, which the CPU run of the same check meets), the gains printed;
     (c) the mIoU_d protocol over the ground-truth MVs: camvid-bise18,
     seeded weights, bf16, nanmean, EvalConstRes at 1.0x and 0.5x for d =
     0..11 and EvalAlterRes over CamVidWithFlow on the clean test split
     (keyframes from the source sequence, ref_gap d + 1) for d = 1..11
     (d = 0 is the HR model, as in the protocol), through
     Loader(pin_memory=True) with prefetch 2: K1 and K2 once per
     EvalAlterRes batch, every histogram counting every scored pixel, the
     result files in the protocol's format; EvalAlterRes's ms per batch at
     d = 11 in the steady state (the test split read over to 16 batches,
     the batches after the loader's first round timed), fed by the loader
     and from the same batches read beforehand into pinned memory (order
     read, loader, loader, read); then d = 11 in float32 on the card
     against the CPU (maps agree >= 0.999, mIoU within 1e-3); (d)
     CamVidWithBiFlow, CamVidwithCUmap and CamVidwithCUmapSingleBranch in
     train mode on the data variants' tree at 720x960 (its 3 samples read
     over to 64 reads in one epoch) through Loader(pin_memory=True, 8
     workers) and device_prefetch: the staged batches bit-equal to the
     loader's host batches, the samples/s of each over the batches after
     the workers' first round; (e) `cli.preprocess camvid` on one synthetic
     chapter at 128x160 and `tools.mv_fidelity --synthetic`, when the
     native library (native/, FFmpeg) builds, else a line
     "preprocess/mv_fidelity: not run: <why>".
 17. a JSON line of the kernels, and the last line {"ok": true, ...}.
Every phase prints its seconds.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

GOP, H, W, SCALE, CLIP_GOPS = 12, 720, 960, 0.5, 3
FEAT_HW = (H // 8, W // 8)
C = 256       # camvid-bise18 fusion channels, at FEAT_HW
C_PSP = 64    # camvid-psp18 V1 fusion channels, at (H, W)
C_PSP_V2 = 512  # camvid-psp18 V2 fusion channels (the backbone feature), at FEAT_HW
N_CLASSES = 12
CAMVID_MEAN = (0.39068785, 0.40521392, 0.41434407)
CAMVID_STD = (0.29652068, 0.30514979, 0.30080369)
# cityscapes-bise18 and -psp18: 1024x2048 frames, both fuse at 1/8; the
# short GOP against the CPU runs at half that size
CITY_HW, CITY_SHORT_HW, N_CLASSES_CITY = (1024, 2048), (512, 1024), 19
CITY_FEAT_HW = (CITY_HW[0] // 8, CITY_HW[1] // 8)
C_CITY_PSP = 512  # cityscapes-psp18 fusion channels (the cls feature), at CITY_FEAT_HW
# the reference's Cityscapes normalisation of each model family
CITY_NORM = {"cityscapes-bise18": ((0.3257, 0.3690, 0.3223), (0.2112, 0.2148, 0.2115)),
             "cityscapes-psp18": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))}
MULTI_GOPS = 8  # the multi-GOP batch of bench.py's throughput row
# multi-GOP maps against scan_step over the same GOPs: cuDNN picks other
# algorithms at another batch, so sums run in another order
MULTI_AGREEMENT = {torch.bfloat16: 0.999, torch.float32: 0.9999}
# cityscapes-psp18's bf16 8-GOP maps against scan_step's, each compared with
# the float32 step's maps: bf16 rounding at this model's near ties moves ~1%
# of the pixels either way; a wrong chunk or frame moves far more
SEMSEG_BF16_SLACK = 0.005
STREAM_AGREEMENT = 0.9999  # streaming against gop_step, float32
STREAM_REPEATS = 3  # GOPs served a frame a call for the frame_step timing
EVAL_BATCHES, EVAL_BATCH, EVAL_SMALL_HW, IGNORE = 4, 2, (256, 320), 255
# eval on the card (float32) against the CPU: the class maps' agreement
# (AGREEMENT), mIoU, and each histogram cell as a share of the scored pixels
MIOU_TOL, HIST_CELL_TOL = 1e-3, 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no tensor cores for f32
# max |kernel - plain| allowed, relative to max(1, max |plain|): float32 sums
# run in another order; bfloat16 outputs are rounded once, so two units in
# the last place of the largest output
TOL = {
    "creff_qkv_fused": {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -6},
    "warp_bilinear": {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7},
    "creff_attention": {torch.float32: 5e-5, torch.bfloat16: 2.0 ** -6},
    # each gradient (d lr_up, d ref, each conv's taps and bias) against its
    # largest value: float32 sums in another order; bf16: Q, K, V the same
    # bits, P rounded to bf16 after float32 logits summed in another order
    # (a unit of 2^-8 at a few positions), d lr_up and d ref rounded once
    "creff_qkv_fused_backward": {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6},
}
# kernel against plain version, relative to max |plain| (as the card tests
# of tests/test_torch_resize_backward.py): float32 sums of the same products
# in another order; bfloat16 both round float32 sums once, so an element
# may differ by one unit in its last place (2^-7 of it)
TOL["resize_bilinear_backward"] = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# kernels that repeat their plain version's arithmetic step by step: besides
# the tolerance, max |kernel - plain| must be 0
EXACT = ("warp_bilinear",)
# K3 and K5 write class maps: the share of pixels equal to the plain
# version's, and where they differ the plain version's logits (for K5 the
# upsampled ones) of its class and of the kernel's must be a near tie,
# within this share of max |logit| (float32: sums in another order;
# bfloat16: Q, K, V, p and the fused feature, or K5's logits and column
# interpolation, rounded after such sums)
K3_AGREEMENT = {torch.float32: 0.9999, torch.bfloat16: 0.999}
K3_TIE = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
# one GOP, the card in float32 against the CPU in float32: class maps flip
# only at near ties; the fused feature differs by the order of the sums
# through two BiSeNet forwards (observed ~3e-6 at max |fused| ~1.7)
AGREEMENT = 0.999
FUSED_TOL = 1e-3  # relative to max(1, max |fused|)
TIMED_RUNS = 20
BATCH_MS = 1.0  # a timing spans back-to-back calls of about this length
PLAIN_RUNS_PSP = 5
WARP_BLOCK = (4, 8)  # one motion vector per 4x8 block (the HEVC motion-field shape)
WARP_EDGE_C = (8, 64, 136, 256, 512)
# training: camvid-bise18 FST phase 2
TRAIN_BATCH, TRAIN_HW = 16, (H, W)  # the camvid policy's crop, the reference's batch
TRAIN_STEPS = (2, 4)  # stage-1 and stage-2 steps on one repeated batch
TRAIN_LR = 1e-3  # the trainers' start_lr
# the resizes one FST step of camvid-bise18 at 720x960 takes a gradient
# through (tests/test_torch_resize_backward.py STEP_RESIZES): 9 in stage 1
# (the student in normal mode, its feature resized to the teacher's), 8 in
# stage 2; each is one launch of the gather backward
RESIZE_LAUNCHES = {1: 9, 2: 8}
# (shape key, input [N, C, H, W], output size, align_corners, channels_last):
# the resizes of a stage-2 step at batch 16, in the layout their incoming
# gradient has there (the OHEM resize runs twice, at the same shape)
RESIZE_CASES = [
    ("training stage 2 main head x8", (TRAIN_BATCH, N_CLASSES, 90, 120), (H, W), False, False),
    ("training stage 2 conv_out16 x8", (TRAIN_BATCH, N_CLASSES, 46, 60), (368, 480), False,
     False),
    ("training stage 2 OHEM", (TRAIN_BATCH, N_CLASSES, 368, 480), (H, W), True, False),
    ("training stage 2 conv_out32 x16", (TRAIN_BATCH, N_CLASSES, 23, 30), (368, 480), False,
     False),
    ("training stage 2 K1 lr", (TRAIN_BATCH, C, 46, 60), FEAT_HW, True, True),
    ("training stage 2 context path", (TRAIN_BATCH, 128, 24, 30), (23, 30), True, True),
    ("training stage 2 spatial path", (TRAIN_BATCH, 128, 45, 60), (46, 60), True, True),
]
PARITY_HW, PARITY_BATCH = (128, 160), 2
# one step on the card (float32) against the CPU: the loss's relative
# difference, the BN running statistics after an SGD step (relative to
# max(1, max |stat|)), and each gradient's relative L2 difference. A
# train-mode gradient carries a float32 rounding error of its own (BN's
# backward subtracts the gradient's mean and its projection on the
# normalised input, which cancels most of it): the CPU's float32 gradients
# differ from its float64 ones by ~1e-3 relative L2 at batch 2. So a
# gradient's bound is the larger of TRAIN_GRAD_TOL and GRAD_ERR_FACTOR x
# that measured error of the same tensor.
TRAIN_LOSS_TOL, TRAIN_BN_TOL, TRAIN_GRAD_TOL, GRAD_ERR_FACTOR = 1e-4, 1e-4, 1e-3, 4.0
TRAIN_EPOCH_BATCHES, TRAIN_EPOCH_BATCH, TRAIN_VAL_BATCHES = 3, 4, 2
# data parallel: two gloo ranks on the one card. DP_STEPS fresh Adam steps
# of the bf16 sync-BN step must lower the loss: from these models on this
# batch the loss of the float32 step itself rises through step 3 (8.5250,
# 8.5289, 8.5452) and falls from step 4 (8.3052, 8.0752), so 3 steps passed
# or failed on bf16 rounding alone
DP_WORLD, DP_STEPS, DP_PARITY_BATCH, DP_STREAMS, DP_LOOP_BATCHES = 2, 5, 8, 2, 2
DP_TIMEOUT = 480  # seconds the spawned ranks may take together
# one-rank group against the one-process step, which is the same code: the
# backward's float32 atomic adds (bilinear upsampling's, cuDNN's) run in
# another order from call to call, so each gradient may differ by the
# larger of this and DP_SPREAD_FACTOR x the one-process step's own
# difference between two calls
DP_SAME_GRAD_TOL, DP_SPREAD_FACTOR = 1e-5, 4.0
# the one-rank TrainLoop's mean loss against the one-process loop's: after
# the first step the weights differ by those atomic adds' last bits
DP_LOOP_LOSS_TOL = 1e-6
REPO = Path(__file__).resolve().parent
# the command line: a synthetic CamVid tree (tests/synthetic_data.py) at the
# dataset's 720x960, GOP 2 (few PNGs), CLI_SAMPLES samples in each split,
# CLI_BATCH crops a rank; camvid-bise18
CLI_GOP, CLI_SAMPLES, CLI_BATCH, CLI_WORLD = 2, 4, 2, 2
CLI_TIMEOUT = 300  # seconds the torchrun leg, and the spawned ranks together, may take
PROTOCOL_TOL = 1e-6  # each number of a result file (tests/test_torch_protocol.py's atol)
# one GOP of serving on each PSPNet backbone the trainers accept beyond
# ResNet-18 (full width, 720x960 or 1024x2048), then a short GOP at these
# sizes on the card in float32 against the CPU
BACKBONE_CASES = (("camvid", "resnet50"), ("camvid", "resnet101"), ("camvid", "resnet152"),
                  ("camvid", "densenet"), ("camvid", "squeezenet"), ("cityscapes", "resnet50"))
BACKBONE_SHORT_HW = {"camvid": (240, 320), "cityscapes": (256, 512)}
BACKBONE_RUNS = 3  # timed GOPs after the warm-up; their median is printed
RESIDUAL_GAMMA = 0.3  # a random residual branch's last BN scale (random_trained_like_)
# video inference: a synthetic decoded sequence of VIDEO_GOPS GOPs at 720x960
# panning VIDEO_PAN px a frame; the timing runs read VIDEO_TIMING_GOPS GOPs of
# it through symlinks (GOP k is GOP k mod VIDEO_GOPS), so that StepTimer
# times several steps after its first
VIDEO_GOPS, VIDEO_PAN, VIDEO_TIMING_GOPS = 3, 2, 8
# the prefixes of the port's record_function spans, left out of device time
PORT_SPANS = ("gop.", "feeder.", "loader.", "train.")
EVAL_TIMING_BATCHES = 8  # pinned 720x960 batches for the eval engines' prefetch timing
# labelled synthetic scenes (arseg_tpu_torch/tools/synth_scenes.py): the test
# split's SYNTH_CHAPTERS chapters at 720x960, GOP 12, seed SYNTH_SEED (its
# default test split is 24 chapters, each writing 11 ground-truth bins of
# 2.76 MB and 24 frames), read by the eval protocol's readers in batches of
# SYNTH_BATCH; EvalAlterRes is timed over the split read over to
# SYNTH_TIMING_READS samples, so that both loader workers have several batches
SYNTH_CHAPTERS, SYNTH_SEED, SYNTH_BATCH, SYNTH_TIMING_READS = 4, 0, 2, 32
# dB by which the keyframe warped by the ground-truth MVs beats the keyframe
# unwarped, both against the annotated frame, at every distance: the bar of
# the JAX package's tests of tools/mv_fidelity, which the same check on the
# CPU meets on this chapter (tests/test_torch_preprocess.py)
PSNR_MARGIN = 3.0
K2_IMAGE_C = 8  # K2 takes C % 8 == 0: an RGB image in channels 0-2, zeros in 3-7
# the data variants' tree (tests/variant_tree.py on tests/synthetic_data.py,
# GOP VARIANT_GOP, 3 samples) at 720x960, read over to VARIANT_READS samples
# in one epoch (4 batches for each of the camvid training policy's 8
# workers) in that policy's augmentation
VARIANT_GOP, VARIANT_READS, VARIANT_BATCH = 2, 64, 2
# part (e)'s chapter: the tools' contract, not the card, so at the CPU
# tests' size
NATIVE_H, NATIVE_W = 128, 160


def phase(name):
    print(f"== {name}", flush=True)


def _events_ms(fn, calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def median_ms(fn, runs=TIMED_RUNS, warmup=3):
    """Median of `runs` timings of one call of fn, in ms, on CUDA events. Each
    timing spans as many back-to-back calls as fill about BATCH_MS, so that
    the host's time to reach the first launch does not count much for a
    short kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    calls = max(1, min(100, int(BATCH_MS / _events_ms(fn, 1))))
    return float(np.median([_events_ms(fn, calls) for _ in range(runs)]))


def device_phase():
    phase("device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return smi


def build_phase():
    from arseg_tpu_torch.ops import _build

    phase("build")
    t0 = time.perf_counter()
    _build.library()
    how = "compiled with nvcc" if _build.BUILD_INFO["compiled"] else "loaded, already built"
    print(f"kernels {how} in {time.perf_counter() - t0:.1f} s", flush=True)


def check(name, dtype, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = TOL[name][dtype] * scale
    ok = err <= tol and bool(torch.isfinite(got.float()).all()) and (name not in EXACT or err == 0)
    exact = " (exact)" if name in EXACT else ""
    print(f"{name} {str(dtype):14s} max|d|={err:.3e} tol={tol:.3e}{exact} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version in {dtype}")
    return err


def _bound(s, dt):
    t_bytes = s["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = s["flops"] / PEAK_FLOPS[dt] * 1e3
    s["bound_ms"] = max(t_bytes, t_ops)
    s["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"


def _qkv_params(gen, c):
    from arseg_tpu_torch.ops import creff_kernel

    convs = [t for _ in range(3) for t in (
        torch.randn(c, 1, 3, 3, device="cuda", generator=gen) / 3.0,
        torch.randn(c, device="cuda", generator=gen) * 0.1)]
    return creff_kernel.pack_qkv(*convs)


def k1_case(gen, dt, n, hw, c, plain_runs):
    """K1 at [n, *hw, c] against its plain version."""
    from arseg_tpu_torch.ops import creff_kernel

    lr_up = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    ref = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, c)
    k1 = lambda: creff_kernel.creff_qkv_fused(lr_up, ref, taps, bias, 7, 7)
    p1 = lambda: creff_kernel.creff_qkv_fused_plain(lr_up, ref, taps, bias, 7, 7)
    err = check("creff_qkv_fused", dt, k1(), p1())
    # per element: three 3x3 depthwise convs (54), 49-tap logits (98) and
    # weighting (98), the residual (1)
    return dict(max_abs_err=err, ms=median_ms(k1), plain_ms=median_ms(p1, runs=plain_runs),
                library_ms=None,
                bytes=3 * lr_up.numel() * lr_up.element_size() + (taps.numel() + bias.numel()) * 4,
                flops=lr_up.numel() * 251)


# K1B's operations an element: window products 5 x 49 multiply-adds (s,
# dP, dq, dk, dv), q, k, v recomputed (3 x 18), the taps' and biases'
# gradients (3 x 18), dq's transposed conv (18); dk's and dv's (36) with d ref
K1B_FLOPS, K1B_REF_FLOPS = 616, 36


def k1b_case(gen, dt, n, hw, c, plain_runs, need_ref):
    """K1B at [n, *hw, c] against its plain version, d ref only with
    need_ref. Its bound: lr_up, ref and g read, d lr_up (and d ref)
    written, once each."""
    from arseg_tpu_torch.ops import creff_backward_kernel as k1b

    lr_up, ref, g = (torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
                     for _ in range(3))
    taps, bias = _qkv_params(gen, c)
    run = lambda: k1b.creff_qkv_fused_backward(lr_up, ref, g, taps, bias, 7, 7, need_ref)
    plain = lambda: k1b.creff_qkv_fused_backward_plain(lr_up, ref, g, taps, bias, 7, 7,
                                                       need_ref)
    got, want = run(), plain()
    pairs = [(got[0], want[0])] + ([(got[1], want[1])] if need_ref else [])
    err = max(check("creff_qkv_fused_backward", dt, a, b)
              for a, b in pairs + [(got[2][i], want[2][i]) for i in range(3)])
    return dict(max_abs_err=err, ms=median_ms(run), plain_ms=median_ms(plain, runs=plain_runs),
                library_ms=None, bytes=(4 + need_ref) * lr_up.numel() * lr_up.element_size(),
                flops=lr_up.numel() * (K1B_FLOPS + K1B_REF_FLOPS * need_ref))


def resize_case(gen, dt, shape, size, align, channels_last):
    """The gather backward of bilinear resize for an input [N, C, H, W] and
    an incoming gradient at `size`, against its plain version, beside
    PyTorch's own backward (the aten op autograd runs: atomic adds in the
    input type) as the library. Its bound: the gradient read and the
    input's gradient written, once each."""
    from arseg_tpu_torch.ops import resize_kernel

    fmt = torch.channels_last if channels_last else torch.contiguous_format
    g = torch.randn(shape[:2] + size, device="cuda", generator=gen).to(dt)
    g = g.contiguous(memory_format=fmt)
    run = lambda: resize_kernel.resize_bilinear_backward(g, shape[2:], align)
    plain = lambda: resize_kernel.resize_bilinear_backward_plain(g, shape[2:], align)
    lib = lambda: torch.ops.aten.upsample_bilinear2d_backward(g, list(size), list(shape), align,
                                                              None, None)
    err = check("resize_bilinear_backward", dt, run(), plain())
    return dict(max_abs_err=err, ms=median_ms(run), plain_ms=median_ms(plain, runs=PLAIN_RUNS_PSP),
                library_ms=median_ms(lib, runs=5),
                bytes=(g.numel() + math.prod(shape)) * g.element_size(),
                flops=4 * g.numel())  # two multiply-adds an element of g, along W


def resize_backward_phase():
    """The gather backward of bilinear resize at a stage-2 step's shapes,
    in float32 and bfloat16: {(name, shape key, dtype): stats}."""
    phase("the gather backward of bilinear resize at the FST step's shapes")
    gen = torch.Generator(device="cuda").manual_seed(4)
    stats = {}
    for dt in (torch.float32, torch.bfloat16):
        for key, shape, size, align, nhwc in RESIZE_CASES:
            print(f"-- resize_bilinear_backward at the {key} shape {list(shape)} -> {list(size)} "
                  f"align_corners={align} {'channels_last' if nhwc else 'NCHW'}, {dt}", flush=True)
            stats[("resize_bilinear_backward", key, dt)] = dict(
                resize_case(gen, dt, shape, size, align, nhwc), dims=[*shape, *size])
            torch.cuda.empty_cache()
    return stats


def _by_frames(fn, n, per=GOP - 1):
    """torch.cat of fn(lo, hi) over consecutive ranges of at most `per` of
    n frames: a plain version at a multi-GOP shape run a GOP's frames at a
    time, since over all n frames it would not fit in the card's memory."""
    return torch.cat([fn(lo, min(lo + per, n)) for lo in range(0, n, per)])


def k2_case(gen, dt, n, hw, c, plain_runs, flow_hw=(H, W), sources=1):
    """K2: `sources` keyframe features [S, *hw, c] warped to n frames, frame
    i reading source i // (n / S) (the dims printed are the output's,
    [n, *hw, c]); flows drawn uniform(-16, 16) at flow_hw and resized to
    hw."""
    from arseg_tpu_torch.gop.pipeline import _resize_flow_planes
    from arseg_tpu_torch.ops import warp_kernel

    src = torch.randn(sources, *hw, c, device="cuda", generator=gen).to(dt)
    fxf = torch.rand(n, *flow_hw, device="cuda", generator=gen) * 32 - 16
    fyf = torch.rand(n, *flow_hw, device="cuda", generator=gen) * 32 - 16
    fx, fy = _resize_flow_planes((fxf, fyf), hw)
    k2 = lambda: warp_kernel.warp_bilinear(src, fx, fy)
    p2 = lambda: warp_kernel.warp_bilinear_plain(src, fx, fy)
    err = check("warp_bilinear", dt, k2(), p2())
    far = check("warp_bilinear", dt, warp_kernel.warp_bilinear(src, fx * 40, fy * 40),
                warp_kernel.warp_bilinear_plain(src, fx * 40, fy * 40))
    print(f"warp_bilinear far out-of-image flows (x40) checked, max|d|={far:.3e}", flush=True)
    # library yardstick: F.grid_sample on the same sampling grid (NCHW), the
    # sources repeated into one image per frame before the timing
    # (grid_sample takes no source index; on the H100 it ran 3-3.6x faster
    # on such a copy than on a stride-0 view of one source, in
    # tools_torch_k2_ab.py)
    xs = torch.arange(hw[1], device="cuda", dtype=torch.float32)
    ys = torch.arange(hw[0], device="cuda", dtype=torch.float32)[:, None]
    grid = torch.stack([2.0 * (xs + fx) / (hw[1] - 1) - 1.0,
                        2.0 * (ys + fy) / (hw[0] - 1) - 1.0], dim=-1).to(dt)
    src_nchw = src.permute(0, 3, 1, 2).repeat_interleave(n // sources, dim=0)
    lib2 = lambda: F.grid_sample(src_nchw, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)
    gs = (lib2().permute(0, 2, 3, 1).float() - k2().float()).abs().max().item()
    print(f"warp_bilinear vs F.grid_sample {dt}: max|d|={gs:.3e} (information)", flush=True)
    # block-constant flows (one motion vector per 4x8 block at 720x960, the
    # HEVC motion-field shape), resized as the pipeline resizes them
    bfx, bfy = (torch.from_numpy(f).cuda()
                for f in _block_flow(np.random.RandomState(0), n, *flow_hw, -16, 16))
    bfx, bfy = _resize_flow_planes((bfx, bfy), hw)
    kb = lambda: warp_kernel.warp_bilinear(src, bfx, bfy)
    check("warp_bilinear", dt, kb(), warp_kernel.warp_bilinear_plain(src, bfx, bfy))
    ms = median_ms(k2)
    print(f"warp_bilinear {dt} ms: per-pixel random flows {ms:.4f}, block-constant 4x8 flows "
          f"{median_ms(kb):.4f} (information)", flush=True)
    out_numel = n * hw[0] * hw[1] * c
    return dict(max_abs_err=err, ms=ms, plain_ms=median_ms(p2, runs=plain_runs),
                library_ms=median_ms(lib2),
                bytes=src.numel() * src.element_size() + 2 * fx.numel() * 4
                + out_numel * src.element_size(),
                flops=out_numel * 7)


def k2_sources_case(gen, dt, n, hw, c, plain_runs, sources):
    """K2 from `sources` keyframe features [S, *hw, c] to n frames in one
    launch whose output may pass 2^31 elements (camvid-psp18 V1's multi-GOP
    step: 8 sources to 88 frames at [720, 960, 64]), with flows drawn
    uniform(-16, 16) at hw. Held exactly against its plain version and timed
    beside it a source's frames at a time: neither the plain version over
    all n frames nor F.grid_sample on a copy of a source per frame fits in
    the card's memory beside the kernel's output, so there is no library
    time."""
    from arseg_tpu_torch.ops import warp_kernel

    src = torch.randn(sources, *hw, c, device="cuda", generator=gen).to(dt)
    fx = torch.rand(n, *hw, device="cuda", generator=gen) * 32 - 16
    fy = torch.rand(n, *hw, device="cuda", generator=gen) * 32 - 16
    per = n // sources
    k2 = lambda: warp_kernel.warp_bilinear(src, fx, fy)

    def plain(fx, fy):
        return [warp_kernel.warp_bilinear_plain(src[s:s + 1], fx[s * per:(s + 1) * per],
                                                fy[s * per:(s + 1) * per])
                for s in range(sources)]

    errs = []
    for scale in (1, 40):  # flows and far out-of-image flows (x40)
        out = warp_kernel.warp_bilinear(src, fx * scale, fy * scale)
        errs += [check("warp_bilinear", dt, out[s * per:(s + 1) * per], want)
                 for s, want in enumerate(plain(fx * scale, fy * scale))]
        del out
    out_numel = n * hw[0] * hw[1] * c
    return dict(max_abs_err=max(errs), ms=median_ms(k2),
                plain_ms=median_ms(lambda: plain(fx, fy), runs=plain_runs), library_ms=None,
                bytes=src.numel() * src.element_size() + 2 * fx.numel() * 4
                + out_numel * src.element_size(),
                flops=out_numel * 7)


def check_maps(name, dt, got, logits, shape):
    """A kernel's class map `got` against the argmax of the plain version's
    float32 `logits` [..., K]: shape, range, agreement, and near ties
    wherever they differ. Returns (agreement, pixels that differ, largest
    plain-logit gap between the two classes there)."""
    n_classes = logits.shape[-1]
    want = logits.argmax(dim=-1).to(torch.int32)
    in_range = int(got.min()) >= 0 and int(got.max()) < n_classes
    differ = got != want
    agree = 1.0 - differ.float().mean().item()
    # where the maps differ: the plain logit of the plain version's class
    # less that of the kernel's class
    picked = got.clamp(0, n_classes - 1)[..., None].long()
    gaps = (logits.gather(-1, want[..., None].long()) - logits.gather(-1, picked))[differ]
    gap = gaps.max().item() if gaps.numel() else 0.0
    tie_tol = K3_TIE[dt] * logits.abs().max().item()
    ok = (tuple(got.shape) == tuple(shape) and in_range and agree >= K3_AGREEMENT[dt]
          and gap <= tie_tol)
    print(f"{name} {str(dt):14s} agreement={agree:.6f} (>= {K3_AGREEMENT[dt]}), "
          f"{int(differ.sum())} pixels differ, largest plain-logit gap between the two classes "
          f"there {gap:.3e} (near tie <= {tie_tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {name} disagrees with its plain version in {dt}")
    return agree, int(differ.sum()), gap


def _head_params(gen, c, n_classes, dt):
    from arseg_tpu_torch.ops import creff_head_kernel

    weight = torch.randn(n_classes, c, 1, 1, device="cuda", generator=gen) / c ** 0.5
    return creff_head_kernel.pack_head(
        weight, torch.randn(n_classes, device="cuda", generator=gen) * 0.1, dt)


def k3_case(gen, dt, n, hw, c, n_classes):
    """K3 at [n, *hw, c] against its plain version (run a GOP's frames at a
    time): class-map agreement and near ties at every disagreement."""
    from arseg_tpu_torch.ops import creff_head_kernel, creff_kernel

    lr_up = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    ref = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, c)
    fc_w, fc_b = _head_params(gen, c, n_classes, dt)
    args = (lr_up, ref, taps, bias, fc_w, fc_b, 7, 7)
    k3 = lambda: creff_head_kernel.creff_phase2_argmax(*args)
    p3 = lambda: _by_frames(lambda lo, hi: creff_head_kernel.creff_phase2_argmax_plain(
        lr_up[lo:hi], ref[lo:hi], *args[2:]), n)
    # the plain version's logits, to find near ties where the maps differ
    logits = _by_frames(lambda lo, hi: creff_kernel.creff_qkv_fused_plain(
        lr_up[lo:hi], ref[lo:hi], taps, bias, 7, 7).float() @ fc_w + fc_b, n)
    agree, differ, gap = check_maps("creff_phase2_argmax", dt, k3(), logits, (n, *hw))
    del logits
    elem_bytes = lr_up.element_size()
    # a class map has no error magnitude: max_abs_err is that logit gap
    return dict(max_abs_err=gap, agreement=agree, pixels_differ=differ,
                ms=median_ms(k3), plain_ms=median_ms(p3, runs=PLAIN_RUNS_PSP), library_ms=None,
                bytes=2 * lr_up.numel() * elem_bytes + n * hw[0] * hw[1] * 4
                + (taps.numel() + bias.numel() + fc_w.numel() + fc_b.numel()) * 4,
                # the module's 251 per element, and the 1x1 conv's multiply-adds
                flops=lr_up.numel() * (251 + 2 * n_classes))


def k3_lr_case(gen, dt, n, hw, c, n_classes):
    """K3's LR form: the LR feature at half of hw and ref at hw (bfloat16:
    the LR form, float32: the resize and K3), against its plain version
    (the resize and K3's plain version, a GOP's frames at a time): class-map
    agreement and near ties at every disagreement, as K3; and against K3
    over the feature resized as ``nn/pspnet.py`` resized it before the LR
    form (``resize_bilinear``, align_corners=True): the maps equal bit for
    bit, the launch counts of both routes. Timed beside that resize + K3
    (``resize_k3_ms``) and the plain version."""
    from arseg_tpu_torch.ops import _build, creff_head_kernel as k3, creff_kernel
    from arseg_tpu_torch.ops.resize import resize_bilinear

    lr = torch.randn(n, hw[0] // 2, hw[1] // 2, c, device="cuda", generator=gen).to(dt)
    ref = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, c)
    fc_w, fc_b = _head_params(gen, c, n_classes, dt)
    head = (taps, bias, fc_w, fc_b, 7, 7)
    run = lambda: k3.creff_phase2_argmax(lr, ref, *head)
    resize_k3 = lambda: k3.creff_phase2_argmax(resize_bilinear(lr, hw, True), ref, *head)
    _build.LAUNCHES.clear()
    got = run()
    lr_form = dict(_build.LAUNCHES)
    want = resize_k3()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    expected = ({k3.NAME_LR: 1, k3.NAME: 1} if dt == torch.bfloat16
                else {k3.NAME_LR: 0, k3.NAME: 2})
    equal = torch.equal(got, want)
    counted = all(launches.get(k, 0) == v for k, v in expected.items())
    print(f"{k3.NAME_LR} {str(dt):14s} maps equal to resize_bilinear + K3's: {equal}; launches "
          f"of the LR form {lr_form}, of both {launches} (expected {expected}) "
          f"{'ok' if equal and counted else 'FAIL'}", flush=True)
    if not equal or not counted:
        raise SystemExit(f"chip_smoke: K3's LR form is not the resize and K3 in {dt}")
    del want
    # the plain version's logits, to find near ties where the maps differ
    logits = _by_frames(lambda lo, hi: creff_kernel.creff_qkv_fused_plain(
        resize_bilinear(lr[lo:hi], hw, True), ref[lo:hi], taps, bias, 7, 7).float()
        @ fc_w + fc_b, n)
    agree, differ, gap = check_maps(k3.NAME_LR, dt, got, logits, (n, *hw))
    del got, logits
    plain = lambda: _by_frames(lambda lo, hi: k3.creff_phase2_argmax_lr_plain(
        lr[lo:hi], ref[lo:hi], *head), n)
    elem_bytes = lr.element_size()
    # a class map has no error magnitude: max_abs_err is that logit gap
    return dict(max_abs_err=gap, agreement=agree, pixels_differ=differ, ms=median_ms(run),
                plain_ms=median_ms(plain, runs=PLAIN_RUNS_PSP), library_ms=None,
                resize_k3_ms=median_ms(resize_k3),
                # the LR feature and ref read once, the int32 map written once
                bytes=(lr.numel() + ref.numel()) * elem_bytes + n * hw[0] * hw[1] * 4
                + (taps.numel() + bias.numel() + fc_w.numel() + fc_b.numel()) * 4,
                flops=ref.numel() * (251 + 2 * n_classes))


def k4_case(gen, dt, n, hw, c, plain_runs):
    """K4 at q, k, v [n, *hw, c] against its plain version."""
    from arseg_tpu_torch.ops import creff_attention_kernel

    q, k, v = (torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt) for _ in range(3))
    k4 = lambda: creff_attention_kernel.creff_attention(q, k, v, 7, 7)
    p4 = lambda: creff_attention_kernel.creff_attention_plain(q, k, v, 7, 7)
    err = check("creff_attention", dt, k4(), p4())
    # per element: 49-tap logits (98) and weighting (98)
    return dict(max_abs_err=err, ms=median_ms(k4), plain_ms=median_ms(p4, runs=plain_runs),
                library_ms=None, bytes=4 * q.numel() * q.element_size(), flops=q.numel() * 196)


def k5_case(gen, dt, n, hw, c, n_classes):
    """K5 at [n, *hw, c] -> [n, 8h, 8w] against its plain version: class-map
    agreement and near ties of the plain upsampled logits at every
    disagreement, as K3."""
    from arseg_tpu_torch.ops import creff_upsample_head_kernel as k5

    lr_up = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    ref = torch.randn(n, *hw, c, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, c)
    weight = torch.randn(n_classes, c, 1, 1, device="cuda", generator=gen) / c ** 0.5
    fc_w, fc_b = k5.pack_upsample_head(
        weight, torch.randn(n_classes, device="cuda", generator=gen) * 0.1, dt)
    args = (lr_up, ref, taps, bias, fc_w, fc_b, 7, 7)
    run5 = lambda: k5.creff_phase2_upsample_argmax(*args)
    plain5 = lambda: k5.creff_phase2_upsample_argmax_plain(*args)
    logits = k5.upsampled_logits_plain(*args)
    out_shape = (n, 8 * hw[0], 8 * hw[1])
    agree, differ, gap = check_maps("creff_phase2_upsample_argmax", dt, run5(), logits, out_shape)
    del logits
    elem_bytes = lr_up.element_size()
    out_px = n * out_shape[1] * out_shape[2]
    return dict(max_abs_err=gap, agreement=agree, pixels_differ=differ,
                ms=median_ms(run5), plain_ms=median_ms(plain5), library_ms=None,
                bytes=2 * lr_up.numel() * elem_bytes + out_px * 4
                + (taps.numel() + bias.numel() + fc_w.numel() + fc_b.numel()) * 4,
                # the module's 251 per element and the 1x1 conv's multiply-adds;
                # per class the column pass (3 per fused row and output column)
                # and the row pass with the bias (4 per output)
                flops=lr_up.numel() * (251 + 2 * n_classes)
                + n_classes * (3 * n * hw[0] * 8 * hw[1] + 4 * out_px))


def _block_flow(rng, n, h, w, lo, hi, jitter=0.0):
    br, bc = WARP_BLOCK
    fb = rng.uniform(lo, hi, (2, n, h // br, w // bc)).astype(np.float32)
    f = np.repeat(np.repeat(fb, br, axis=2), bc, axis=3)
    if jitter:
        f = f + rng.uniform(-jitter, jitter, f.shape).astype(np.float32)
    return f[0], f[1]


def _scene_flow(rng, n, h, w, mag, objects=3):
    """A pan plus a few rigidly moving rectangles, snapped to quarter-pel."""
    fx = np.empty((n, h, w), np.float32)
    fy = np.empty((n, h, w), np.float32)
    for b in range(n):
        fx[b] = rng.uniform(-mag, mag)
        fy[b] = rng.uniform(-mag, mag)
        for _ in range(objects):
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            yh, xw = rng.randint(4, h // 2), rng.randint(4, w // 2)
            fx[b, y0 : y0 + yh, x0 : x0 + xw] = rng.uniform(-mag, mag)
            fy[b, y0 : y0 + yh, x0 : x0 + xw] = rng.uniform(-mag, mag)
    return (np.round(fx * 4) / 4).astype(np.float32), (np.round(fy * 4) / 4).astype(np.float32)


def warp_edge_cases(c, seed=0):
    """name -> (src [1 or n, h, w, c], fx [n, h, w], fy) float32 numpy
    arrays: the flow cases of tests/test_pallas_warp.py and
    tests/test_pallas_warp2.py (block-coherent flows with and without
    subpixel jitter, corners far out of the image, discontinuities inside
    motion blocks (window overflow), per-pixel random flows (past the
    correction budget), scene flows, small reach, and reach beyond one
    128-wide tile), then the edges of K2's tiling (sets of 32 pixels,
    blocks of 32 to 128): 11 frames from one source at a size off both tiles, one source
    per frame, a single row, a single column, and flows of +-60. All are
    small enough for K2's frames-outermost block order (warp_edge_phase
    adds sources too large for it)."""
    rng = np.random.RandomState(seed)
    h, w = 32, 64

    def src(hh=h, ww=w):
        return rng.randn(1, hh, ww, c).astype(np.float32)

    cases = {
        "coherent": (src(), *_block_flow(rng, 2, h, w, -6, 6)),
        "coherent_jitter": (src(), *_block_flow(rng, 2, h, w, -6, 6, jitter=0.45)),
        "out_of_image": (src(), *_block_flow(rng, 1, h, w, -40, 40)),
    }
    fx, fy = _block_flow(rng, 1, h, w, -6, 6)
    fx = fx.copy()
    fx[:, 10:20, 13:40] += np.where(
        (np.arange(27)[None, :] + np.arange(10)[:, None]) % 2 == 0, 12.0, -9.0
    ).astype(np.float32)
    cases["discontinuity"] = (src(), fx, fy)
    cases["over_budget"] = (src(), *(rng.uniform(-16, 16, (1, h, w)).astype(np.float32)
                                     for _ in range(2)))
    cases["scene"] = (src(40, 48), *_scene_flow(rng, 2, 40, 48, 9.0))
    cases["small_reach"] = (src(32, 40), *_scene_flow(rng, 1, 32, 40, 3.0))
    cases["cross_tile"] = (src(48, 200), np.full((1, 48, 200), 140.25, np.float32),
                           np.full((1, 48, 200), -20.5, np.float32))
    cases["random_8"] = (src(24, 32), *(rng.uniform(-8, 8, (2, 24, 32)).astype(np.float32)
                                        for _ in range(2)))

    def flow(n, hh, ww, mag):
        return tuple(rng.uniform(-mag, mag, (n, hh, ww)).astype(np.float32) for _ in range(2))

    cases["gop_11"] = (src(13, 37), *flow(11, 13, 37, 16))
    cases["per_frame"] = (rng.randn(3, 29, 43, c).astype(np.float32), *flow(3, 29, 43, 16))
    cases["row"] = (src(1, 45), *flow(2, 1, 45, 8))
    cases["column"] = (src(45, 1), *flow(2, 45, 1, 8))
    cases["reach_60"] = (src(29, 43), *flow(2, 29, 43, 60))
    return cases


def _warp_exact(name, src, fx, fy):
    """K2 against its plain version on one case, in f32 and bf16: max|d|
    must be 0 (and within the tolerance). src, fx, fy are on the card."""
    from arseg_tpu_torch.ops import warp_kernel

    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        s = src.to(dt)
        got = warp_kernel.warp_bilinear(s, fx, fy)
        want = warp_kernel.warp_bilinear_plain(s, fx, fy)
        err = (got.float() - want.float()).abs().max().item()
        tol = TOL["warp_bilinear"][dt] * max(1.0, want.float().abs().max().item())
        if not (err <= tol and err == 0):
            raise SystemExit(f"chip_smoke: warp_bilinear case {name} {dt}: "
                             f"max|d| {err:.3e}, must be 0 (and <= {tol:.3e})")
        worst = max(worst, err)
    return worst


def warp_edge_phase():
    phase("K2 on the flow cases of tests/test_pallas_warp*.py and at the edges of its tiling")
    worst = 0.0
    for c in WARP_EDGE_C:
        for name, (src, fx, fy) in warp_edge_cases(c).items():
            worst = max(worst, _warp_exact(f"{name} C={c}", *(torch.from_numpy(a).cuda()
                                                              for a in (src, fx, fy))))
    print(f"warp_bilinear: {len(warp_edge_cases(8))} cases x C in {WARP_EDGE_C} x (f32, bf16) "
          f"ok, largest max|d| {worst:.3e} (exact)", flush=True)
    # a source larger than half the L2 at a size off the 128-pixel tile: one
    # source for 3 frames takes the frames-innermost block order, one source
    # per frame the frames-outermost one
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w, c = 3, 723, 965, 64
    fx, fy = ((torch.rand((n, h, w), generator=gen, device="cuda") - 0.5) * 32 for _ in range(2))
    for ns in (1, n):
        src = torch.randn((ns, h, w, c), generator=gen, device="cuda")
        worst = max(worst, _warp_exact(f"[{ns},{h},{w},{c}] -> {n}", src, fx, fy))
    print(f"warp_bilinear: [1 and {n},{h},{w},{c}] -> {n} (f32, bf16) ok, largest max|d| "
          f"{worst:.3e} (exact)", flush=True)
    warp_sources_phase()


def warp_sources_phase():
    """K2 with S sources for n frames (frame i reads source i // (n / S)):
    3 sources for 33 frames at C 8, 64 and 136, and S = n, exactly; then
    the wrapper and the C launcher refuse an n that S does not divide."""
    from arseg_tpu_torch.ops import _build, warp_kernel

    rng = np.random.RandomState(2)
    worst = 0.0
    for c in (8, 64, 136):
        for s, n, h, w in ((3, 33, 13, 37), (4, 4, 29, 43)):
            src = torch.from_numpy(rng.randn(s, h, w, c).astype(np.float32)).cuda()
            fx, fy = (torch.from_numpy(rng.uniform(-16, 16, (n, h, w)).astype(np.float32)).cuda()
                      for _ in range(2))
            worst = max(worst, _warp_exact(f"{s} sources -> {n} C={c}", src, fx, fy))
    print(f"warp_bilinear: 3 sources -> 33 frames and S = n = 4, C in (8, 64, 136) (f32, bf16) "
          f"ok, largest max|d| {worst:.3e} (exact)", flush=True)
    src = torch.zeros(3, 13, 37, 8, device="cuda")
    fx = torch.zeros(32, 13, 37, device="cuda")
    out = torch.empty(32, 13, 37, 8, device="cuda")
    try:
        warp_kernel.warp_bilinear(src, fx, fx)
    except ValueError:
        pass
    else:
        raise SystemExit("chip_smoke: warp_bilinear took 3 sources for 32 frames")
    try:
        _build.launch("warp_bilinear", out, src, fx, fx, 32, 3, 13, 37, 8, 0, torch.float32)
    except RuntimeError as e:
        refused = e
    else:
        raise SystemExit("chip_smoke: the K2 launcher took 3 sources for 32 frames")
    print(f"warp_bilinear: 3 sources for 32 frames refused by the wrapper (ValueError) and by "
          f"the launcher ({refused})", flush=True)


# (n, h, w, c, window): sizes that are no multiple of the 16 x 16 tile, a
# single row, n = 1, C of 16, 64 and 512, and each window
MODULE_EDGE_SHAPES = [
    (1, 13, 37, 16, 3), (2, 13, 37, 64, 5), (1, 1, 5, 64, 7), (1, 1, 5, 16, 5),
    (1, 45, 60, 512, 7), (3, 45, 60, 16, 7), (2, 13, 37, 512, 3),
]
# K4 and K5 besides: sizes that are no multiple of K5's 14-pixel interior
# (one past a multiple, and one short of one), and a single column, where
# the upsample's clamp folds i1 onto i0 along that axis as h = 1 does
HEAD_EDGE_SHAPES = [(1, 15, 29, 64, 7), (2, 29, 43, 16, 5), (1, 27, 13, 32, 7), (1, 7, 1, 16, 3)]
# K3's LR form, (n, h_in, w_in, h, w, c, window): x2 onto sizes off the
# 16-pixel tile, 0.7x, a ratio of 7, one close to 1, W or H alone smaller,
# a single row
LR_EDGE_SHAPES = [(2, 36, 51, 71, 101, 64, 5), (1, 63, 84, 90, 120, 16, 7),
                  (2, 7, 9, 50, 70, 32, 7), (2, 60, 80, 61, 81, 16, 3), (1, 37, 20, 37, 45, 64, 7),
                  (1, 19, 37, 45, 37, 16, 5), (1, 1, 6, 1, 37, 16, 3)]


def _tie_and_negative(name, run, logits_of, gen, dt):
    """`run(fc_w, fc_b)` -> a class map at [2, 13, 37] C = 64; classes 2
    and 9 tied in every pixel (the lower index must win everywhere), then
    every logit below zero, held against `logits_of(fc_w, fc_b)`."""
    fc_w, fc_b = _head_params(gen, 64, 12, dt)
    # classes 2 and 9 lie in different n8 tiles and on different lanes
    fc_w[:, 9] = fc_w[:, 2]
    fc_b[2] = fc_b[9] = 50.0
    got = run(fc_w, fc_b)
    print(f"{name} tie of classes 2 and 9: {int((got == 2).sum())} of {got.numel()} pixels take "
          f"class 2", flush=True)
    if not bool((got == 2).all()):
        raise SystemExit(f"chip_smoke: {name} does not take the lowest index of a tie")
    fc_b = torch.full_like(fc_b, -100.0)
    check_maps(f"{name} logits all below 0", dt, run(fc_w, fc_b), logits_of(fc_w, fc_b),
               tuple(got.shape))


def module_edge_phase():
    """K1, K3, K4 and K5 in bfloat16 (the tensor-core body and products)
    against their plain versions, with the main rows' tolerances, at
    MODULE_EDGE_SHAPES and HEAD_EDGE_SHAPES (K3 and K5 with 12 and 19
    classes; K1 and K3 at the first list only); then K3 and K5 with two
    classes tied in every pixel (the lower index must win everywhere) and
    with every logit below zero (K3: the zero columns that pad the classes
    must never win); then K3's LR form at LR_EDGE_SHAPES, its maps equal to
    K3's over the resized feature."""
    from arseg_tpu_torch.ops import creff_attention_kernel, creff_head_kernel, creff_kernel
    from arseg_tpu_torch.ops import creff_upsample_head_kernel as k5
    from arseg_tpu_torch.ops.resize import resize_bilinear

    t0 = time.perf_counter()
    phase("K1, K3, K4 and K5, bf16 tensor-core kernels, at edge shapes")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.bfloat16
    for n, h, w, c, k in MODULE_EDGE_SHAPES + HEAD_EDGE_SHAPES:
        print(f"-- [{n},{h},{w},{c}] window {k}", flush=True)
        lr_up = torch.randn(n, h, w, c, device="cuda", generator=gen).to(dt)
        ref = torch.randn(n, h, w, c, device="cuda", generator=gen).to(dt)
        v = torch.randn(n, h, w, c, device="cuda", generator=gen).to(dt)
        taps, bias = _qkv_params(gen, c)
        check("creff_attention", dt, creff_attention_kernel.creff_attention(lr_up, ref, v, k, k),
              creff_attention_kernel.creff_attention_plain(lr_up, ref, v, k, k))
        module = (n, h, w, c, k) in MODULE_EDGE_SHAPES
        if module:
            fused = creff_kernel.creff_qkv_fused_plain(lr_up, ref, taps, bias, k, k)
            check("creff_qkv_fused", dt,
                  creff_kernel.creff_qkv_fused(lr_up, ref, taps, bias, k, k), fused)
        for n_classes in (12, 19):
            fc_w, fc_b = _head_params(gen, c, n_classes, dt)
            if module:
                got = creff_head_kernel.creff_phase2_argmax(lr_up, ref, taps, bias, fc_w, fc_b,
                                                            k, k)
                check_maps(f"creff_phase2_argmax {n_classes} classes", dt, got,
                           fused.float() @ fc_w + fc_b, (n, h, w))
            args = (lr_up, ref, taps, bias, fc_w, fc_b, k, k)
            check_maps(f"creff_phase2_upsample_argmax {n_classes} classes", dt,
                       k5.creff_phase2_upsample_argmax(*args), k5.upsampled_logits_plain(*args),
                       (n, 8 * h, 8 * w))
    lr_up = torch.randn(2, 13, 37, 64, device="cuda", generator=gen).to(dt)
    ref = torch.randn(2, 13, 37, 64, device="cuda", generator=gen).to(dt)
    taps, bias = _qkv_params(gen, 64)
    fused = creff_kernel.creff_qkv_fused_plain(lr_up, ref, taps, bias, 7, 7)
    _tie_and_negative(
        "creff_phase2_argmax",
        lambda fc_w, fc_b: creff_head_kernel.creff_phase2_argmax(lr_up, ref, taps, bias, fc_w,
                                                                 fc_b, 7, 7),
        lambda fc_w, fc_b: fused.float() @ fc_w + fc_b, gen, dt)
    _tie_and_negative(
        "creff_phase2_upsample_argmax",
        lambda fc_w, fc_b: k5.creff_phase2_upsample_argmax(lr_up, ref, taps, bias, fc_w, fc_b, 7,
                                                           7),
        lambda fc_w, fc_b: k5.upsampled_logits_plain(lr_up, ref, taps, bias, fc_w, fc_b, 7, 7),
        gen, dt)
    for n, h_in, w_in, h, w, c, k in LR_EDGE_SHAPES:
        lr = torch.randn(n, h_in, w_in, c, device="cuda", generator=gen).to(dt)
        ref = torch.randn(n, h, w, c, device="cuda", generator=gen).to(dt)
        head = (*_qkv_params(gen, c), *_head_params(gen, c, N_CLASSES, dt), k, k)
        got = creff_head_kernel.creff_phase2_argmax(lr, ref, *head)
        want = creff_head_kernel.creff_phase2_argmax(resize_bilinear(lr, (h, w), True), ref,
                                                     *head)
        equal = torch.equal(got, want)
        print(f"{creff_head_kernel.NAME_LR} [{n},{h_in},{w_in},{c}] -> {h}x{w} window {k}: maps "
              f"equal to resize_bilinear + K3's: {equal} {'ok' if equal else 'FAIL'}", flush=True)
        if not equal:
            raise SystemExit("chip_smoke: K3's LR form is not the resize and K3")
    print(f"-- kernel edge shapes: {time.perf_counter() - t0:.1f} s", flush=True)


def kernel_phase():
    from arseg_tpu_torch.nn.functional import frame_chunks

    phase("kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = GOP - 1
    # camvid-psp18 V1's multi-GOP step: K3 over each chunk of its frames
    (lo, hi), *_ = frame_chunks(MULTI_GOPS * n, H * W * C_PSP)
    stats = {}
    big = (n, (H, W), C_PSP, PLAIN_RUNS_PSP)
    v2 = (n, FEAT_HW, C_PSP_V2, TIMED_RUNS)
    # (kernel, shape key, case, its arguments); the key names the path
    cases = [
        ("creff_qkv_fused", "bise18", k1_case, (n, FEAT_HW, C, TIMED_RUNS)),
        ("warp_bilinear", "bise18", k2_case, (n, FEAT_HW, C, TIMED_RUNS)),
        ("creff_phase2_argmax", "psp18 V1", k3_case, (n, (H, W), C_PSP, N_CLASSES)),
        ("creff_phase2_argmax_lr", "psp18 V1", k3_lr_case, (n, (H, W), C_PSP, N_CLASSES)),
        ("warp_bilinear", "psp18 V1", k2_case, big),
        ("creff_qkv_fused", "psp18 V2", k1_case, v2),
        ("warp_bilinear", "psp18 V2", k2_case, v2),
        ("creff_attention", "bise18 localNoGroup", k4_case, (n, FEAT_HW, C, TIMED_RUNS)),
        ("creff_attention", "bise18 local5 sub-grid", k4_case,
         (n, (FEAT_HW[0] // 2, FEAT_HW[1] // 2), C, TIMED_RUNS)),
        ("creff_phase2_upsample_argmax", "bise18 fused head", k5_case, (n, FEAT_HW, C, N_CLASSES)),
        ("creff_qkv_fused", "cityscapes-bise18", k1_case, (n, CITY_FEAT_HW, C, PLAIN_RUNS_PSP)),
        ("warp_bilinear", "cityscapes-bise18", k2_case,
         (n, CITY_FEAT_HW, C, PLAIN_RUNS_PSP, CITY_HW)),
        ("creff_qkv_fused", "cityscapes-psp18", k1_case,
         (n, CITY_FEAT_HW, C_CITY_PSP, PLAIN_RUNS_PSP)),
        ("warp_bilinear", "cityscapes-psp18", k2_case,
         (n, CITY_FEAT_HW, C_CITY_PSP, PLAIN_RUNS_PSP, CITY_HW)),
        # B GOPs in one step: K1 over all B*(G-1) frames, K2 from B sources
        ("creff_qkv_fused", "bise18 multi-GOP", k1_case,
         (MULTI_GOPS * n, FEAT_HW, C, PLAIN_RUNS_PSP)),
        ("warp_bilinear", "bise18 multi-GOP", k2_case,
         (MULTI_GOPS * n, FEAT_HW, C, PLAIN_RUNS_PSP, (H, W), MULTI_GOPS)),
        ("creff_phase2_argmax", "psp18 V1 multi-GOP chunk", k3_case,
         (hi - lo, (H, W), C_PSP, N_CLASSES)),
        ("creff_phase2_argmax_lr", "psp18 V1 multi-GOP chunk", k3_lr_case,
         (hi - lo, (H, W), C_PSP, N_CLASSES)),
        ("warp_bilinear", "psp18 V1 multi-GOP", k2_sources_case,
         (MULTI_GOPS * n, (H, W), C_PSP, PLAIN_RUNS_PSP, MULTI_GOPS)),
        # streaming: a frame a frame_step; EvalAlterRes: a batch of frames,
        # each warped from its own keyframe's feature
        ("creff_qkv_fused", "bise18 streaming", k1_case, (1, FEAT_HW, C, TIMED_RUNS)),
        ("warp_bilinear", "bise18 streaming", k2_case, (1, FEAT_HW, C, TIMED_RUNS)),
        ("creff_qkv_fused", "EvalAlterRes", k1_case, (EVAL_BATCH, FEAT_HW, C, TIMED_RUNS)),
        ("warp_bilinear", "EvalAlterRes", k2_case,
         (EVAL_BATCH, FEAT_HW, C, TIMED_RUNS, (H, W), EVAL_BATCH)),
        # the training step's stage 2: the student's fusion over the batch,
        # K2 warping each frame's own keyframe feature
        ("creff_qkv_fused", "training stage 2", k1_case, (TRAIN_BATCH, FEAT_HW, C, PLAIN_RUNS_PSP)),
        ("warp_bilinear", "training stage 2", k2_case,
         (TRAIN_BATCH, FEAT_HW, C, PLAIN_RUNS_PSP, (H, W), TRAIN_BATCH)),
        # K1's backward: the training step's (hr is the teacher's warped
        # feature, under no_grad), and psp18 V2's C = 512 with d ref
        ("creff_qkv_fused_backward", "training stage 2", k1b_case,
         (TRAIN_BATCH, FEAT_HW, C, PLAIN_RUNS_PSP, False)),
        ("creff_qkv_fused_backward", "psp18 V2", k1b_case, (n, FEAT_HW, C_PSP_V2, PLAIN_RUNS_PSP,
                                                            True)),
        # information: no driven path runs K1 at V1's shape (V1 runs K3 there)
        ("creff_qkv_fused", "psp18 V1 (information)", k1_case, big),
    ]
    for dt in (torch.float32, torch.bfloat16):
        for name, shape, case, args in cases:
            dims = [args[0], *args[1], args[2]]
            print(f"-- {name} at the {shape} shape {dims}, {dt}", flush=True)
            stats[(name, shape, dt)] = dict(case(gen, dt, *args), dims=dims)
            torch.cuda.empty_cache()
    stats.update(resize_backward_phase())
    for (name, shape, dt), s in stats.items():
        _bound(s, dt)
        lib = "none" if s["library_ms"] is None else f"{s['library_ms']:.4f}"
        parent = f" resize_k3_ms={s['resize_k3_ms']:.4f}" if "resize_k3_ms" in s else ""
        print(f"{name} {shape} {s['dims']} {str(dt):14s} ms={s['ms']:.4f} "
              f"plain_ms={s['plain_ms']:.4f} library_ms={lib}{parent} "
              f"bound_ms={s['bound_ms']:.4f} ({s['bound_by']}) "
              f"max_abs_err={s['max_abs_err']:.3e}", flush=True)
    warp_edge_phase()
    module_edge_phase()
    return stats


def make_models(backend="camvid-bise18", fuse_version=1, attention_type="local"):
    """HR and LR models at full width on the CPU, weights from seeded
    generators, BN statistics randomised. The BiSeNets: HR plain, LR fused
    with `attention_type`; camvid-psp18 V1: HR plain (V0), LR V1; V2: both
    V2; cityscapes-psp18: both with the fusion, as the registry builds it."""
    from arseg_tpu_torch.models import build_model
    from arseg_tpu_torch.nn.init import randomize_bn_

    kw = (dict(fuse_version=fuse_version) if backend == "camvid-psp18"
          else dict(attention_type=attention_type))
    hr_fuse = backend == "camvid-psp18" and fuse_version == 2
    models = []
    for seed, fuse in ((0, hr_fuse), (1, True)):
        m = build_model(backend, fuse=fuse, seed=seed, device="cpu", **kw)
        randomize_bn_(m, torch.Generator().manual_seed(100 + seed))
        models.append(m)
    return models


def make_clip(gops, frames=GOP - 1, hw=(H, W)):
    """uint8 keyframes [K,h,w,3] and frames [K,frames,h,w,3], and flow planes
    [K,frames,h,w] drawn uniform(-16, 16) as bench.py draws them."""
    rng = np.random.RandomState(0)
    kfs = torch.from_numpy(rng.randint(0, 256, (gops, *hw, 3), dtype=np.uint8))
    frs = torch.from_numpy(rng.randint(0, 256, (gops, frames, *hw, 3), dtype=np.uint8))
    fxs = torch.from_numpy(rng.uniform(-16, 16, (gops, frames, *hw)).astype(np.float32))
    fys = torch.from_numpy(rng.uniform(-16, 16, (gops, frames, *hw)).astype(np.float32))
    return kfs, frs, fxs, fys


def check_maps_range(preds, shape, n_classes, name):
    if tuple(preds.shape) != tuple(shape) or preds.dtype != torch.int32:
        raise SystemExit(f"chip_smoke: {name}: bad output {tuple(preds.shape)} {preds.dtype}")
    if int(preds.min()) < 0 or int(preds.max()) >= n_classes:
        raise SystemExit(f"chip_smoke: {name}: class index out of range")


def run_clip(pipe, clip, name, n_classes=N_CLASSES):
    """Warm-up GOP, then scan_step over the clip with every launch count set
    to 0 just before and read just after. Returns (maps, launches)."""
    from arseg_tpu_torch.ops import _build

    dev = [x.cuda() for x in clip]
    pipe.gop_step(dev[0][:1], dev[1][0], (dev[2][0], dev[3][0]))  # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    preds = pipe.scan_step(*dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    gops = dev[0].shape[0]
    print(f"{name} scan_step: {gops} GOPs in {dt * 1e3:.2f} ms: {dt * 1e3 / gops:.2f} ms/GOP, "
          f"{gops * GOP / dt:.1f} frames/s; launches {launches}", flush=True)
    check_maps_range(preds, (gops, GOP, *dev[0].shape[1:3]), n_classes, name)
    return preds, launches


def expect_launches(launches, expected, name):
    for kernel, count in expected.items():
        if launches.get(kernel, 0) != count:
            raise SystemExit(f"chip_smoke: {kernel} launched {launches.get(kernel, 0)} times on "
                             f"the {name} path, expected {count}")


def pipeline_phase():
    from arseg_tpu_torch.gop import ARPipeline

    phase("pipeline: camvid-bise18 AR 0.5x, GOP 12, 720x960")
    models = make_models()
    kfs, frs, fxs, fys = make_clip(CLIP_GOPS)
    norm = (CAMVID_MEAN, CAMVID_STD)

    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    preds, launches = run_clip(pipe, (kfs, frs, fxs, fys), "camvid-bise18")
    expect_launches(launches, {"warp_bilinear": CLIP_GOPS, "creff_phase2_argmax": 0,
                               "creff_attention": 0, **head_launches(None)}, "camvid-bise18")
    card_vs_cpu(models, (kfs, frs, fxs, fys), preds[0], "camvid-bise18")
    return launches


def head_launches(fused_head):
    """Expected launches of K1 and K5 over a clip of camvid-bise18 "local"
    with the fused upsample head on or off (None: the module default)."""
    from arseg_tpu_torch.nn import bisenet

    if fused_head is None:
        fused_head = bisenet.USE_FUSED_UPSAMPLE_HEAD
    return {"creff_qkv_fused": 0 if fused_head else CLIP_GOPS,
            "creff_phase2_upsample_argmax": CLIP_GOPS if fused_head else 0}


def card_vs_cpu(models, clip, preds_b16, name, norm=(CAMVID_MEAN, CAMVID_STD),
                fused_share=False):
    """One GOP on the card in float32 against the CPU (plain versions) in
    float32: class-map agreement, and the fused features within FUSED_TOL;
    the card's bfloat16 maps of that GOP, `preds_b16`, beside them for
    information where given. fused_share: the fused features need agree
    within FUSED_TOL on AGREEMENT of their elements only, as the maps do on
    their pixels: CReFF's softmax over the products of deep nets' features
    is nearly a hard choice of one window position, and at a near tie its
    output jumps: on the semseg ResNet-50 the CPU's own float32 fused
    feature differs from its float64 one by more than FUSED_TOL allows in
    a few places, though by ~1e-5 in relative L2."""
    from arseg_tpu_torch.gop import ARPipeline

    kfs, frs, fxs, fys = clip
    args = (kfs[:1], frs[0], (fxs[0], fys[0]))
    card = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda")
    cpu = ARPipeline(*models, scale=SCALE, normalize=norm, device="cpu")
    p_card, f_card = card.gop_step(*args, return_fused=True)
    t0 = time.perf_counter()
    p_cpu, f_cpu = cpu.gop_step(*args, return_fused=True)
    agree = (p_card.cpu() == p_cpu).float().mean().item()
    diff = (f_card.cpu() - f_cpu).abs()
    dfused, fscale = diff.max().item(), f_cpu.abs().max().item()
    tol = FUSED_TOL * max(1.0, fscale)
    within = (diff <= tol).float().mean().item()
    b16 = ("" if preds_b16 is None else
           f"; card bf16 vs CPU f32 agreement {(preds_b16.cpu() == p_cpu).float().mean().item():.6f}")
    print(f"{name} card f32 vs CPU f32 (one GOP of {frs.shape[1] + 1} frames at "
          f"{tuple(kfs.shape[1:3])}, CPU {time.perf_counter() - t0:.1f} s): class-map agreement "
          f"{agree:.6f} (>= {AGREEMENT}), fused max|d| {dfused:.3e} (max|fused| {fscale:.3e}), "
          f"share within {tol:.3e} {within:.6f}"
          f"{f' (>= {AGREEMENT})' if fused_share else ''}{b16}", flush=True)
    fused_ok = within >= AGREEMENT if fused_share else dfused <= tol
    if not agree >= AGREEMENT or not fused_ok:
        raise SystemExit(f"chip_smoke: the card's float32 {name} GOP disagrees with the CPU")


def variants_phase():
    """camvid-bise18 with the localNoGroup and local5 fusions (K4), then
    with the fused upsample head (K5)."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.nn import bisenet
    from arseg_tpu_torch.ops import _build

    norm = (CAMVID_MEAN, CAMVID_STD)
    clip = make_clip(CLIP_GOPS)
    paths = {}

    phase("pipeline: camvid-bise18 AR, localNoGroup fusion (K4), GOP 12, 720x960, bf16")
    models = make_models(attention_type="localNoGroup")
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    preds, paths["camvid-bise18 localNoGroup"] = run_clip(pipe, clip, "camvid-bise18 localNoGroup")
    expect_launches(paths["camvid-bise18 localNoGroup"],
                    {"creff_attention": CLIP_GOPS, "warp_bilinear": CLIP_GOPS,
                     "creff_qkv_fused": 0, "creff_phase2_upsample_argmax": 0},
                    "camvid-bise18 localNoGroup")
    del pipe
    card_vs_cpu(models, clip, preds[0], "camvid-bise18 localNoGroup")

    phase("pipeline: camvid-bise18 AR, local5 fusion (K4 on four sub-grids), one GOP, bf16")
    pipe = ARPipeline(*make_models(attention_type="local5"), scale=SCALE, dtype=torch.bfloat16,
                      normalize=norm, device="cuda")
    kfs, frs, fxs, fys = (x.cuda() for x in clip)
    pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))  # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
    torch.cuda.synchronize()
    paths["camvid-bise18 local5"] = dict(_build.LAUNCHES)
    print(f"camvid-bise18 local5 GOP: {tuple(out.shape)} {out.dtype}, classes "
          f"{int(out.min())}..{int(out.max())}; launches {paths['camvid-bise18 local5']}",
          flush=True)
    if tuple(out.shape) != (GOP, H, W) or int(out.min()) < 0 or int(out.max()) >= N_CLASSES:
        raise SystemExit("chip_smoke: bad local5 output")
    expect_launches(paths["camvid-bise18 local5"],
                    {"creff_attention": 4, "warp_bilinear": 1, "creff_qkv_fused": 0},
                    "camvid-bise18 local5")
    del pipe, out, kfs, frs, fxs, fys
    torch.cuda.empty_cache()

    head = not bisenet.USE_FUSED_UPSAMPLE_HEAD
    phase(f"pipeline: camvid-bise18 AR, USE_FUSED_UPSAMPLE_HEAD={head} (not the default), "
          f"GOP 12, 720x960, bf16")
    bisenet.USE_FUSED_UPSAMPLE_HEAD = head
    models = make_models()
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    name = f"camvid-bise18 USE_FUSED_UPSAMPLE_HEAD={head}"
    preds, paths[name] = run_clip(pipe, clip, name)
    expect_launches(paths[name],
                    {"warp_bilinear": CLIP_GOPS, "creff_attention": 0, **head_launches(head)},
                    name)
    del pipe
    # with the fused head on, return_fused adds the fused feature through K1
    card_vs_cpu(models, clip, preds[0], name)
    bisenet.USE_FUSED_UPSAMPLE_HEAD = not head
    torch.cuda.empty_cache()
    return paths


def psp18_phase():
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.ops import _build

    phase("pipeline: camvid-psp18 V1 AR 0.5x, GOP 12, 720x960, bf16")
    norm = (CAMVID_MEAN, CAMVID_STD)
    models = make_models("camvid-psp18", 1)
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    preds, launches = run_clip(pipe, make_clip(CLIP_GOPS), "camvid-psp18 V1")
    expect_launches(launches, {"creff_phase2_argmax_lr": CLIP_GOPS, "creff_phase2_argmax": 0,
                               "warp_bilinear": CLIP_GOPS, "creff_qkv_fused": 0},
                    "camvid-psp18 V1")
    del pipe, preds
    torch.cuda.empty_cache()

    # a short GOP (keyframe + 2 frames): the card in float32 against the CPU
    kfs, frs, fxs, fys = make_clip(1, frames=2)
    args = (kfs, frs[0], (fxs[0], fys[0]))
    p_card = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda").gop_step(*args)
    t0 = time.perf_counter()
    p_cpu = ARPipeline(*models, scale=SCALE, normalize=norm, device="cpu").gop_step(*args)
    agree = (p_card.cpu() == p_cpu).float().mean().item()
    print(f"camvid-psp18 V1 card f32 vs CPU f32 (keyframe + 2 frames, CPU "
          f"{time.perf_counter() - t0:.1f} s): class-map agreement {agree:.6f} (>= {AGREEMENT})",
          flush=True)
    if not agree >= AGREEMENT:
        raise SystemExit("chip_smoke: the card's float32 psp18 GOP disagrees with the CPU")
    torch.cuda.empty_cache()

    phase("pipeline: camvid-psp18 V2, one GOP on the card, bf16")
    models = make_models("camvid-psp18", 2)
    v2 = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    kfs, frs, fxs, fys = (x.cuda() for x in make_clip(1))
    _build.LAUNCHES.clear()
    out = v2.gop_step(kfs, frs[0], (fxs[0], fys[0]))
    torch.cuda.synchronize()
    v2_launches = dict(_build.LAUNCHES)
    print(f"camvid-psp18 V2 GOP: {tuple(out.shape)} {out.dtype}, classes "
          f"{int(out.min())}..{int(out.max())}; launches {v2_launches}", flush=True)
    if tuple(out.shape) != (GOP, H, W) or out.dtype != torch.int32:
        raise SystemExit(f"chip_smoke: bad V2 output {tuple(out.shape)} {out.dtype}")
    if int(out.min()) < 0 or int(out.max()) >= N_CLASSES:
        raise SystemExit("chip_smoke: V2 class index out of range")
    expect_launches(v2_launches, {"creff_qkv_fused": 1, "warp_bilinear": 1,
                                  "creff_phase2_argmax": 0}, "camvid-psp18 V2")
    del v2, out
    torch.cuda.empty_cache()

    # a short GOP (keyframe + 2 frames): the card in float32 against the CPU
    kfs, frs, fxs, fys = make_clip(1, frames=2)
    args = (kfs, frs[0], (fxs[0], fys[0]))
    p_card = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda").gop_step(*args)
    t0 = time.perf_counter()
    p_cpu = ARPipeline(*models, scale=SCALE, normalize=norm, device="cpu").gop_step(*args)
    agree = (p_card.cpu() == p_cpu).float().mean().item()
    print(f"camvid-psp18 V2 card f32 vs CPU f32 (keyframe + 2 frames, CPU "
          f"{time.perf_counter() - t0:.1f} s): class-map agreement {agree:.6f} (>= {AGREEMENT})",
          flush=True)
    if not agree >= AGREEMENT:
        raise SystemExit("chip_smoke: the card's float32 psp18 V2 GOP disagrees with the CPU")
    return {"camvid-psp18 V1": launches, "camvid-psp18 V2": v2_launches}


def cityscapes_phase(backend):
    """`backend` AR 0.5x at 1024x2048 (GOP 12, bf16): scan_step over 3 GOPs
    with its launch counts (K1 and K2 once per GOP), then a short GOP
    (keyframe + 2 frames) at 512x1024 on the card in float32 against the
    CPU."""
    from arseg_tpu_torch.gop import ARPipeline

    phase(f"pipeline: {backend} AR 0.5x, GOP 12, 1024x2048, bf16")
    norm = CITY_NORM[backend]
    models = make_models(backend)
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    _, launches = run_clip(pipe, make_clip(CLIP_GOPS, hw=CITY_HW), backend, N_CLASSES_CITY)
    k1_k5 = (head_launches(None) if backend == "cityscapes-bise18"
             else {"creff_qkv_fused": CLIP_GOPS, "creff_phase2_upsample_argmax": 0})
    expect_launches(launches, {"warp_bilinear": CLIP_GOPS, "creff_phase2_argmax": 0,
                               "creff_attention": 0, **k1_k5}, backend)
    del pipe
    torch.cuda.empty_cache()
    card_vs_cpu(models, make_clip(1, frames=2, hw=CITY_SHORT_HW), None, backend, norm)
    torch.cuda.empty_cache()
    return {backend: launches}


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def multi_gop_phase(backend="camvid-bise18", fuse_version=1, expected=None,
                    name="camvid-bise18 multi-GOP"):
    """`backend`, B = 8 GOPs in one gop_step call (5-D frames): launch
    counts (`expected`; by default camvid-bise18's, K1 and K2 once for the
    step), maps against scan_step over the same GOPs in bfloat16 and in
    float32, and the ms per frame of both."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.ops import _build

    b = MULTI_GOPS
    phase(f"pipeline: {name}, B = {b} GOPs in one gop_step, GOP 12, 720x960")
    norm = (CAMVID_MEAN, CAMVID_STD)
    models = make_models(backend, fuse_version)
    expected = expected or {"creff_qkv_fused": 1, "warp_bilinear": 1, "creff_phase2_argmax": 0,
                            "creff_attention": 0, "creff_phase2_upsample_argmax": 0,
                            "resize_bilinear_backward": 0}
    kfs, frs, fxs, fys = (x.cuda() for x in make_clip(b))
    launches = None
    for dt in (torch.bfloat16, torch.float32):
        pipe = ARPipeline(*models, scale=SCALE, dtype=dt, normalize=norm, device="cuda")
        pipe.gop_step(kfs, frs, (fxs, fys))  # warm-up
        pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
        torch.cuda.synchronize()
        if launches is None:
            _build.LAUNCHES.clear()
            multi, _ = _sync_ms(lambda: pipe.gop_step(kfs, frs, (fxs, fys)))
            launches = dict(_build.LAUNCHES)
            expect_launches(launches, expected, name)
        t_multi, t_scan = [], []
        for _ in range(3):
            multi, ms = _sync_ms(lambda: pipe.gop_step(kfs, frs, (fxs, fys)))
            t_multi.append(ms)
            scan, ms = _sync_ms(lambda: pipe.scan_step(kfs, frs, fxs, fys))
            t_scan.append(ms)
        check_maps_range(multi, (b, GOP, H, W), N_CLASSES, name)
        agree = (multi == scan).float().mean().item()
        frames = b * GOP
        print(f"{name} {dt}: {float(np.median(t_multi)) / frames:.4f} ms/frame "
              f"(one gop_step of {b} GOPs, median of 3; all {[round(x, 3) for x in t_multi]} ms) "
              f"against scan_step {float(np.median(t_scan)) / frames:.4f} ms/frame (all "
              f"{[round(x, 3) for x in t_scan]} ms); maps agree {agree:.6f} "
              f"(>= {MULTI_AGREEMENT[dt]}); launches {launches}", flush=True)
        if not agree >= MULTI_AGREEMENT[dt]:
            raise SystemExit(f"chip_smoke: {name} maps disagree with scan_step in {dt}")
        del pipe, multi, scan
        torch.cuda.empty_cache()
    return {name: launches}


def psp18_multi_gop_phase():
    """camvid-psp18 V1, 8 GOPs in one gop_step: its 88 LR frames at
    720x960x64 pass 2^31 elements, so K3's LR form runs over two chunks of
    44 frames (twice, full-size K3 never, K2 once, K1 never), held against
    scan_step, whose GOPs run it once each."""
    from arseg_tpu_torch.nn.functional import frame_chunks

    chunks = len(frame_chunks(MULTI_GOPS * (GOP - 1), H * W * C_PSP))
    return multi_gop_phase("camvid-psp18", 1, {
        "creff_phase2_argmax_lr": chunks, "creff_phase2_argmax": 0, "warp_bilinear": 1,
        "creff_qkv_fused": 0,
        "creff_attention": 0, "creff_phase2_upsample_argmax": 0, "resize_bilinear_backward": 0},
        "camvid-psp18 V1 multi-GOP")


def semseg_multi_gop_phase():
    """cityscapes-psp18, 8 GOPs in one gop_step at 1024x2048: its 88 LR
    frames' 19-class logits at 1024x2048 pass 2^31 elements, so the
    pipeline's resize-and-argmax head runs over two chunks of 44 frames
    (two ``gop.head_chunk`` spans; K1 and K2 once), held against
    scan_step, whose GOPs take one chunk each. In float32 the maps agree
    >= MULTI_AGREEMENT. In bfloat16 this model's random weights leave many
    near ties (the benchmark's bf16 reference picks another class than its
    float32 one on 0.1-2.8% of pixels), so there the 8-GOP maps must lie
    no further from the float32 step's than scan_step's do, within
    SEMSEG_BF16_SLACK: a wrong chunk or frame would move a share of the
    maps far larger."""
    from torch.profiler import ProfilerActivity, profile

    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.nn.functional import frame_chunks
    from arseg_tpu_torch.ops import _build

    b, name = MULTI_GOPS, "cityscapes-psp18 multi-GOP"
    phase(f"pipeline: {name}, B = {b} GOPs in one gop_step, GOP 12, 1024x2048")
    chunks = len(frame_chunks(b * (GOP - 1), N_CLASSES_CITY * CITY_HW[0] * CITY_HW[1]))
    if chunks != 2:
        raise SystemExit(f"chip_smoke: {name}: {chunks} head chunks, expected 2")
    models = make_models("cityscapes-psp18")
    kfs, frs, fxs, fys = (x.cuda() for x in make_clip(b, hw=CITY_HW))
    launches, maps = None, {}
    for dt in (torch.bfloat16, torch.float32):
        pipe = ARPipeline(*models, scale=SCALE, dtype=dt, normalize=CITY_NORM["cityscapes-psp18"],
                          device="cuda")
        torch.cuda.reset_peak_memory_stats()
        pipe.gop_step(kfs, frs, (fxs, fys))  # warm-up
        pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
        torch.cuda.synchronize()
        if launches is None:
            _build.LAUNCHES.clear()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                pipe.gop_step(kfs, frs, (fxs, fys))
            launches = dict(_build.LAUNCHES)
            expect_launches(launches, {
                "creff_qkv_fused": 1, "warp_bilinear": 1, "creff_phase2_argmax": 0,
                "creff_phase2_argmax_lr": 0, "creff_attention": 0,
                "creff_phase2_upsample_argmax": 0, "resize_bilinear_backward": 0}, name)
            spans = [e.name for e in prof.events()].count("gop.head_chunk")
            if spans != chunks:
                raise SystemExit(f"chip_smoke: {name}: {spans} gop.head_chunk spans, "
                                 f"expected {chunks}")
        t_multi = []
        for _ in range(3):
            multi, ms = _sync_ms(lambda: pipe.gop_step(kfs, frs, (fxs, fys)))
            t_multi.append(ms)
        scan, t_scan = _sync_ms(lambda: pipe.scan_step(kfs, frs, fxs, fys))
        check_maps_range(multi, (b, GOP, *CITY_HW), N_CLASSES_CITY, name)
        maps[dt] = (multi, scan)
        agree = (multi == scan).float().mean().item()
        frames = b * GOP
        print(f"{name} {dt}: {float(np.median(t_multi)) / frames:.4f} ms/frame (one gop_step of "
              f"{b} GOPs, median of 3; all {[round(x, 3) for x in t_multi]} ms) against "
              f"scan_step {t_scan / frames:.4f} ms/frame; maps agree {agree:.6f}; head chunks "
              f"{chunks}; launches {launches}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        del pipe
        torch.cuda.empty_cache()
    f32_multi, f32_scan = maps[torch.float32]
    agree = (f32_multi == f32_scan).float().mean().item()
    near = {k: (m == f32_multi).float().mean().item()
            for k, m in zip(("gop_step", "scan_step"), maps[torch.bfloat16])}
    print(f"{name}: float32 maps agree {agree:.6f} (>= {MULTI_AGREEMENT[torch.float32]}); "
          f"bfloat16 maps agree with the float32 gop_step's: gop_step {near['gop_step']:.6f}, "
          f"scan_step {near['scan_step']:.6f} (gop_step >= scan_step - {SEMSEG_BF16_SLACK})",
          flush=True)
    if not agree >= MULTI_AGREEMENT[torch.float32]:
        raise SystemExit(f"chip_smoke: {name} maps disagree with scan_step in float32")
    if not near["gop_step"] >= near["scan_step"] - SEMSEG_BF16_SLACK:
        raise SystemExit(f"chip_smoke: {name} bfloat16 maps lie further from float32 than "
                         "scan_step's")
    del maps, f32_multi, f32_scan, kfs, frs, fxs, fys
    torch.cuda.empty_cache()
    return {name: launches}


def streaming_phase(smi):
    """camvid-bise18 served a frame a call: one GOP as key_step + 11
    frame_step calls against gop_step on the same GOP (float32), then the
    median ms per frame_step in bfloat16 over 3 GOPs, with its launch
    counts (K1 and K2 once per frame_step)."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.ops import _build

    phase("pipeline: camvid-bise18 streaming, key_step + 11 frame_step calls a GOP, 720x960")
    norm = (CAMVID_MEAN, CAMVID_STD)
    models = make_models()
    kfs, frs, fxs, fys = (x.cuda() for x in make_clip(1))

    def serve(pipe, times=None):
        key_step, frame_step = pipe.streaming_step()
        kmap, ref = key_step(kfs[:1])
        maps = [kmap]
        for i in range(GOP - 1):
            args = (ref, frs[0, i : i + 1], (fxs[0, i : i + 1], fys[0, i : i + 1]))
            out, ms = _sync_ms(lambda: frame_step(*args))
            maps.append(out)
            if times is not None:
                times.append(ms)
        return torch.cat(maps)

    pipe = ARPipeline(*models, scale=SCALE, normalize=norm, device="cuda")
    maps = serve(pipe)
    gop = pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
    check_maps_range(maps, (GOP, H, W), N_CLASSES, "camvid-bise18 streaming")
    agree = (maps == gop).float().mean().item()
    print(f"camvid-bise18 streaming float32: maps against gop_step agree {agree:.6f} "
          f"(>= {STREAM_AGREEMENT})", flush=True)
    if not agree >= STREAM_AGREEMENT:
        raise SystemExit("chip_smoke: streaming maps disagree with gop_step")
    del pipe
    pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm, device="cuda")
    serve(pipe)  # warm-up
    times = []
    _build.LAUNCHES.clear()
    for _ in range(STREAM_REPEATS):
        serve(pipe, times)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    per_frame = STREAM_REPEATS * (GOP - 1)
    expect_launches(launches, {"creff_qkv_fused": per_frame, "warp_bilinear": per_frame,
                               "creff_phase2_argmax": 0, "creff_attention": 0,
                               "creff_phase2_upsample_argmax": 0}, "camvid-bise18 streaming")
    print(f"camvid-bise18 streaming bf16: frame_step median {float(np.median(times)):.3f} ms "
          f"(host clock around synchronised calls, {len(times)} calls, range "
          f"{min(times):.3f}-{max(times):.3f}) on {smi}; launches {launches}", flush=True)
    del pipe
    torch.cuda.empty_cache()
    return {"camvid-bise18 streaming": launches}


def make_eval_batches(batches, per_batch, hw, seed=0):
    """Seeded normalised images and keyframes, labels with about 5% of
    pixels at the ignore label, flows uniform(-16, 16) [..., 2]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(batches):
        label = rng.randint(0, N_CLASSES, (per_batch, *hw))
        label[rng.rand(per_batch, *hw) < 0.05] = IGNORE
        out.append(dict(image=rng.randn(per_batch, *hw, 3).astype(np.float32),
                        label=label.astype(np.int32),
                        ref_image=rng.randn(per_batch, *hw, 3).astype(np.float32),
                        flow=rng.uniform(-16, 16, (per_batch, *hw, 2)).astype(np.float32)))
    return out


def eval_phase():
    """EvalConstRes (0.5x) and EvalAlterRes for camvid-bise18 at 720x960, 4
    batches of 2 frames, bf16: each histogram counts every scored pixel
    exactly, with the launch counts of the AR engine (K1 and K2 once per
    batch, K2 with one source per frame); then both engines at 256x320, 2
    batches, in float32 on the card against the CPU: the class maps, the
    histograms and the mIoU."""
    from arseg_tpu_torch.eval import (EvalAlterRes, EvalConstRes, confusion_update,
                                      miou_from_hist)
    from arseg_tpu_torch.ops import _build

    phase("eval: EvalConstRes (0.5x) and EvalAlterRes, camvid-bise18, 720x960, 4 batches of 2, "
          "bf16")
    hr, lr = make_models()
    loader = make_eval_batches(EVAL_BATCHES, EVAL_BATCH, (H, W))
    scored = sum(int((b["label"] != IGNORE).sum()) for b in loader)
    launches = None
    for name, engine, models in (("EvalConstRes", EvalConstRes, (hr,)),
                                 ("EvalAlterRes", EvalAlterRes, (hr, lr))):
        eng = engine(scale=SCALE, dtype=torch.bfloat16, device="cuda")
        eng.histogram(*models, loader[:1], N_CLASSES)  # warm-up
        _build.LAUNCHES.clear()
        hist, ms = _sync_ms(lambda: eng.histogram(*models, loader, N_CLASSES))
        if name == "EvalAlterRes":
            launches = dict(_build.LAUNCHES)
            expect_launches(launches, {"creff_qkv_fused": EVAL_BATCHES,
                                       "warp_bilinear": EVAL_BATCHES}, "EvalAlterRes")
        total = int(hist.sum())
        print(f"{name} bf16: {EVAL_BATCHES} batches in {ms:.1f} ms, histogram sum {total} "
              f"(scored pixels {scored}), mIoU {float(miou_from_hist(hist.cpu())):.6f} "
              f"(random weights)", flush=True)
        if total != scored or hist.dtype != torch.int64:
            raise SystemExit(f"chip_smoke: {name}'s histogram does not count every scored pixel")
    print(f"EvalAlterRes launches {launches}", flush=True)

    small = make_eval_batches(2, EVAL_BATCH, EVAL_SMALL_HW, seed=1)
    scored = sum(int((b["label"] != IGNORE).sum()) for b in small)
    for name, engine, models in (("EvalConstRes", EvalConstRes, (hr,)),
                                 ("EvalAlterRes", EvalAlterRes, (hr, lr))):
        maps, hists = [], []
        for device in ("cuda", "cpu"):
            pairs = list(engine(scale=SCALE, device=device).predictions(*models, small))
            hist = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int64)
            for label, pred in pairs:
                hist = confusion_update(hist, label.cpu(), pred.cpu(), N_CLASSES, IGNORE)
            maps.append(torch.cat([pred.cpu().flatten() for _, pred in pairs]))
            hists.append(hist)
        agree = (maps[0] == maps[1]).float().mean().item()
        card, cpu = hists
        dmiou = abs(float(miou_from_hist(card)) - float(miou_from_hist(cpu)))
        dcell = int((card - cpu).abs().max())
        print(f"{name} card f32 vs CPU f32 at {EVAL_SMALL_HW}, 2 batches: class maps agree "
              f"{agree:.6f} (>= {AGREEMENT}), mIoU |d| {dmiou:.3e} (<= {MIOU_TOL}), largest "
              f"histogram cell |d| {dcell} (<= {HIST_CELL_TOL} x {scored} scored pixels)",
              flush=True)
        if not (agree >= AGREEMENT and dmiou <= MIOU_TOL and dcell <= HIST_CELL_TOL * scored):
            raise SystemExit(f"chip_smoke: {name} on the card disagrees with the CPU")
    torch.cuda.empty_cache()
    return {"EvalAlterRes camvid-bise18": launches}


def train_models():
    """camvid-bise18's teacher (the fused class in eval mode, BN statistics
    randomised) and student (fused, its final conv copied from the
    teacher's), on the CPU, weights from seeded generators."""
    from arseg_tpu_torch.nn.init import randomize_bn_
    from arseg_tpu_torch.train.trainer import (FINAL_CONV_PATH, build_train_model,
                                               graft_final_conv)

    teacher = build_train_model("bisenet", "camvid", "resnet18", N_CLASSES, fuse=True, seed=0)
    randomize_bn_(teacher, torch.Generator().manual_seed(100))
    student = build_train_model("bisenet", "camvid", "resnet18", N_CLASSES, fuse=True, seed=1)
    graft_final_conv(student, teacher, FINAL_CONV_PATH[("bisenet", "camvid")])
    return teacher, student


def train_batch(n, hw, seed):
    """A batch as the CamVid readers give it: seeded uint8 frames and
    keyframes normalised with the CamVid mean and std, labels with about 5%
    of pixels at the ignore label, the class-presence vector, and flows
    uniform(-16, 16) at the frames' size."""
    rng = np.random.RandomState(seed)
    mean, std = np.float32(CAMVID_MEAN), np.float32(CAMVID_STD)

    def frames():
        return ((rng.randint(0, 256, (n, *hw, 3), dtype=np.uint8) / np.float32(255.0) - mean)
                / std).astype(np.float32)

    label = rng.randint(0, N_CLASSES, (n, *hw)).astype(np.int32)
    label[rng.rand(n, *hw) < 0.05] = IGNORE
    existence = np.stack([np.isin(np.arange(N_CLASSES), lb).astype(np.float32) for lb in label])
    return dict(image=frames(), label=label, existence=existence, ref_image=frames(),
                flow=rng.uniform(-16, 16, (n, *hw, 2)).astype(np.float32))


def _optimizer(student, kind):
    """Adam or SGD on the cosine schedule over the student's trainable
    parameters, FST's final conv frozen."""
    from arseg_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from arseg_tpu_torch.train.step import trainable_parameters
    from arseg_tpu_torch.train.trainer import FINAL_CONV_PATH

    params = trainable_parameters(student, (FINAL_CONV_PATH[("bisenet", "camvid")],))
    return make_optimizer(kind, cosine_schedule(TRAIN_LR, 1000), params)


def _step(opt, stage2, compute_dtype, device, hw, mesh=None, bn_mode="sync"):
    """The trainers' camvid-bise18 phase-2 step of one stage on `device`
    (over a data-parallel group with `mesh`)."""
    from arseg_tpu_torch.train.objectives import build_phase2_loss
    from arseg_tpu_torch.train.step import make_train_step

    loss_fn = build_phase2_loss("bisenet", "camvid", (hw[1], hw[0]), SCALE, stage2=stage2)
    return make_train_step(loss_fn, opt, mesh=mesh, bn_mode=bn_mode, compute_dtype=compute_dtype,
                           device=device)


def _float_state(opt):
    return [v for st in opt.optimizer.state.values() for v in st.values()
            if torch.is_tensor(v) and v.is_floating_point()]


def train_steps_phase(smi):
    """bf16 steps at full width: 2 stage-1 then 4 stage-2 Adam steps of
    camvid-bise18 at 720x960, batch 16, on one repeated batch, with the
    launch counts of each stage, the median ms per step, the peak device
    memory, and the float32 master state and frozen final conv checked;
    then the time of K1's backward (K1B) at the step's shape, beside its
    bound and autograd over the composed module (what the backward was
    before K1B)."""
    import copy

    from arseg_tpu_torch.ops import _build
    from arseg_tpu_torch.ops.local_attention import creff_local_module, module_composed
    from arseg_tpu_torch.train.step import teacher_copy

    phase(f"training: camvid-bise18 phase 2, {TRAIN_STEPS[0]} stage-1 then {TRAIN_STEPS[1]} "
          f"stage-2 Adam steps, bf16, batch {TRAIN_BATCH}, {TRAIN_HW[0]}x{TRAIN_HW[1]}")
    teacher_cpu, student_cpu = train_models()
    student = copy.deepcopy(student_cpu).to("cuda", memory_format=torch.channels_last)
    teacher = teacher_copy(teacher_cpu, "cuda", torch.bfloat16)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in train_batch(TRAIN_BATCH, TRAIN_HW, seed=2).items()}
    losses, ms, launches = {}, {}, {}
    opt = _optimizer(student, "adam")  # one optimizer through both stages, as the trainer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for stage, steps in ((1, TRAIN_STEPS[0]), (2, TRAIN_STEPS[1])):
        step = _step(opt, stage == 2, torch.bfloat16, "cuda", TRAIN_HW)
        _build.LAUNCHES.clear()
        losses[stage], ms[stage] = [], []
        for _ in range(steps):
            metrics, t = _sync_ms(lambda: step(student, teacher, batch))
            losses[stage].append(float(metrics["loss"]))
            ms[stage].append(t)
        launches[stage] = dict(_build.LAUNCHES)
        print(f"stage {stage}: losses {losses[stage]}, ms per step {ms[stage]}, launches "
              f"{launches[stage]}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_launches(launches[1], {"creff_qkv_fused": 0, "creff_qkv_fused_backward": 0,
                                  "warp_bilinear": 0,
                                  "resize_bilinear_backward": RESIZE_LAUNCHES[1] * TRAIN_STEPS[0]},
                    "training stage 1")
    expect_launches(launches[2], {"creff_qkv_fused": TRAIN_STEPS[1],
                                  "creff_qkv_fused_backward": TRAIN_STEPS[1],
                                  "warp_bilinear": TRAIN_STEPS[1],
                                  "resize_bilinear_backward": RESIZE_LAUNCHES[2] * TRAIN_STEPS[1]},
                    "training stage 2")
    if not all(np.isfinite(losses[1] + losses[2])):
        raise SystemExit("chip_smoke: a training loss is not finite")
    if not losses[2][-1] < losses[2][0]:
        raise SystemExit(f"chip_smoke: the stage-2 loss did not fall over {TRAIN_STEPS[1]} steps")
    masters = [p for p in student.parameters()] + [b for b in student.buffers()
                                                   if b.is_floating_point()]
    if any(t.dtype != torch.float32 for t in masters + _float_state(opt)):
        raise SystemExit("chip_smoke: training master state is not float32")
    fc = student.final_conv
    if not (torch.equal(fc.weight.cpu(), teacher_cpu.final_conv.weight)
            and torch.equal(fc.bias.cpu(), teacher_cpu.final_conv.bias)):
        raise SystemExit("chip_smoke: the frozen final conv moved")

    # K1's backward (K1B) at the stage-2 step's shape (the student's fusion
    # at [16, 90, 120, 256], bf16, ref the teacher's warped feature under
    # no_grad): forward + backward less forward; the yardstick, autograd
    # over the composed module (its forward and backward), is what the
    # module's backward ran before K1B
    gen = torch.Generator(device="cuda").manual_seed(3)
    fa = student.fuse_attention
    wb = [t.detach().to(torch.bfloat16).requires_grad_(True) for conv in
          (fa.lr_query_conv, fa.hr_key_conv, fa.hr_value_conv) for t in (conv.weight, conv.bias)]
    shape = (TRAIN_BATCH, *FEAT_HW, C)
    lr_up, ref, g = (torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
                     for _ in range(3))
    lr_up.requires_grad_(True)
    fwd = median_ms(lambda: creff_local_module(lr_up, ref, *wb, 7, 7), runs=5)
    _build.LAUNCHES.clear()
    both = median_ms(lambda: torch.autograd.backward(creff_local_module(lr_up, ref, *wb, 7, 7), g),
                     runs=5)
    if _build.LAUNCHES["creff_qkv_fused_backward"] != _build.LAUNCHES["creff_qkv_fused"]:
        raise SystemExit("chip_smoke: the module's backward did not launch K1B once a call")
    composed = median_ms(lambda: torch.autograd.grad(module_composed(lr_up, ref, *wb, 7, 7),
                                                     [lr_up, *wb], g), runs=3)
    k1b_bound = 4 * lr_up.numel() * lr_up.element_size() / HBM_BYTES_PER_S * 1e3
    # a stage's first step pays one-time costs (cuDNN set-up, the first
    # use of each kernel); the median is of the steps after it
    step_ms = {stage: float(np.median(ms[stage][1:])) for stage in ms}
    print(f"training bf16 batch {TRAIN_BATCH} {TRAIN_HW}: median ms per step after the first, "
          f"stage 1 {step_ms[1]:.3f}, stage 2 {step_ms[2]:.3f}; peak device memory {peak:.3f} GiB; K1 "
          f"at {list(shape)}: forward {fwd:.3f} ms, backward (K1B) {both - fwd:.3f} ms "
          f"({(both - fwd) / step_ms[2]:.3f} of a stage-2 step; bound {k1b_bound:.4f} ms; "
          f"autograd over the composed module {composed:.3f} ms); losses fall "
          f"{losses[2][0]:.5f} -> {losses[2][-1]:.5f}; on {smi}", flush=True)
    del student, teacher, batch
    torch.cuda.empty_cache()
    return {"camvid-bise18 training stage 1": launches[1],
            "camvid-bise18 training stage 2": launches[2]}, step_ms[2]


def _one_step(teacher_cpu, student_cpu, batch, stage2, device, dtype, mesh=None,
              bn_mode="sync"):
    """One SGD step of copies of the models on `device` in `dtype` (float32
    or float64), over `mesh` if given: (loss, gradients, BN running
    statistics), on the CPU."""
    import copy

    from arseg_tpu_torch.train.step import teacher_copy

    student = copy.deepcopy(student_cpu).to(device, dtype)
    if device == "cuda":
        student = student.to(memory_format=torch.channels_last)
    teacher = teacher_copy(teacher_cpu, device, dtype)
    step = _step(_optimizer(student, "sgd"), stage2, None, device, PARITY_HW, mesh, bn_mode)
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    for k in ("image", "ref_image"):
        b[k] = b[k].to(dtype)
    loss = float(step(student, teacher, b)["loss"])
    grads = {n: p.grad.double().cpu() for n, p in student.named_parameters()
             if p.grad is not None}
    stats = {n: t.double().cpu() for n, t in student.named_buffers() if "running" in n}
    return loss, grads, stats


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def train_parity_phase():
    """One SGD step of each stage at 128x160, batch 2, float32 on the card
    against the CPU from the same weights and batch (and the CPU in float64
    for the float32 gradients' own error): the loss, every gradient, the
    BN running statistics after the step."""
    phase(f"training: the card (float32) against the CPU, one SGD step of each stage at "
          f"{PARITY_HW[0]}x{PARITY_HW[1]}, batch {PARITY_BATCH}")
    teacher_cpu, student_cpu = train_models()
    batch = train_batch(PARITY_BATCH, PARITY_HW, seed=4)
    for stage2 in (False, True):
        card = _one_step(teacher_cpu, student_cpu, batch, stage2, "cuda", torch.float32)
        cpu = _one_step(teacher_cpu, student_cpu, batch, stage2, "cpu", torch.float32)
        f64 = _one_step(teacher_cpu, student_cpu, batch, stage2, "cpu", torch.float64)
        dloss = abs(card[0] - cpu[0]) / abs(cpu[0])
        worst_grad, worst_over = (0.0, ""), []
        for n, g in cpu[1].items():
            d, err = _rel(card[1][n], g), _rel(g, f64[1][n])
            tol = max(TRAIN_GRAD_TOL, GRAD_ERR_FACTOR * err)
            worst_grad = max(worst_grad, (d, n))
            if d > tol:
                worst_over.append((n, d, tol))
        dstat = max(float((card[2][n] - s).abs().max()) / max(1.0, float(s.abs().max()))
                    for n, s in cpu[2].items())
        n_tight = sum(1 for n, g in cpu[1].items()
                      if GRAD_ERR_FACTOR * _rel(g, f64[1][n]) <= TRAIN_GRAD_TOL)
        print(f"stage {2 if stage2 else 1}: loss card {card[0]:.7f} CPU {cpu[0]:.7f} rel |d| "
              f"{dloss:.3e} (<= {TRAIN_LOSS_TOL}); gradients: largest rel L2 |d| "
              f"{worst_grad[0]:.3e} ({worst_grad[1]}), {n_tight} of {len(cpu[1])} held to "
              f"{TRAIN_GRAD_TOL}, the rest to {GRAD_ERR_FACTOR} x their float32 error; BN running "
              f"statistics after the step max |d| {dstat:.3e} (<= {TRAIN_BN_TOL})", flush=True)
        if dloss > TRAIN_LOSS_TOL or worst_over or dstat > TRAIN_BN_TOL:
            raise SystemExit(f"chip_smoke: the card's float32 training step disagrees with the "
                             f"CPU: {worst_over[:4]}")


def train_loop_phase():
    """TrainLoop.run_epoch over 3 in-memory stage-2 batches (bf16, batch 4,
    720x960), then EvalAlterRes validation of the student on 2 batches: the
    histogram counts every scored pixel."""
    import copy

    from arseg_tpu_torch.eval import EvalAlterRes
    from arseg_tpu_torch.ops import _build
    from arseg_tpu_torch.train.step import teacher_copy
    from arseg_tpu_torch.train.trainer import TrainLoop

    phase(f"training: TrainLoop.run_epoch over {TRAIN_EPOCH_BATCHES} batches of "
          f"{TRAIN_EPOCH_BATCH}, then EvalAlterRes on {TRAIN_VAL_BATCHES} batches")
    teacher_cpu, student_cpu = train_models()
    student = copy.deepcopy(student_cpu).to("cuda", memory_format=torch.channels_last)
    teacher = teacher_copy(teacher_cpu, "cuda", torch.bfloat16)
    step = _step(_optimizer(student, "adam"), True, torch.bfloat16, "cuda", TRAIN_HW)
    loader = [train_batch(TRAIN_EPOCH_BATCH, TRAIN_HW, seed=10 + i)
              for i in range(TRAIN_EPOCH_BATCHES)]
    _build.LAUNCHES.clear()
    mean_loss, t = _sync_ms(lambda: TrainLoop("cuda", verbose=False).run_epoch(
        step, student, teacher, loader, 0))
    launches = dict(_build.LAUNCHES)
    expect_launches(launches, {"creff_qkv_fused": TRAIN_EPOCH_BATCHES,
                               "creff_qkv_fused_backward": TRAIN_EPOCH_BATCHES,
                               "warp_bilinear": TRAIN_EPOCH_BATCHES,
                               "resize_bilinear_backward":
                                   RESIZE_LAUNCHES[2] * TRAIN_EPOCH_BATCHES}, "TrainLoop")
    if not np.isfinite(mean_loss) or not student.training:
        raise SystemExit("chip_smoke: TrainLoop.run_epoch failed")
    val = make_eval_batches(TRAIN_VAL_BATCHES, EVAL_BATCH, (H, W), seed=5)
    scored = sum(int((b["label"] != IGNORE).sum()) for b in val)
    hist = EvalAlterRes(scale=SCALE, dtype=torch.bfloat16, device="cuda").histogram(
        teacher_cpu, student, val, N_CLASSES)
    print(f"TrainLoop: {TRAIN_EPOCH_BATCHES} steps in {t:.1f} ms, mean loss {mean_loss:.5f}, "
          f"launches {launches}; EvalAlterRes histogram sum {int(hist.sum())} (scored pixels "
          f"{scored})", flush=True)
    if int(hist.sum()) != scored:
        raise SystemExit("chip_smoke: validation's histogram does not count every scored pixel")
    del student, teacher
    torch.cuda.empty_cache()
    return launches


def checkpoint_phase():
    """save_checkpoint after two bf16 Adam steps at 256x320, then
    load_checkpoint into a fresh model and a fresh optimizer: every tensor
    bit-equal."""
    import copy
    import tempfile

    from arseg_tpu_torch.train.step import teacher_copy
    from arseg_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    phase("training: checkpoint round trip")
    teacher_cpu, student_cpu = train_models()
    student = copy.deepcopy(student_cpu).to("cuda", memory_format=torch.channels_last)
    teacher = teacher_copy(teacher_cpu, "cuda", torch.bfloat16)
    hw = EVAL_SMALL_HW
    opt = _optimizer(student, "adam")
    step = _step(opt, True, torch.bfloat16, "cuda", hw)
    batch = train_batch(PARITY_BATCH, hw, seed=6)
    for _ in range(2):
        step(student, teacher, batch)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/PSPNet_resnet18_{SCALE}_1_.pth"
        save_checkpoint(path, student, opt, dict(epoch=1, miou=0.5))
        ck = load_checkpoint(path)
    fresh = copy.deepcopy(student_cpu).to("cuda", memory_format=torch.channels_last)
    fresh.load_state_dict(ck["state_dict"], strict=True)
    fresh_opt = _optimizer(fresh, "adam")
    fresh_opt.load_state_dict(ck["optimizer"])
    sd, fresh_sd = student.state_dict(), fresh.state_dict()
    pairs = [(sd[k], fresh_sd[k]) for k in sd]
    st, fresh_st = opt.state_dict()["state"], fresh_opt.state_dict()["state"]
    pairs += [(st[i][k], fresh_st[i][k]) for i in st for k in st[i]]
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in pairs)
    print(f"checkpoint: {len(pairs)} tensors, bit-equal {same}, updates "
          f"{fresh_opt.updates} (saved {opt.updates}), metadata {ck['metadata']}", flush=True)
    if not same or fresh_opt.updates != opt.updates:
        raise SystemExit("chip_smoke: the checkpoint round trip changed a tensor")


def training_phase(smi):
    """The training path: bf16 steps at full width, the card against the
    CPU, the epoch loop with validation, the checkpoint round trip."""
    launches, stage2_ms = train_steps_phase(smi)
    train_parity_phase()
    launches["camvid-bise18 TrainLoop"] = train_loop_phase()
    checkpoint_phase()
    return launches, stage2_ms


def _counted(fn):
    """fn() with every launch count set to 0 just before and read just
    after: (its result, the launches)."""
    from arseg_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES)


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    return total


def _stats_delta(a, b):
    return max(float((a[n] - s).abs().max()) / max(1.0, float(s.abs().max())) for n, s in b.items())


def _cuda_batch(batch):
    return {k: torch.as_tensor(v).cuda() for k, v in batch.items()}


def _maps_agree(got, want, dt, name):
    agree = (got.cpu() == want.cpu()).float().mean().item()
    print(f"{name} {str(dt)[6:]}: maps agree {agree:.6f} (>= {MULTI_AGREEMENT[dt]}), bit-equal "
          f"{torch.equal(got.cpu(), want.cpu())}", flush=True)
    if agree < MULTI_AGREEMENT[dt]:
        raise SystemExit(f"chip_smoke: {name} in {dt} disagrees with gop_step")


def dp_one_rank_phase():
    """(a) an nccl group of one rank through every data-parallel entry
    point, each against its one-process path."""
    import torch.distributed as dist

    from arseg_tpu_torch.eval import EvalAlterRes, EvalConstRes
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.parallel import data_group

    phase("data parallel (a): an nccl group of one rank against the one-process paths")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    launches = {}
    try:
        # the device as users give it: none, or "cuda" without an index
        devices = {d: data_group(device=d).device for d in (None, "cuda", "cuda:0")}
        print(f"data_group devices {devices}", flush=True)
        if set(devices.values()) != {torch.device("cuda", 0)}:
            raise SystemExit(f"chip_smoke: data_group's devices {devices}")
        group = data_group(device="cuda")
        teacher_cpu, student_cpu = train_models()
        batch = train_batch(DP_PARITY_BATCH, PARITY_HW, seed=4)
        for mode in ("sync", "master"):
            (got, step_launches) = _counted(lambda: _one_step(
                teacher_cpu, student_cpu, batch, True, "cuda", torch.float32, group, mode))
            _add(launches, step_launches)
            want, again = (_one_step(teacher_cpu, student_cpu, batch, True, "cuda", torch.float32)
                           for _ in range(2))
            dgrad = max(_rel(got[1][n], g) for n, g in want[1].items())
            spread = max(_rel(again[1][n], g) for n, g in want[1].items())
            over = [(n, d) for n, g in want[1].items() if (d := _rel(got[1][n], g)) > max(
                DP_SAME_GRAD_TOL, DP_SPREAD_FACTOR * _rel(again[1][n], g))]
            same = sum(torch.equal(got[1][n], g) for n, g in want[1].items())
            stats_same = all(torch.equal(got[2][n], t) for n, t in want[2].items())
            print(f"{mode} step over 1 rank: loss {got[0]:.7f} vs {want[0]:.7f}, BN statistics "
                  f"bit-equal {stats_same}, gradients bit-equal {same} of {len(want[1])}, largest "
                  f"rel L2 |d| {dgrad:.3e} against the one-process step's own {spread:.3e} "
                  f"between two calls; over max({DP_SAME_GRAD_TOL}, {DP_SPREAD_FACTOR} x that): "
                  f"{over[:4]}", flush=True)
            if got[0] != want[0] or not stats_same or over:
                raise SystemExit(f"chip_smoke: the one-rank {mode} step differs from the "
                                 "one-process step")
        loop_losses, n = dp_train_loop(teacher_cpu, student_cpu, group)
        _add(launches, n)
        hr, lr = make_models()
        kfs, frs, fxs, fys = (x.cuda() for x in make_clip(DP_STREAMS))
        pipe = ARPipeline(hr, lr, SCALE, dtype=torch.bfloat16,
                          normalize=(CAMVID_MEAN, CAMVID_STD), device="cuda")
        want_streams = pipe.multi_gop_step(kfs, frs, (fxs, fys))
        want = pipe.gop_step(kfs[:1], frs[0], (fxs[0], fys[0]))
        got, n = _counted(lambda: pipe.sharded_step(group)(kfs, frs, fxs, fys))
        _add(launches, n)
        got2, n = _counted(lambda: pipe.gop_parallel_step(group)(kfs[:1], frs[0],
                                                                 (fxs[0], fys[0])))
        _add(launches, n)
        loader = make_eval_batches(2, EVAL_BATCH, (H, W), seed=7)
        hists = {}
        for name, engine, models in (("EvalConstRes", EvalConstRes, (hr,)),
                                     ("EvalAlterRes", EvalAlterRes, (hr, lr))):
            one = engine(scale=SCALE, dtype=torch.bfloat16, device="cuda")
            grouped = engine(scale=SCALE, dtype=torch.bfloat16, mesh=group)
            hist, n = _counted(lambda: grouped.histogram(*models, loader, N_CLASSES))
            _add(launches, n)
            hists[name] = torch.equal(hist, one.histogram(*models, loader, N_CLASSES))
        same = {"TrainLoop": _rel_scalar(*loop_losses) <= DP_LOOP_LOSS_TOL,
                "sharded_step": torch.equal(got, want_streams),
                "gop_parallel_step": torch.equal(got2, want), **hists}
        print(f"one rank, bf16, 720x960: bit-equal to the one-process path {same}; launches "
              f"{launches}", flush=True)
        if not all(same.values()):
            raise SystemExit("chip_smoke: a one-rank data-parallel path differs from its "
                             "one-process path")
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


def _rel_scalar(a, b):
    return abs(a - b) / abs(b)


def dp_train_loop(teacher_cpu, student_cpu, group):
    """TrainLoop with ``mesh=group`` over DP_LOOP_BATCHES float32 stage-2
    SGD batches at PARITY_HW (the step built with ``mesh=group`` and the
    device "cuda"), and the one-process TrainLoop over the same batches
    from the same models. Returns ((its mean loss, the one-process one),
    its launches)."""
    import copy

    from arseg_tpu_torch.train.step import teacher_copy
    from arseg_tpu_torch.train.trainer import TrainLoop

    loader = [train_batch(DP_PARITY_BATCH, PARITY_HW, seed=20 + i)
              for i in range(DP_LOOP_BATCHES)]

    def run(mesh):
        student = copy.deepcopy(student_cpu).to("cuda", memory_format=torch.channels_last)
        teacher = teacher_copy(teacher_cpu, "cuda", torch.float32)
        step = _step(_optimizer(student, "sgd"), True, None, "cuda", PARITY_HW, mesh)
        loop = TrainLoop(verbose=False, mesh=mesh) if mesh else TrainLoop("cuda", verbose=False)
        return loop.run_epoch(step, student, teacher, loader, 0)

    got, launches = _counted(lambda: run(group))
    want = run(None)
    expect_launches(launches, {"creff_qkv_fused": DP_LOOP_BATCHES,
                               "warp_bilinear": DP_LOOP_BATCHES}, "one-rank TrainLoop")
    print(f"one-rank TrainLoop over {DP_LOOP_BATCHES} float32 batches of {DP_PARITY_BATCH} at "
          f"{PARITY_HW}: mean loss {got:.9f} against the one-process loop's {want:.9f}, rel |d| "
          f"{_rel_scalar(got, want):.3e} (<= {DP_LOOP_LOSS_TOL})", flush=True)
    return (got, want), launches


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_rank(rank, port, out_dir):
    """One of the DP_WORLD gloo ranks on cuda:0 (data_parallel_phase
    spawns them): runs every 2-rank check's rank side and saves what it
    got to out_dir/rank{rank}.pt."""
    import copy

    import torch.distributed as dist

    from arseg_tpu_torch import set_f32_parity_mode
    from arseg_tpu_torch.eval import EvalAlterRes
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.parallel import data_group, shard_batch
    from arseg_tpu_torch.train.step import teacher_copy

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke rank: no CUDA device")
    torch.cuda.set_device(0)
    set_f32_parity_mode()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=DP_WORLD, rank=rank)
    try:
        group = data_group(device="cuda")  # rank % the one card: cuda:0 for both
        if group.device != torch.device("cuda", 0):
            raise SystemExit(f"chip_smoke rank {rank}: data_group gave {group.device}")
        res = {}
        teacher_cpu, student_cpu = train_models()
        # the sync-BN stage-2 step at full width, bf16, global batch TRAIN_BATCH
        student = copy.deepcopy(student_cpu).to("cuda", memory_format=torch.channels_last)
        teacher = teacher_copy(teacher_cpu, "cuda", torch.bfloat16)
        batch = _cuda_batch(shard_batch(train_batch(TRAIN_BATCH, TRAIN_HW, seed=2), group))
        step = _step(_optimizer(student, "adam"), True, torch.bfloat16, "cuda", TRAIN_HW, group)
        losses, ms = [], []

        def run_steps():
            for _ in range(DP_STEPS):
                metrics, t = _sync_ms(lambda: step(student, teacher, batch))
                losses.append(float(metrics["loss"]))
                ms.append(t)

        _, launches = _counted(run_steps)
        res["bf16"] = dict(losses=losses, ms=ms, launches=launches,
                           peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        del student, teacher, batch
        torch.cuda.empty_cache()
        # float32 steps at PARITY_HW, global batch DP_PARITY_BATCH
        full = train_batch(DP_PARITY_BATCH, PARITY_HW, seed=4)
        for mode in ("sync", "master"):
            res[mode] = _one_step(teacher_cpu, student_cpu, shard_batch(full, group), True,
                                  "cuda", torch.float32, group, mode)
        # serving: sharded_step and gop_parallel_step, then EvalAlterRes
        hr, lr = make_models()
        kfs, frs, fxs, fys = (x.cuda() for x in make_clip(DP_STREAMS))
        for dt in (torch.float32, torch.bfloat16):
            pipe = ARPipeline(hr, lr, SCALE, dtype=dt, normalize=(CAMVID_MEAN, CAMVID_STD),
                              device="cuda")
            sharded, n1 = _counted(lambda: pipe.sharded_step(group)(kfs, frs, fxs, fys))
            gop, n2 = _counted(lambda: pipe.gop_parallel_step(group)(kfs[:1], frs[0],
                                                                     (fxs[0], fys[0])))
            res[f"serving {dt}"] = dict(sharded=sharded.to(torch.uint8).cpu(),
                                        gop=gop.to(torch.uint8).cpu(), sharded_launches=n1,
                                        gop_launches=n2)
            del pipe
        loader = make_eval_batches(EVAL_BATCHES, EVAL_BATCH, (H, W), seed=8)
        hist, launches = _counted(lambda: EvalAlterRes(scale=SCALE, mesh=group).histogram(
            hr, lr, loader, N_CLASSES))
        res["eval"] = dict(hist=hist.cpu(), launches=launches)
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def data_parallel_phase(smi, one_rank_ms):
    """(a) then (b) of the module docstring's phase 12. Returns the launch
    counts of the data-parallel paths (the spawned ranks' summed)."""
    import multiprocessing
    import tempfile

    from arseg_tpu_torch.eval import EvalAlterRes
    from arseg_tpu_torch.gop import ARPipeline

    paths = {"camvid-bise18 data parallel, one nccl rank": dp_one_rank_phase()}
    phase(f"data parallel (b): {DP_WORLD} gloo ranks on one card")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        port = _free_port()
        procs = [ctx.Process(target=dp_rank, args=(r, port, out_dir)) for r in range(DP_WORLD)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            # the one-process references, computed while the ranks run
            teacher_cpu, student_cpu = train_models()
            full = train_batch(DP_PARITY_BATCH, PARITY_HW, seed=4)
            one = _one_step(teacher_cpu, student_cpu, full, True, "cuda", torch.float32)
            f64 = _one_step(teacher_cpu, student_cpu, full, True, "cpu", torch.float64)
            rows0 = {k: v[:DP_PARITY_BATCH // DP_WORLD] for k, v in full.items()}
            rank0_rows = _one_step(teacher_cpu, student_cpu, rows0, True, "cuda", torch.float32)
            hr, lr = make_models()
            kfs, frs, fxs, fys = (x.cuda() for x in make_clip(DP_STREAMS))
            gop_maps = {}
            for dt in (torch.float32, torch.bfloat16):
                pipe = ARPipeline(hr, lr, SCALE, dtype=dt, normalize=(CAMVID_MEAN, CAMVID_STD),
                                  device="cuda")
                gop_maps[dt] = torch.stack([pipe.gop_step(kfs[i:i + 1], frs[i], (fxs[i], fys[i]))
                                            for i in range(DP_STREAMS)]).cpu()
                del pipe
            loader = make_eval_batches(EVAL_BATCHES, EVAL_BATCH, (H, W), seed=8)
            engine = EvalAlterRes(scale=SCALE, device="cuda")
            per_frame = [{k: v[i:i + 1] for k, v in b.items()} for b in loader
                         for i in range(EVAL_BATCH)]
            hist_frames = engine.histogram(hr, lr, per_frame, N_CLASSES).cpu()
            hist_batches = engine.histogram(hr, lr, loader, N_CLASSES).cpu()
            torch.cuda.empty_cache()
            for p in procs:
                p.join(timeout=max(1.0, DP_TIMEOUT - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        print(f"ranks exited {codes} after {time.perf_counter() - t0:.1f} s", flush=True)
        if codes != [0] * DP_WORLD:
            raise SystemExit(f"chip_smoke: a data-parallel rank failed or timed out: {codes}")
        ranks = [torch.load(f"{out_dir}/rank{r}.pt") for r in range(DP_WORLD)]

    # the bf16 sync-BN step at full width
    bf16 = [r["bf16"] for r in ranks]
    for r in bf16:
        expect_launches(r["launches"], {"creff_qkv_fused": DP_STEPS, "warp_bilinear": DP_STEPS},
                        "2-rank sync stage-2 step")
    losses = bf16[0]["losses"]
    if any(r["losses"] != losses for r in bf16) or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise SystemExit(f"chip_smoke: the 2-rank bf16 steps' losses {[r['losses'] for r in bf16]}")
    two_rank_ms = float(np.median(bf16[0]["ms"][1:]))
    print(f"2-rank sync-BN stage-2 step, bf16, global batch {TRAIN_BATCH} ({TRAIN_BATCH // DP_WORLD}"
          f" a rank), {TRAIN_HW[0]}x{TRAIN_HW[1]}: losses {losses}, median ms per step after the "
          f"first {two_rank_ms:.3f} (rank 1 {float(np.median(bf16[1]['ms'][1:])):.3f}) against "
          f"{one_rank_ms:.3f} for one rank at batch {TRAIN_BATCH}; peak memory a rank "
          f"{bf16[0]['peak']:.3f} GiB; both ranks share one card, so these times measure no "
          f"scaling; on {smi}", flush=True)

    # the float32 sync step against one rank, and master mode
    for r in ranks:
        got = r["sync"]
        dloss = abs(got[0] - one[0]) / abs(one[0])
        dstat = _stats_delta(got[2], one[2])
        over = [(n, d, tol) for n, g in one[1].items()
                if (d := _rel(got[1][n], g)) > (tol := max(TRAIN_GRAD_TOL,
                                                           GRAD_ERR_FACTOR * _rel(g, f64[1][n])))]
        print(f"2-rank float32 sync step at {PARITY_HW}, batch {DP_PARITY_BATCH}, against one "
              f"rank: loss rel |d| {dloss:.3e} (<= {TRAIN_LOSS_TOL}), BN statistics max |d| "
              f"{dstat:.3e} (<= {TRAIN_BN_TOL}), gradients over their bound: {over[:4]}",
              flush=True)
        if dloss > TRAIN_LOSS_TOL or dstat > TRAIN_BN_TOL or over:
            raise SystemExit("chip_smoke: the 2-rank sync step disagrees with one rank")
    master0 = ranks[0]["master"][2]
    same = all(torch.equal(r["master"][2][n], t) for r in ranks for n, t in master0.items())
    dstat = _stats_delta(master0, rank0_rows[2])
    print(f"2-rank master step: every rank holds rank 0's running statistics {same}; against one "
          f"rank on rank 0's rows max |d| {dstat:.3e} (<= {TRAIN_BN_TOL})", flush=True)
    if not same or dstat > TRAIN_BN_TOL:
        raise SystemExit("chip_smoke: the master step did not keep rank 0's statistics")

    # serving and eval
    launches = {}
    for r in ranks:
        _add(launches, r["bf16"]["launches"])
        for dt in (torch.float32, torch.bfloat16):
            srv = r[f"serving {dt}"]
            # a rank's streams run batched: one launch of each kernel
            expect_launches(srv["sharded_launches"], {"creff_qkv_fused": 1, "warp_bilinear": 1},
                            "2-rank sharded_step")
            expect_launches(srv["gop_launches"], {"creff_qkv_fused": 1, "warp_bilinear": 1},
                            "2-rank gop_parallel_step")
            _add(_add(launches, srv["sharded_launches"]), srv["gop_launches"])
            _maps_agree(srv["sharded"].int(), gop_maps[dt], dt, "2-rank sharded_step")
            _maps_agree(srv["gop"].int(), gop_maps[dt][0], dt, "2-rank gop_parallel_step")
        expect_launches(r["eval"]["launches"], {"creff_qkv_fused": EVAL_BATCHES,
                                                "warp_bilinear": EVAL_BATCHES},
                        "2-rank EvalAlterRes")
        _add(launches, r["eval"]["launches"])
        hist = r["eval"]["hist"]
        print(f"2-rank EvalAlterRes float32: histogram equal to one rank's a frame a call "
              f"{torch.equal(hist, hist_frames)}, largest cell |d| against one rank's batches "
              f"of {EVAL_BATCH} {int((hist - hist_batches).abs().max())}", flush=True)
        if not torch.equal(hist, hist_frames):
            raise SystemExit("chip_smoke: the 2-rank EvalAlterRes histogram differs from one "
                             "rank's")
    print(f"2-rank launches (both ranks) {launches}", flush=True)
    paths[f"camvid-bise18 data parallel, {DP_WORLD} gloo ranks"] = launches
    return paths


def _captured(main, argv):
    """main(argv) with its standard output captured, then echoed; returns
    the output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    print(buf.getvalue(), end="", flush=True)
    return buf.getvalue()


def _leg(name, smi, fn):
    t0 = time.perf_counter()
    out = fn()
    print(f"-- command line leg {name}: {time.perf_counter() - t0:.1f} s on {smi}", flush=True)
    return out


def cli_rank(rank, port, argv, out_dir):
    """One of the CLI_WORLD gloo ranks on cuda:0 (cli_phase spawns them),
    its group initialised before the command runs: ``cli.train_pair`` with
    ``argv``, its standard output to out_dir/rank{rank}.log and its launch
    counts to out_dir/rank{rank}.pt."""
    import torch.distributed as dist

    from arseg_tpu_torch.cli import train_pair

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke rank: no CUDA device")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=CLI_WORLD, rank=rank)
    try:
        with open(f"{out_dir}/rank{rank}.log", "w") as log, contextlib.redirect_stdout(log):
            _, launches = _counted(lambda: train_pair.main(argv))
        torch.save(launches, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _cli_ranks(argv, out_dir, target=None, name="cli.train_pair"):
    """``target`` (cli_rank when None) on CLI_WORLD spawned processes;
    returns (their logs, their launch counts). Any rank's failure fails the
    run."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target or cli_rank, args=(r, port, argv, out_dir))
             for r in range(CLI_WORLD)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(1.0, CLI_TIMEOUT - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * CLI_WORLD:
        raise SystemExit(f"chip_smoke: a {name} rank failed or timed out: {codes}")
    logs = [Path(f"{out_dir}/rank{r}.log").read_text() for r in range(CLI_WORLD)]
    return logs, [torch.load(f"{out_dir}/rank{r}.pt") for r in range(CLI_WORLD)]


def _result_files(d):
    return {name: np.loadtxt(os.path.join(d, name)) for name in sorted(os.listdir(d))}


def cli_phase(smi):
    """The offline command line (``arseg_tpu_torch/cli``) on a synthetic
    CamVid tree at 720x960, camvid-bise18: (a) ``cli.train`` under torchrun
    (one nccl rank), then its ``--resume`` in this process; (b)
    ``cli.train_pair`` stage 2 here, with (a)'s checkpoint as the teacher;
    (c) ``cli.train_pair --num_devices 2 --bn_mode sync`` on two gloo ranks
    spawned on the card; (d) ``cli.evaluation`` in float32 and bfloat16
    under a one-rank nccl group, the float32 files against the same command
    on the CPU; (e) ``cli.convert --to_torch`` and back. Returns the launch
    counts of (b), (c) and (d)."""
    import tempfile

    import torch.distributed as dist

    from arseg_tpu_torch.cli import convert, evaluation, train, train_pair
    from arseg_tpu_torch.utils.checkpoint import load_checkpoint

    sys.path.insert(0, str(REPO / "tests"))
    from synthetic_data import make_camvid_tree

    phase(f"command line: camvid-bise18 on a synthetic CamVid tree, {H}x{W}, GOP {CLI_GOP}, "
          f"{CLI_SAMPLES} samples a split")
    import cv2
    import PIL

    print(f"the readers' image libraries: PIL {PIL.__version__}, cv2 {cv2.__version__}",
          flush=True)
    paths = {}
    with tempfile.TemporaryDirectory() as root:
        _leg("tree", smi, lambda: make_camvid_tree(
            root, gop=CLI_GOP, splits=("train", "val", "test"), h=H, w=W, flow_shape=(H, W, 2),
            dataset_idxs=[6690 + 30 * i for i in range(CLI_SAMPLES)]))
        seq = os.path.join(root, "camvid-sequence")
        data = os.path.join(seq, f"3M-GOP{CLI_GOP}", f"decoded_GOP{CLI_GOP}_dist_1")
        hr_dir, ar_dir, dp_dir = (os.path.join(root, d) for d in ("hr", "ar", "dp"))
        hr_args = ["--data-path", data, "--models-path", hr_dir, "--backend", "resnet18",
                   "--batch-size", str(CLI_BATCH), "--dataset", "camvid", "--model_type",
                   "bisenet", "--scale", "1.0", "--train_dtype", "bfloat16"]

        def torchrun_train():
            cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
                   "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
                   "-m", "arseg_tpu_torch.cli.train", *hr_args, "--epochs", "1"]
            proc = subprocess.run(cmd, cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                                  capture_output=True, text=True, timeout=CLI_TIMEOUT)
            print(proc.stdout[-2000:], end="", flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], flush=True)
                raise SystemExit(f"chip_smoke: torchrun cli.train exited {proc.returncode}")
            return proc.stdout

        out = _leg("(a) torchrun --nproc_per_node 1 -m arseg_tpu_torch.cli.train, 1 epoch",
                   smi, torchrun_train)
        hr_ckpt = os.path.join(hr_dir, "PSPNet_resnet18_1.0_1_.pth")
        if "[1] it 0" not in out or not os.path.exists(hr_ckpt):
            raise SystemExit("chip_smoke: torchrun cli.train logged no step or wrote no "
                             "checkpoint")
        out = _leg("(a) cli.train --resume, epoch 2", smi, lambda: _captured(
            train.main, hr_args + ["--epochs", "2", "--resume", hr_ckpt]))
        if "resuming from" not in out or "[1] it" in out or "[2] it" not in out:
            raise SystemExit("chip_smoke: cli.train --resume did not run epoch 2 alone")

        pair_args = ["--data-path", data, "--sequence-path", seq, "--backend", "resnet18",
                     "--epochs", "1", "--scale", str(SCALE), "--feat_loss", "mse",
                     "--stage1_epoch", "0", "--ref_gap", str(CLI_GOP), "--with_motion", "1",
                     "--model_type", "bisenet", "--train_dtype", "bfloat16",
                     "--teacher_snapshot", hr_ckpt]
        _, launches = _leg("(b) cli.train_pair stage 2", smi, lambda: _counted(
            lambda: _captured(train_pair.main, pair_args + [
                "--models-path", ar_dir, "--batch-size", str(CLI_BATCH), "--device", "cuda"])))
        # one launch a step and one a validation batch (a frame a batch)
        want = CLI_SAMPLES // CLI_BATCH + CLI_SAMPLES
        expect_launches(launches, {"creff_qkv_fused": want, "warp_bilinear": want,
                                   "creff_phase2_argmax": 0, "creff_attention": 0,
                                   "creff_phase2_upsample_argmax": 0}, "cli.train_pair")
        print(f"cli.train_pair launches {launches}", flush=True)
        paths["camvid-bise18 cli.train_pair"] = launches
        ar_ckpt = os.path.join(ar_dir, f"PSPNet_resnet18_{SCALE}_1_.pth")
        if not os.path.exists(ar_ckpt):
            raise SystemExit("chip_smoke: cli.train_pair wrote no checkpoint")

        dp_argv = pair_args + ["--models-path", dp_dir, "--batch-size",
                               str(CLI_BATCH * CLI_WORLD), "--num_devices", str(CLI_WORLD),
                               "--bn_mode", "sync", "--device", "cuda"]
        logs, rank_launches = _leg(
            f"(c) cli.train_pair --num_devices {CLI_WORLD} --bn_mode sync, {CLI_WORLD} gloo ranks",
            smi, lambda: _cli_ranks(dp_argv, root))
        # one step of the global batch; validation a frame a rank a batch
        want = CLI_SAMPLES // (CLI_BATCH * CLI_WORLD) + CLI_SAMPLES // CLI_WORLD
        total = {}
        for n in rank_launches:
            expect_launches(n, {"creff_qkv_fused": want, "warp_bilinear": want},
                            f"cli.train_pair on {CLI_WORLD} ranks")
            _add(total, n)
        print(f"rank 0's log:\n{logs[0]}", end="", flush=True)
        written = os.listdir(dp_dir)
        if ("[1] it 0" not in logs[0] or "val mIoU" not in logs[0] or "[1] it" in logs[1]
                or "val mIoU" in logs[1] or written != [f"PSPNet_resnet18_{SCALE}_1_.pth"]):
            raise SystemExit(f"chip_smoke: rank 0 alone must log and write the checkpoint; "
                             f"rank 1 logged {logs[1][-500:]!r}, written {written}")
        print(f"cli.train_pair on {CLI_WORLD} ranks: launches a rank {rank_launches}, rank 0 "
              f"alone logged and wrote {written}", flush=True)
        paths[f"camvid-bise18 cli.train_pair, {CLI_WORLD} gloo ranks"] = total

        ckpt_root = os.path.join(root, "ckpt", "camvid-bise18")
        for mode, src in (("HR", hr_ckpt), ("AR", ar_ckpt), ("LR", ar_ckpt)):
            os.makedirs(os.path.join(ckpt_root, mode))
            os.link(src, os.path.join(ckpt_root, mode, os.path.basename(src)))
        eval_args = ["--data_root", root, "--ckpt_root", os.path.join(root, "ckpt"),
                     "--dataset", "camvid", "--backbone", "bise18", "--mode", "1", "1", "1",
                     "--GOP", str(CLI_GOP), "--test_scale", str(SCALE), "--num_devices", "1"]
        total = {}
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        try:
            for dt in ("float32", "bfloat16"):
                _, n = _leg(f"(d) cli.evaluation --dtype {dt}, one nccl rank", smi,
                            lambda: _counted(lambda: _captured(evaluation.main, eval_args + [
                                "--dtype", dt, "--result_dir", os.path.join(root, f"eval_{dt}"),
                                "--device", "cuda"])))
                # AR at distance 1: EvalAlterRes, a frame a batch
                expect_launches(n, {"creff_qkv_fused": CLI_SAMPLES,
                                    "warp_bilinear": CLI_SAMPLES}, f"cli.evaluation {dt}")
                _add(total, n)
        finally:
            dist.destroy_process_group()
        paths["camvid-bise18 cli.evaluation (float32 and bfloat16)"] = total
        _leg("(d) cli.evaluation --dtype float32 --device cpu", smi, lambda: _captured(
            evaluation.main, eval_args + ["--dtype", "float32", "--result_dir",
                                          os.path.join(root, "eval_cpu"), "--device", "cpu"]))
        card, cpu, b16 = (_result_files(os.path.join(root, f"eval_{d}"))
                          for d in ("float32", "cpu", "bfloat16"))
        if not (sorted(card) == sorted(cpu) == sorted(b16) and len(card) == 3):
            raise SystemExit(f"chip_smoke: cli.evaluation wrote {sorted(card)}, on the CPU "
                             f"{sorted(cpu)}, in bf16 {sorted(b16)}")
        diff = max(float(np.abs(card[k] - cpu[k]).max()) for k in card)
        print(f"cli.evaluation: {sorted(card)}; card f32 against CPU f32 max |d| {diff:.3e} "
              f"(<= {PROTOCOL_TOL}); bf16 {({k: v.tolist() for k, v in b16.items()})}",
              flush=True)
        if not diff <= PROTOCOL_TOL or not all(
                v.shape == (CLI_GOP + 1,) and np.all((v >= 0) & (v <= 1)) for v in b16.values()):
            raise SystemExit("chip_smoke: cli.evaluation's files disagree with the CPU or are "
                             "out of range")

        ref, back = os.path.join(root, "ref.pth"), os.path.join(root, "back.pth")

        def round_trip():
            _captured(convert.main, [ar_ckpt, ref, "--to_torch", "--backend", "camvid-bise18"])
            _captured(convert.main, [ref, back, "--backend", "camvid-bise18", "--dataset",
                                     "camvid", "--scale", str(SCALE)])
            a, b = (load_checkpoint(f)["state_dict"] for f in (ar_ckpt, back))
            return sorted(a) == sorted(b) and all(torch.equal(v, b[k]) for k, v in a.items())

        same = _leg("(e) cli.convert --to_torch and back", smi, round_trip)
        print(f"cli.convert round trip of cli.train_pair's checkpoint bit-equal: {same}",
              flush=True)
        if not same:
            raise SystemExit("chip_smoke: cli.convert's round trip changed the checkpoint")
    torch.cuda.empty_cache()
    return paths


@torch.no_grad()
def random_trained_like_(model, x):
    """A random model given two traits of trained ones, so that float32
    rounding does not decide its outputs: every BN's running statistics set
    to those of one train-mode forward of `x` (NCHW, on the CPU), then each
    residual branch's last BN scale to RESIDUAL_GAMMA. With the init's BN
    statistics each residual block doubles the variance (ResNet-101's
    features reach ~1e5, where CReFF's softmax over products of such
    features turns on rounding); with calibrated statistics alone,
    ResNet-152's float32 logits on the CPU differ from its float64 ones by
    ~1e-3 of their largest and its maps by more than AGREEMENT allows, with
    the damped branches by ~1e-6."""
    from arseg_tpu_torch.nn.resnet import BasicBlock, Bottleneck

    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None  # a cumulative average: this batch's statistics
    model.train()
    model(x)
    for bn in bns:
        bn.momentum = 0.1
    for m in model.modules():
        if isinstance(m, (BasicBlock, Bottleneck)):
            (m.bn3 if isinstance(m, Bottleneck) else m.bn2).weight.mul_(RESIDUAL_GAMMA)
    return model.eval()


def backbone_phase(smi):
    """One GOP of AR serving (GOP 12, LR 0.5x, bf16, seeded random weights
    at full width, made trained-like by `random_trained_like_` on the
    frames of the short GOP below) on each backbone of BACKBONE_CASES with
    its launch counts: camvid PSPNet V1 (HR plain) at 720x960 (K3 and K2 once),
    cityscapes PSPNetSemseg (fused HR and LR, as the registry builds them)
    at 1024x2048 (K1 and K2 once); the median ms/GOP of BACKBONE_RUNS; then
    a short GOP at BACKBONE_SHORT_HW on the card in float32 against the
    CPU."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.train.trainer import DATASET_POLICY, build_train_model

    paths = {}
    for dataset, backend in BACKBONE_CASES:
        camvid = dataset == "camvid"
        name = f"{dataset} {'PSPNet V1' if camvid else 'PSPNetSemseg'} {backend}"
        hw = (H, W) if camvid else CITY_HW
        phase(f"backbones: {name} AR 0.5x, GOP 12, {hw[0]}x{hw[1]}, bf16")
        n_classes = DATASET_POLICY[dataset]["n_classes"]
        norm = (CAMVID_MEAN, CAMVID_STD) if camvid else CITY_NORM["cityscapes-psp18"]
        short = make_clip(1, frames=2, hw=BACKBONE_SHORT_HW[dataset])
        frames = torch.cat([short[0], short[1][0]]).permute(0, 3, 1, 2).float() / 255
        x = (frames - torch.tensor(norm[0]).view(3, 1, 1)) / torch.tensor(norm[1]).view(3, 1, 1)
        models = []
        for seed, fuse, scale in ((0, not camvid, 1.0), (1, True, SCALE)):  # HR, LR
            m = build_train_model("pspnet", dataset, backend, n_classes, fuse=fuse, seed=seed)
            # the LR frames as the pipeline resizes them
            xs = F.interpolate(x, scale_factor=scale, mode="bilinear",
                               align_corners=True) if scale != 1 else x
            models.append(random_trained_like_(m, xs))
        pipe = ARPipeline(*models, scale=SCALE, dtype=torch.bfloat16, normalize=norm,
                          device="cuda")
        kfs, frs, fxs, fys = (t.cuda() for t in make_clip(1, hw=hw))
        args = (kfs, frs[0], (fxs[0], fys[0]))
        pipe.gop_step(*args)  # warm-up
        out, launches = _counted(lambda: pipe.gop_step(*args))
        check_maps_range(out, (GOP, *hw), n_classes, name)
        expect_launches(launches, {"warp_bilinear": 1, "creff_phase2_argmax_lr": int(camvid),
                                   "creff_phase2_argmax": 0, "creff_qkv_fused": int(not camvid),
                                   "creff_attention": 0, "creff_phase2_upsample_argmax": 0},
                        name)
        ms = float(np.median([_sync_ms(lambda: pipe.gop_step(*args))[1]
                              for _ in range(BACKBONE_RUNS)]))
        print(f"{name}: {ms:.3f} ms/GOP (median of {BACKBONE_RUNS}, {GOP * 1e3 / ms:.1f} "
              f"frames/s), classes {int(out.min())}..{int(out.max())}, launches {launches}, "
              f"on {smi}", flush=True)
        paths[name] = launches
        del pipe, out, kfs, frs, fxs, fys
        torch.cuda.empty_cache()
        card_vs_cpu(models, short, None, name, norm, fused_share=True)
        torch.cuda.empty_cache()
    return paths


def video_sequence(root, gops, seed=0):
    """gops*GOP frames %05d.png (720x960) of a smoothed random canvas panning
    VIDEO_PAN px a frame under root/decoded, and their merged MVs under
    root/mv: int16 quarter-pel [H, W, 2], each frame's displacement to its
    GOP's keyframe (4 * VIDEO_PAN * d along x at d frames from it) with a
    seeded jitter of +-2 on 8x8 blocks. Returns (frames dir, MV dir, the
    frames' paths)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    n = gops * GOP
    canvas = rng.randint(0, 256, (H, W + VIDEO_PAN * n, 3)).astype(np.int32)
    canvas = ((canvas + np.roll(canvas, 1, 0) + np.roll(canvas, 1, 1)) // 3).astype(np.uint8)
    data, flows = os.path.join(root, "decoded"), os.path.join(root, "mv")
    os.makedirs(data)
    os.makedirs(flows)
    paths = []
    for i in range(n):
        paths.append(os.path.join(data, f"{i:05d}.png"))
        Image.fromarray(canvas[:, VIDEO_PAN * i:VIDEO_PAN * i + W]).save(paths[-1],
                                                                        compress_level=1)
        d = i % GOP
        mv = np.zeros((H, W, 2), np.int16)
        if d:
            mv[..., 0] = 4 * VIDEO_PAN * d
            mv += rng.randint(-2, 3, (H // 8, W // 8, 2)).repeat(8, 0).repeat(8, 1).astype(
                np.int16)
        mv.tofile(os.path.join(flows, f"{i:05d}.bin"))
    return data, flows, paths


def linked_sequence(data, flows, root, gops, shift=0):
    """A sequence of gops GOPs under root whose GOP k is GOP (k + shift) mod
    n of (data, flows), n its GOP count, through symlinks."""
    n = len(os.listdir(data)) // GOP
    out = (os.path.join(root, "decoded"), os.path.join(root, "mv"))
    for d in out:
        os.makedirs(d)
    for i in range(gops * GOP):
        j = ((i // GOP + shift) % n) * GOP + i % GOP
        os.symlink(os.path.join(data, f"{j:05d}.png"), os.path.join(out[0], f"{i:05d}.png"))
        os.symlink(os.path.join(flows, f"{j:05d}.bin"), os.path.join(out[1], f"{i:05d}.bin"))
    return out


def _pngs(out_dir, n):
    from PIL import Image

    names = sorted(os.listdir(out_dir))
    if names != [f"{i:05d}.png" for i in range(n)]:
        raise SystemExit(f"chip_smoke: cli.infer_video wrote {names[:4]}... ({len(names)} "
                         f"files) to {out_dir}, expected {n} maps")
    return np.stack([np.asarray(Image.open(os.path.join(out_dir, x))) for x in names])


def _cli_pipeline(backend, ckpt, dtype):
    """The pipeline cli.infer_video builds: the registry's models loaded from
    the checkpoints, on the card in dtype."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.models import build_model
    from arseg_tpu_torch.utils.checkpoint import load_weights

    models = []
    for fuse, path in ((False, ckpt[0]), (True, ckpt[1])):
        models.append(build_model(backend, fuse=fuse, device="cpu"))
        load_weights(models[-1], path, backend)
    return ARPipeline(*models, scale=SCALE, dtype=dtype, normalize=(CAMVID_MEAN, CAMVID_STD),
                      device="cuda")


def video_gops(data, flows, n_gops):
    """The sequence's GOPs on the card, read straight from its files as the
    command's input layout defines them, without the port's readers or
    feeder: each frame's PNG decoded by PIL and normalised, (x/255 - mean) /
    std in float32; the keyframe is the GOP's first frame; each other
    frame's merged-MV bin (int16 quarter-pel [H, W, 2]) is split into its x
    and y planes of pixels. [(keyframe [1,H,W,3], frames [GOP-1,H,W,3],
    fx, fy)]."""
    from PIL import Image

    mean, std = np.float32(CAMVID_MEAN), np.float32(CAMVID_STD)
    gops = []
    for k in range(n_gops):
        idx = range(k * GOP, (k + 1) * GOP)
        imgs = np.stack([np.asarray(Image.open(os.path.join(data, f"{i:05d}.png")).convert(
            "RGB"), np.float32) for i in idx])
        imgs = (imgs / np.float32(255) - mean) / std
        mv = np.stack([np.fromfile(os.path.join(flows, f"{i:05d}.bin"), np.int16).reshape(
            H, W, 2) for i in idx[1:]]).astype(np.float32) / np.float32(4)
        gops.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda()
                          for a in (imgs[:1], imgs[1:], mv[..., 0], mv[..., 1])))
    return gops


def video_reference(backend, ckpt, data, flows, dtype):
    """gop_step over the sequence's GOPs in this process (``video_gops``,
    host-normalised float32, as the file-fed command ships them): the uint8
    maps [n, H, W], and gop_step alone on GOPs already on the card: its
    wall ms/GOP (host clock around synchronised GOPs) and its device
    kernels' ms/GOP (torch.profiler, as tools_torch_profile_gop.py counts
    them)."""
    from torch.profiler import ProfilerActivity, profile

    pipe = _cli_pipeline(backend, ckpt, dtype)
    gops = video_gops(data, flows, VIDEO_GOPS)

    def clip():
        return [pipe.gop_step(kf, fr, (fx, fy)) for kf, fr, fx, fy in gops]

    maps = torch.cat(clip()).to(torch.uint8).cpu().numpy()  # also the warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / len(gops))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        clip()
        torch.cuda.synchronize()
    busy = _device_ms(prof)[0] / len(gops)
    del pipe, gops
    torch.cuda.empty_cache()
    return maps, float(np.median(walls)), busy


def _device_ms(prof):
    """(kernels, copies and memsets): the card's ms in a torch.profiler
    run, the record_function spans left out: a span that encloses
    launches is recorded on the card too, as an annotation."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels = copies = 0.0
    for e in prof.key_averages():
        if e.device_type != cuda or e.key.startswith(PORT_SPANS):
            continue
        if e.key.startswith(("Memcpy", "Memset")):
            copies += e.self_device_time_total / 1e3
        else:
            kernels += e.self_device_time_total / 1e3
    return kernels, copies


def _traced_infer(argv, log_dir):
    """cli.infer_video with argv under ``utils/profiling.trace`` (the Chrome
    trace to log_dir): (the launches, its kernels' and its copies' device
    ms over the whole run)."""
    from arseg_tpu_torch.utils.profiling import trace

    with trace(log_dir) as prof:
        _, launches = _infer(argv)
    return launches, *_device_ms(prof)


def _infer(argv):
    """cli.infer_video on the card with argv, its launches counted: (its
    output, the launches)."""
    from arseg_tpu_torch.cli import infer_video

    return _counted(lambda: _captured(infer_video.main, argv + ["--device", "cuda"]))


def _stats(path):
    with open(path) as f:
        s = json.load(f)
    want = sorted(["frames_per_sec", "max_ms", "mean_ms", "min_ms", "p50_ms", "p95_ms", "steps",
                   "loop_frames_per_sec", "loop_ms_per_step", "loop_s", "loop_steps",
                   "loop_feed_wait_s", "loop_write_wait_s"])
    if sorted(s) != want:
        raise SystemExit(f"chip_smoke: --stats_json holds {sorted(s)}, expected {want}")
    return s


def _path_launches(backend, n):
    """Launches of n bfloat16 GOP steps of backend's default path: K1
    (bise18) or K3's LR form (psp18 V1), and K2, once a step."""
    head = "creff_qkv_fused" if "bise" in backend else "creff_phase2_argmax_lr"
    other = "creff_phase2_argmax_lr" if "bise" in backend else "creff_qkv_fused"
    return {head: n, "warp_bilinear": n, other: 0, "creff_phase2_argmax": 0,
            "creff_attention": 0, "creff_phase2_upsample_argmax": 0}


def video_rank(rank, port, jobs, out_dir):
    """One of the CLI_WORLD gloo ranks on cuda:0 (video_phase spawns them),
    its group initialised before the commands run: cli.infer_video with each
    argv of ``jobs``, its standard output to out_dir/rank{rank}.log and its
    launch counts, a dict per job, to out_dir/rank{rank}.pt."""
    import torch.distributed as dist

    from arseg_tpu_torch.cli import infer_video

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke rank: no CUDA device")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=CLI_WORLD, rank=rank)
    try:
        launches = []
        with open(f"{out_dir}/rank{rank}.log", "w") as log, contextlib.redirect_stdout(log):
            for argv in jobs:
                launches.append(_counted(lambda: infer_video.main(argv))[1])
        torch.save(launches, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _agree(got, want, bound, name):
    agree = float(np.mean(got == want))
    print(f"{name}: maps agree {agree:.6f} (>= {bound}), bit-equal {np.array_equal(got, want)}",
          flush=True)
    if not agree >= bound:
        raise SystemExit(f"chip_smoke: {name} disagrees")


def _bit_equal(got, want, name):
    same = np.array_equal(got, want)
    print(f"{name}: bit-equal {same}" + ("" if same else
                                         f" (agree {float(np.mean(got == want)):.6f})"),
          flush=True)
    if not same:
        raise SystemExit(f"chip_smoke: {name} is not bit-equal")


def video_phase(smi):
    """Video inference through the command line (cli.infer_video) at
    720x960, GOP 12, 0.5x, seeded random weights saved as the port's .pth:
    (a) file-fed over a synthetic decoded sequence of VIDEO_GOPS GOPs; (b)
    --video over its HEVC encode and H.264 carrier (or the line saying why
    the native decoder cannot be built); (c) --streams and --gop_devices on
    two gloo ranks; (d) the eval engines' prefetch. Returns the launch
    counts of the command's paths."""
    import tempfile

    from arseg_tpu_torch.eval import EvalAlterRes
    from arseg_tpu_torch.tools.labels import index_to_rgb
    from arseg_tpu_torch.tools.video import NativeUnavailable, load_native
    from arseg_tpu_torch.utils.checkpoint import save_checkpoint

    phase(f"video inference: cli.infer_video, {H}x{W}, GOP {GOP}, {SCALE}x, bf16")
    paths = {}
    n = VIDEO_GOPS * GOP
    with tempfile.TemporaryDirectory() as root:
        data, flows, frames = _leg("sequence", smi, lambda: video_sequence(
            os.path.join(root, "a"), VIDEO_GOPS))
        t_data, t_flows = linked_sequence(data, flows, os.path.join(root, "t"),
                                          VIDEO_TIMING_GOPS)
        b_data, b_flows = linked_sequence(data, flows, os.path.join(root, "b"), VIDEO_GOPS, 1)
        ckpt, common, want = {}, {}, {}
        for backend in ("camvid-bise18", "camvid-psp18"):
            ckpt[backend] = [os.path.join(root, f"{backend}-{m}.pth") for m in ("hr", "ar")]
            for model, path in zip(make_models(backend), ckpt[backend]):
                save_checkpoint(path, model)
            common[backend] = ["--hr_snapshot", ckpt[backend][0], "--ar_snapshot",
                               ckpt[backend][1], "--backend", backend, "--ref_gap", str(GOP),
                               "--scale", str(SCALE), "--flow_shape", str(H), str(W)]
        files = ["--data_path", data, "--flow_path", flows]
        timing = {}
        # (a) file-fed: each backend against gop_step, then its timing runs
        for backend in ("camvid-bise18", "camvid-psp18"):
            want[backend], wall, busy = video_reference(backend, ckpt[backend], data, flows,
                                                        torch.bfloat16)
            out = os.path.join(root, f"{backend}-a")
            _, launches = _leg(f"(a) {backend}", smi, lambda: _infer(
                files + common[backend] + ["--out_dir", out, "--stats_json", out + ".json"]))
            expect_launches(launches, _path_launches(backend, VIDEO_GOPS),
                            f"{backend} cli.infer_video")
            paths[f"{backend} cli.infer_video"] = launches
            _bit_equal(_pngs(out, n), want[backend], f"{backend} cli.infer_video PNGs against "
                       f"gop_step in this process (bf16, {VIDEO_GOPS} GOPs)")
            _stats(out + ".json")
            runs = {}
            for prefetch in (2, 0):
                out = os.path.join(root, f"{backend}-t{prefetch}")
                _, launches = _infer(["--data_path", t_data, "--flow_path", t_flows,
                                      "--prefetch", str(prefetch), "--out_dir", out,
                                      "--stats_json", out + ".json"] + common[backend])
                expect_launches(launches, _path_launches(backend, VIDEO_TIMING_GOPS),
                                f"{backend} cli.infer_video --prefetch {prefetch}")
                _add(paths[f"{backend} cli.infer_video"], launches)
                runs[prefetch] = (_pngs(out, VIDEO_TIMING_GOPS * GOP), _stats(out + ".json"))
            _bit_equal(runs[0][0], runs[2][0], f"{backend} --prefetch 0 PNGs against "
                       "--prefetch 2")
            # the command's own device time: the --prefetch 2 run again, traced
            out = os.path.join(root, f"{backend}-trace")
            launches, kernels, copies = _traced_infer(
                ["--data_path", t_data, "--flow_path", t_flows, "--out_dir", out]
                + common[backend], out + "-log")
            expect_launches(launches, _path_launches(backend, VIDEO_TIMING_GOPS),
                            f"{backend} cli.infer_video under utils/profiling.trace")
            _add(paths[f"{backend} cli.infer_video"], launches)
            kernels, copies = kernels / VIDEO_TIMING_GOPS, copies / VIDEO_TIMING_GOPS
            for prefetch, (_, s) in runs.items():
                print(f"video inference {backend} file-fed --prefetch {prefetch}: end to end "
                      f"{s['loop_ms_per_step']:.3f} ms/GOP, {s['loop_frames_per_sec']:.1f} "
                      f"frames/s (host clock from the end of the warm-up GOP to the last PNG, "
                      f"{s['loop_steps']} GOPs; waiting for the feeder "
                      f"{1e3 * s['loop_feed_wait_s'] / s['loop_steps']:.3f} ms/GOP, for the "
                      f"writer {1e3 * s['loop_write_wait_s'] / s['loop_steps']:.3f}); step "
                      f"latency (StepTimer, the step alone) p50 "
                      f"{s['p50_ms']:.3f} ms, p95 {s['p95_ms']:.3f}; the command's device time "
                      f"(its --prefetch 2 run traced, {VIDEO_TIMING_GOPS} GOPs) kernels "
                      f"{kernels:.3f} ms/GOP, copies {copies:.3f}; idle share 1 - kernels / "
                      f"end-to-end ms = {1 - kernels / s['loop_ms_per_step']:.3f}; gop_step "
                      f"alone {wall:.3f} wall ms/GOP, kernels {busy:.3f}; {smi}", flush=True)
            timing[backend] = dict(gop_step_wall_ms=wall, gop_step_device_ms=busy,
                                   command_kernels_ms=kernels, command_copies_ms=copies,
                                   **{f"prefetch{p}": s for p, (_, s) in runs.items()})

        # --gop_batch 2 over the 3 GOPs (a stack of 2, then the tail)
        bise = "camvid-bise18"
        out = os.path.join(root, "b2")
        _, launches = _leg("(a) --gop_batch 2", smi, lambda: _infer(
            files + common[bise] + ["--gop_batch", "2", "--out_dir", out]))
        steps = -(-VIDEO_GOPS // 2)
        expect_launches(launches, _path_launches(bise, steps), "cli.infer_video --gop_batch 2")
        paths[f"{bise} cli.infer_video --gop_batch 2"] = launches
        _agree(_pngs(out, n), want[bise], MULTI_AGREEMENT[torch.bfloat16],
               f"{bise} --gop_batch 2 against --gop_batch 1, bf16")
        f32 = {}
        for b in (1, 2):
            out = os.path.join(root, f"f32-b{b}")
            _, launches = _infer(files + common[bise] + ["--gop_batch", str(b), "--dtype",
                                                         "float32", "--out_dir", out])
            _add(paths[f"{bise} cli.infer_video --gop_batch 2"], launches)
            f32[b] = _pngs(out, n)
        _bit_equal(f32[2], f32[1], f"{bise} --gop_batch 2 against --gop_batch 1, float32")
        out = os.path.join(root, "color")
        _, launches = _infer(files + common[bise] + ["--colorize", "--out_dir", out])
        _add(paths[f"{bise} cli.infer_video"], launches)
        _bit_equal(_pngs(out, n), index_to_rgb(want[bise]), "--colorize PNGs against "
                   "index_to_rgb of the maps")

        # (b) --video: the HEVC stream and its H.264 carrier, decoded in-process
        try:
            native = load_native()
        except NativeUnavailable as e:
            native = None
            reason = str(e).strip().splitlines()
            print(f"native decoder: {' | '.join(reason)}", flush=True)
            print(f"video leg: not run: {reason[-1]}", flush=True)
        if native is not None:
            paths.update(_leg("(b) --video", smi, lambda: video_leg(
                native, frames, root, common, smi)))

        # (c) --streams over 2 file-fed streams and --gop_devices 2, two gloo ranks
        jobs = [["--streams", f"{data}:{flows},{b_data}:{b_flows}", "--num_devices",
                 str(CLI_WORLD), "--out_dir", os.path.join(root, "streams")],
                files + ["--gop_devices", str(CLI_WORLD), "--out_dir", os.path.join(root, "gd")]]
        jobs = [argv + common[bise] + ["--device", "cuda"] for argv in jobs]
        logs, rank_launches = _leg(f"(c) --streams and --gop_devices on {CLI_WORLD} gloo ranks",
                                   smi, lambda: _cli_ranks(jobs, root, video_rank,
                                                           "cli.infer_video"))
        print(f"rank 0's log:\n{logs[0]}", end="", flush=True)
        shifted = np.concatenate([want[bise][GOP:], want[bise][:GOP]])
        _bit_equal(_pngs(os.path.join(root, "streams", "s0"), n), want[bise],
                   "--streams stream 0 against the stream served alone")
        _bit_equal(_pngs(os.path.join(root, "streams", "s1"), n), shifted,
                   "--streams stream 1 against the stream served alone")
        _agree(_pngs(os.path.join(root, "gd"), n), want[bise], MULTI_AGREEMENT[torch.bfloat16],
               f"--gop_devices {CLI_WORLD} against one card, bf16")
        for j, name in enumerate((f"--streams --num_devices {CLI_WORLD}",
                                  f"--gop_devices {CLI_WORLD}")):
            total = {}
            for r in range(CLI_WORLD):
                expect_launches(rank_launches[r][j], _path_launches(bise, VIDEO_GOPS),
                                f"cli.infer_video {name}, rank {r}")
                _add(total, rank_launches[r][j])
            paths[f"{bise} cli.infer_video {name}, {CLI_WORLD} gloo ranks"] = total

        # (d) the eval engines' prefetch: histograms equal with 0 and 2, on
        # numpy batches and on pinned ones (what a Loader(pin_memory=True)
        # gives); ms per batch of each on the pinned ones
        hr, lr = make_models()
        loader = make_eval_batches(EVAL_BATCHES, EVAL_BATCH, (H, W), seed=9)
        pinned_loader = [{k: _pinned_copy(v) for k, v in b.items()}
                         for b in make_eval_batches(EVAL_TIMING_BATCHES, EVAL_BATCH, (H, W),
                                                    seed=10)]
        hists = {}
        for kind, batches in (("numpy", loader), ("pinned", pinned_loader)):
            for p in (0, 2):
                hists[kind, p], launches = _counted(lambda: EvalAlterRes(
                    scale=SCALE, dtype=torch.bfloat16, device="cuda", prefetch=p).histogram(
                        hr, lr, batches, N_CLASSES))
                _add(paths.setdefault("EvalAlterRes camvid-bise18 prefetch 0 and 2", {}),
                     launches)
        same = all(torch.equal(hists[kind, 0], hists[kind, 2]) for kind in ("numpy", "pinned"))
        print(f"(d) EvalAlterRes histogram with prefetch 2 equal to prefetch 0, on numpy and "
              f"on pinned batches: {same}", flush=True)
        if not same:
            raise SystemExit("chip_smoke: EvalAlterRes's prefetch changed the histogram")
        eval_ms = {0: [], 2: []}
        for p in (0, 2, 2, 0, 0, 2):
            ms, launches = _counted(lambda: _eval_batch_ms(hr, lr, pinned_loader, p))
            eval_ms[p].append(ms)
            _add(paths["EvalAlterRes camvid-bise18 prefetch 0 and 2"], launches)
        print(f"(d) EvalAlterRes camvid-bise18 {H}x{W} bf16, batches of {EVAL_BATCH} pinned: "
              f"ms per batch after the first, prefetch 0 {eval_ms[0]}, prefetch 2 "
              f"{eval_ms[2]} (order 0 2 2 0 0 2); {smi}", flush=True)
        timing["eval_alter_res_ms_per_batch"] = eval_ms
        print(f"video inference timings: {json.dumps(timing)}", flush=True)
    torch.cuda.empty_cache()
    return paths


def _pinned_copy(a):
    from arseg_tpu_torch.data.loader import pinned

    t, view = pinned(a.shape, a.dtype)
    view[...] = a
    return t


def _eval_batch_ms(hr, lr, batches, prefetch, skip=1):
    """EvalAlterRes.predictions over batches (bf16, camvid-bise18): the
    host-clock ms per batch after the first `skip`, synchronised at both
    ends."""
    from arseg_tpu_torch.eval import EvalAlterRes

    maps = EvalAlterRes(scale=SCALE, dtype=torch.bfloat16, device="cuda",
                        prefetch=prefetch).predictions(hr, lr, batches)
    for _ in range(skip):
        next(maps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in maps:
        pass
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (len(batches) - skip)


class _ReadOver:
    """A dataset's samples read over to n in one epoch (sample i is
    dataset[i % len]), sharing its rng, so that a loader's workers each get
    several batches of a small tree."""

    def __init__(self, dataset, n):
        self.dataset, self.n = dataset, n
        self.rng = getattr(dataset, "rng", None)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


def video_leg(native, frames, root, common, smi):
    """(b) of video_phase: the sequence's frames encoded as HEVC and as the
    H.264 carrier (NativeVideo.encode), served with --video --mv_carrier and
    with --video --mv_analysis (the HEVC encode's x265 analysis sidecar),
    each against the file-fed command over the same stream's decoded frames
    and merged MVs. Returns the launch counts."""
    paths = {}
    vid = os.path.join(root, "video")
    os.makedirs(vid)
    hevc, carrier, an = (os.path.join(vid, x) for x in ("s.hevc", "s.264", "a.hevc"))
    native.encode(frames, hevc, codec="libx265", gop=GOP)
    native.encode(frames, carrier, codec="libx264", gop=GOP)
    native.encode_analysis(frames, an, an + ".analysis", gop=GOP)
    n = len(frames)
    bise = "camvid-bise18"
    for kind, stream, mvs, dump in (("carrier", hevc, carrier, native.mvdump),
                                    ("analysis", an, an + ".analysis", native.hevc_mvdump)):
        d = os.path.join(vid, kind)
        dec, mvdir, data, flows = (os.path.join(d, x) for x in ("dec", "mvdump", "data", "mv"))
        for x in (dec, mvdir, data, flows):
            os.makedirs(x)
        native.decode(stream, dec)
        dump(mvs, mvdir)
        for i in range(n):
            os.rename(os.path.join(dec, f"decoded-{i + 1:03d}.png"),
                      os.path.join(data, f"{i:05d}.png"))
        for g0 in range(0, n, GOP):
            bins = np.stack([np.fromfile(os.path.join(mvdir, f"test_{g0 + k:03d}.bin"),
                                         np.int16).reshape(H, W, 3) for k in range(1, GOP)])
            merged = native.merge_mv(bins, max_ref=GOP)
            for k in range(GOP):
                merged[k].tofile(os.path.join(flows, f"{g0 + k:05d}.bin"))
        outs = {}
        for name, argv in (("files", ["--data_path", data, "--flow_path", flows]),
                           ("video", ["--video", stream, f"--mv_{kind}", mvs])):
            out = os.path.join(d, f"out_{name}")
            _, launches = _infer(argv + common[bise] + ["--out_dir", out, "--stats_json",
                                                        out + ".json"])
            expect_launches(launches, _path_launches(bise, n // GOP),
                            f"cli.infer_video {name} ({kind})")
            _add(paths.setdefault(f"{bise} cli.infer_video --video", {}), launches)
            outs[name] = _pngs(out, n)
            s = _stats(out + ".json")
            print(f"video inference {bise} {name} ({kind}): end to end "
                  f"{s['loop_ms_per_step']:.3f} ms/GOP, {s['loop_frames_per_sec']:.1f} "
                  f"frames/s; step latency (StepTimer) p50 {s['p50_ms']:.3f} ms, p95 "
                  f"{s['p95_ms']:.3f}; {smi}", flush=True)
        _bit_equal(outs["video"], outs["files"], f"--video --mv_{kind} against the file-fed "
                   "command over its decoded frames and merged MVs")
    return paths


def synth_gt_dir(root, d):
    """The ground-truth merged-MV directory of distance d in a tree of
    tools.synth_scenes.generate (GOP 12, its default 3000 kbps)."""
    return os.path.join(root, "camvid-sequence", f"3M-GOP{GOP}", f"MVmapGT_GOP{GOP}_dist_{d}")


def gt_warp_case(root, chapter=0):
    """Chapter `chapter` (a test chapter) of a tools.synth_scenes tree: its
    annotated frame uint8 [h, w, 3], the keyframes d = 1..GOP-1 frames
    before it uint8 [GOP-1, h, w, 3], and the ground-truth merged MVs of
    each d in pixels, float32 [GOP-1, h, w, 2]."""
    from arseg_tpu_torch.data.camvid import open_rgb, read_flow_bin
    from arseg_tpu_torch.tools import synth_scenes as S

    info = S.SCENE_LENGTH_INFO[S.SCENE]
    annot = info["encoded_start_idx"] + chapter * S.CHAPTER + S.ANNOT_POS
    name = f"{S.SCENE}_{annot + info['dataset_start_idx'] - info['encoded_start_idx']:06d}"
    cur = open_rgb(os.path.join(root, "camvid", "test", name + ".png"))
    frames = os.path.join(root, "camvid-sequence", "frames", S.SCENE)
    keys = np.stack([open_rgb(os.path.join(frames, f"{S.SCENE}_{annot - d:06d}.png"))
                     for d in range(1, GOP)])
    flows = np.stack([read_flow_bin(os.path.join(synth_gt_dir(root, d), S.SCENE, name + ".bin"),
                                    (*cur.shape[:2], 2)) for d in range(1, GOP)])
    return cur, keys, flows


def warp_image(keys, flows, device):
    """Each keyframe warped by its flow with K2 (ops/warp.warp_feature) on
    `device`, in float32 with the channels padded with zeros to K2_IMAGE_C:
    float32 [n, h, w, 3] on the CPU."""
    from arseg_tpu_torch.ops.warp import warp_feature

    src = torch.zeros((*keys.shape[:3], K2_IMAGE_C), dtype=torch.float32)
    src[..., :3] = torch.from_numpy(keys)
    fl = torch.from_numpy(flows).to(device)
    return warp_feature(src.to(device), (fl[..., 0], fl[..., 1]))[..., :3].cpu()


def psnr_gains(cur, keys, warped):
    """dB by which each warped keyframe beats the keyframe unwarped, both
    against the annotated frame (tools/mv_fidelity's PSNR)."""
    from arseg_tpu_torch.tools.mv_fidelity import _psnr

    return [float(_psnr(np.asarray(w), cur) - _psnr(k, cur)) for k, w in zip(keys, warped)]


def synth_eval(root, smi):
    """(c) of synth_phase: the mIoU_d protocol over the ground-truth MVs.
    Returns the launch counts of EvalAlterRes's runs."""
    from arseg_tpu_torch.data import CamVid, CamVidWithFlow, Loader
    from arseg_tpu_torch.eval import EvalAlterRes, EvalConstRes, confusion_update, miou_from_hist
    from arseg_tpu_torch.eval.protocol import _write_result

    hr, lr = make_models()
    camvid = os.path.join(root, "camvid")  # the reader's root: its test split is camvid/test
    plain = CamVid(camvid, mode="test")
    scored = sum(int((plain[i]["label"] != IGNORE).sum()) for i in range(len(plain)))
    batches = -(-len(plain) // SYNTH_BATCH)

    def loader(ds):
        return Loader(ds, batch_size=SYNTH_BATCH, shuffle=False, num_workers=2,
                      drop_last=False, pin_memory=True)

    def flow_ds(d):
        return CamVidWithFlow(camvid, mode="test", ref_path=os.path.join(
            root, "camvid-sequence", "frames"), flow_path=synth_gt_dir(root, d), ref_gap=d + 1,
            flow_shape=(H, W, 2))

    def miou(name, run):
        hist, launches = _counted(run)
        if int(hist.sum()) != scored or hist.dtype != torch.int64:
            raise SystemExit(f"chip_smoke: {name}'s histogram counts {int(hist.sum())} pixels, "
                             f"not the {scored} scored")
        return float(miou_from_hist(hist.cpu(), nanmean=True)), launches

    kw = dict(dtype=torch.bfloat16, device="cuda", nanmean=True, prefetch=2)
    rows = {"HR": [], "LR": [], "AR": []}
    launches_ar = {}
    for d in range(GOP):
        rows["HR"].append(miou(f"EvalConstRes 1.0x, d {d}", lambda: EvalConstRes(
            scale=1.0, **kw).histogram(hr, loader(plain), N_CLASSES))[0])
        rows["LR"].append(miou(f"EvalConstRes {SCALE}x, d {d}", lambda: EvalConstRes(
            scale=SCALE, **kw).histogram(lr, loader(plain), N_CLASSES))[0])
        if d == 0:  # the protocol: distance 0 is the HR model on the keyframe
            rows["AR"].append(rows["HR"][0])
            continue
        m, launches = miou(f"EvalAlterRes, d {d}", lambda: EvalAlterRes(
            scale=SCALE, **kw).histogram(hr, lr, loader(flow_ds(d)), N_CLASSES))
        expect_launches(launches, {"creff_qkv_fused": batches, "warp_bilinear": batches},
                        f"EvalAlterRes over ground-truth MVs at d {d}")
        _add(launches_ar, launches)
        rows["AR"].append(m)
    print(f"(c) every histogram counts the {scored} scored pixels; EvalAlterRes launches "
          f"{launches_ar} ({batches} batches at each of d = 1..{GOP - 1})", flush=True)

    # the steady state: the split read over to SYNTH_TIMING_READS samples,
    # the batches after the loader's first round (one batch a worker) timed
    timing = _ReadOver(flow_ds(GOP - 1), SYNTH_TIMING_READS)
    read = list(loader(timing))
    ms = {"loader": [], "read": []}
    for how in ("read", "loader", "loader", "read"):
        ms[how].append(_eval_batch_ms(hr, lr, read if how == "read" else loader(timing), 2,
                                      skip=2))
    del read
    print(f"(c) EvalAlterRes bf16 at d {GOP - 1}, prefetch 2, ms per batch of {SYNTH_BATCH} "
          f"over {SYNTH_TIMING_READS // SYNTH_BATCH - 2} batches after the first 2 (order read, "
          f"loader, loader, read): fed by Loader(pin_memory=True, num_workers=2) "
          f"{[round(x, 3) for x in ms['loader']]}, from the same batches read beforehand into "
          f"pinned memory {[round(x, 3) for x in ms['read']]}; {smi}", flush=True)

    result_dir = os.path.join(root, "results")
    name = f"GOP{GOP}-3M-evaluation.txt"
    files = {"HR": f"synth-camvid-bise18-1.0x-resolution-exp-{name}",
             "LR": f"synth-camvid-bise18-{SCALE}x-resolution-exp-{name}",
             "AR": f"synth-camvid-bise18-AR-{SCALE}x-resolution-exp-{name}"}
    for m, file in files.items():
        full = _write_result(result_dir, file, rows[m])
        back = np.loadtxt(os.path.join(result_dir, file))
        if back.shape != (GOP + 1,) or not np.allclose(back, full, rtol=0, atol=PROTOCOL_TOL):
            raise SystemExit(f"chip_smoke: {file} is not the protocol's {GOP + 1} lines")
        print(f"(c) {file}: mIoU_d (random weights, information) "
              f"{[round(x, 6) for x in full[:-1]]}, mean {full[-1]:.6f}", flush=True)

    d = GOP - 1
    maps, hists = [], []
    for device in ("cuda", "cpu"):
        pairs = list(EvalAlterRes(scale=SCALE, device=device, nanmean=True).predictions(
            hr, lr, loader(flow_ds(d))))
        hist = torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int64)
        for label, pred in pairs:
            hist = confusion_update(hist, label.cpu(), pred.cpu(), N_CLASSES, IGNORE)
        maps.append(torch.cat([pred.cpu().flatten() for _, pred in pairs]))
        hists.append(hist)
    agree = (maps[0] == maps[1]).float().mean().item()
    dmiou = abs(float(miou_from_hist(hists[0], nanmean=True))
                - float(miou_from_hist(hists[1], nanmean=True)))
    print(f"(c) EvalAlterRes at d {d}, card f32 vs CPU f32 at {H}x{W}: class maps agree "
          f"{agree:.6f} (>= {AGREEMENT}), mIoU |d| {dmiou:.3e} (<= {MIOU_TOL})", flush=True)
    if not (agree >= AGREEMENT and dmiou <= MIOU_TOL):
        raise SystemExit("chip_smoke: EvalAlterRes over ground-truth MVs on the card disagrees "
                         "with the CPU")
    return launches_ar


def variants_stage(root, smi):
    """(d) of synth_phase: the CamVid variants in train mode through
    Loader(pin_memory=True) and device_prefetch onto the card, against the
    same loader's host batches without pinning."""
    from arseg_tpu_torch.data import (CamVidWithBiFlow, CamVidwithCUmap,
                                      CamVidwithCUmapSingleBranch, Loader, device_prefetch)
    from arseg_tpu_torch.data.transform import SampleRng
    from arseg_tpu_torch.train.trainer import DATASET_POLICY

    sys.path.insert(0, str(REPO / "tests"))
    from synthetic_data import make_camvid_tree
    from variant_tree import add_variant_extras

    g = VARIANT_GOP
    seq_root = make_camvid_tree(os.path.join(root, "variants"), gop=g, splits=("train",), h=H,
                                w=W, flow_shape=(H, W, 2))
    data_root = add_variant_extras(seq_root, g, H, W, (H, W, 2))
    policy = DATASET_POLICY["camvid"]
    aug = dict(mode="train", cropsize=policy["cropsize"], randomscale=policy["randomscale"])
    variants = {
        "CamVidWithBiFlow": lambda: CamVidWithBiFlow(
            data_root, ref_gap=g, ref_path=os.path.join(seq_root, "frames"),
            flow_path=os.path.join(seq_root, f"MVmap_GOP{g}_dist_{g - 1}"), flow_shape=(H, W, 2),
            rng=SampleRng(), **aug),
        "CamVidwithCUmap": lambda: CamVidwithCUmap(data_root, rng=SampleRng(), **aug),
        "CamVidwithCUmapSingleBranch": lambda: CamVidwithCUmapSingleBranch(
            data_root, rng=SampleRng(), **aug),
    }
    workers = policy["train_workers"]
    for name, make in variants.items():
        def loader(pin):
            return Loader(_ReadOver(make(), VARIANT_READS), batch_size=VARIANT_BATCH,
                          shuffle=True, seed=0, pin_memory=pin, num_workers=workers)

        # the samples/s after the workers' first round (one batch each),
        # which holds their start-up
        staged = []
        for b in device_prefetch(loader(True), "cuda"):
            staged.append(b)
            if len(staged) == workers:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        host = list(loader(False))
        equal = len(staged) == len(host) and all(
            sorted(s) == sorted(h) and all(s[k].is_cuda and torch.equal(
                s[k].cpu(), torch.from_numpy(h[k])) for k in h) for s, h in zip(staged, host))
        timed_samples = (len(staged) - workers) * VARIANT_BATCH
        shapes = {k: tuple(v.shape) for k, v in staged[0].items()}
        print(f"(d) {name} train mode, the tree's {len(make())} samples read over to "
              f"{VARIANT_READS} in one epoch through Loader(pin_memory=True, num_workers="
              f"{workers}) and device_prefetch: {timed_samples / secs:.2f} samples/s over the "
              f"{timed_samples} after the workers' first round (information); batch {shapes}; "
              f"staged bit-equal to the host batches: {equal}; {smi}", flush=True)
        if not equal:
            raise SystemExit(f"chip_smoke: {name}'s staged batches differ from the host batches")
        del staged


def native_tools_leg(root, smi):
    """(e) of synth_phase: `cli.preprocess camvid` on one synthetic chapter
    and `tools.mv_fidelity --synthetic`, each as a user runs it, when the
    native library builds; else the line saying why not."""
    from arseg_tpu_torch.tools.synth_scenes import generate
    from arseg_tpu_torch.tools.video import NativeUnavailable, load_native

    try:
        load_native()
    except NativeUnavailable as e:
        reason = str(e).strip().splitlines()
        print(f"native library: {' | '.join(reason)}", flush=True)
        print(f"preprocess/mv_fidelity: not run: {reason[-1]}", flush=True)
        return
    tree = os.path.join(root, "native")
    generate(tree, n_train=0, n_val=0, n_test=1, h=NATIVE_H, w=NATIVE_W, gop=GOP,
             seed=SYNTH_SEED, progress=None)
    seq = os.path.join(tree, "camvid-sequence")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "arseg_tpu_torch.cli.preprocess", "camvid",
                    "--camvid_root", os.path.join(tree, "camvid"), "--sequence_root", seq,
                    "--splits", "test"], cwd=REPO, check=True, capture_output=True, timeout=600)
    out = os.path.join(seq, f"3M-GOP{GOP}")
    name = os.listdir(os.path.join(tree, "camvid", "test"))[0]
    want = [os.path.join(out, f"decoded_GOP{GOP}_dist_{d}", "test", name) for d in range(GOP)]
    want += [os.path.join(out, f"MVmap_GOP{GOP}_dist_{d}", "0001TP", name[:-4] + ".bin")
             for d in range(1, GOP)]
    missing = [p for p in want if not os.path.exists(p)]
    print(f"(e) cli.preprocess camvid on one chapter at {NATIVE_H}x{NATIVE_W} ({GOP} GOP "
          f"windows): {time.perf_counter() - t0:.1f} s, missing outputs {missing}", flush=True)
    if missing:
        raise SystemExit("chip_smoke: cli.preprocess camvid left outputs out")
    r = subprocess.run([sys.executable, "-m", "arseg_tpu_torch.tools.mv_fidelity",
                        "--synthetic"], cwd=REPO, check=True, capture_output=True, text=True,
                       timeout=600)
    print(f"(e) mv_fidelity --synthetic: {r.stdout.strip().splitlines()[-1]}", flush=True)


def synth_phase(smi):
    """Labelled synthetic scenes and the data variants (the module
    docstring's phase 16): (a) generate, (b) the ground-truth MVs against
    K2, (c) the mIoU_d protocol over them, (d) the CamVid variants staged
    on the card, (e) the native tools. Returns the launch counts of (c)."""
    import tempfile

    from arseg_tpu_torch.tools.synth_scenes import generate

    phase(f"labelled synthetic scenes ({SYNTH_CHAPTERS} test chapters, {H}x{W}, GOP {GOP}) and "
          "the data variants; K2 warps the RGB keyframe in float32, channels padded with zeros "
          f"to {K2_IMAGE_C}")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        generate(root, n_train=0, n_val=0, n_test=SYNTH_CHAPTERS, h=H, w=W, gop=GOP,
                 seed=SYNTH_SEED, progress=None)
        secs = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(root)
                     for f in fs)
        print(f"(a) synth_scenes.generate: {SYNTH_CHAPTERS} chapters in {secs:.2f} s, {nbytes} "
              f"bytes written; {smi}", flush=True)

        cur, keys, flows = gt_warp_case(root)
        card, launches = _counted(lambda: warp_image(keys, flows, "cuda"))
        plain = warp_image(keys, flows, "cpu")
        err = float((card - plain).abs().max())
        gains = psnr_gains(cur, keys, card)
        print(f"(b) K2 on [{GOP - 1},{H},{W},{K2_IMAGE_C}] float32, one keyframe per distance, "
              f"launches {launches}: max |card - CPU plain| {err} (must be 0); PSNR gain of the "
              f"ground-truth-MV warp over no warp, d = 1..{GOP - 1}: "
              f"{[round(x, 3) for x in gains]} dB (each > {PSNR_MARGIN})", flush=True)
        if err != 0 or launches.get("warp_bilinear") != 1:
            raise SystemExit("chip_smoke: K2's warp by the ground-truth MVs is not its plain "
                             "version's")
        if min(gains) <= PSNR_MARGIN:
            raise SystemExit("chip_smoke: the ground-truth-MV warp does not beat no warp by "
                             f"{PSNR_MARGIN} dB at every distance")

        launches = synth_eval(root, smi)
        variants_stage(root, smi)
        native_tools_leg(root, smi)
    torch.cuda.empty_cache()
    return {"camvid-bise18 EvalAlterRes over ground-truth MVs (synthetic scenes)": launches}


def timed(fn, name):
    t0 = time.perf_counter()
    out = fn()
    print(f"-- phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    t_start = time.perf_counter()
    smi = timed(device_phase, "device")
    from arseg_tpu_torch import set_f32_parity_mode

    set_f32_parity_mode()  # float32 convolutions in full float32, not TF32
    timed(build_phase, "build")
    stats = timed(kernel_phase, "kernels")
    paths = {"camvid-bise18": timed(pipeline_phase, "camvid-bise18 pipeline"),
             **timed(psp18_phase, "camvid-psp18 pipelines"),
             **timed(variants_phase, "camvid-bise18 fusion variants and fused head"),
             **timed(lambda: cityscapes_phase("cityscapes-bise18"), "cityscapes-bise18 pipeline"),
             **timed(lambda: cityscapes_phase("cityscapes-psp18"), "cityscapes-psp18 pipeline"),
             **timed(multi_gop_phase, "camvid-bise18 multi-GOP"),
             **timed(psp18_multi_gop_phase, "camvid-psp18 V1 multi-GOP"),
             **timed(semseg_multi_gop_phase, "cityscapes-psp18 multi-GOP"),
             **timed(lambda: streaming_phase(smi), "camvid-bise18 streaming"),
             **timed(eval_phase, "eval engines")}
    train_launches, stage2_ms = timed(lambda: training_phase(smi), "training")
    paths.update(train_launches)
    paths.update(timed(lambda: data_parallel_phase(smi, stage2_ms), "data parallel"))
    paths.update(timed(lambda: cli_phase(smi), "command line"))
    paths.update(timed(lambda: backbone_phase(smi), "backbones"))
    paths.update(timed(lambda: video_phase(smi), "video inference"))
    paths.update(timed(lambda: synth_phase(smi), "labelled synthetic scenes and data variants"))
    kernels = []
    # each kernel in bfloat16 at the shape of the first path that runs it;
    # its other shapes beside it
    sources = {
        "creff_qkv_fused": ("arseg_tpu_torch/csrc/creff_qkv_fused.cu",
                            "arseg_tpu/ops/pallas_creff.py:368", "bise18"),
        "creff_qkv_fused_backward": ("arseg_tpu_torch/csrc/creff_qkv_fused_backward.cu",
                                     "none (the JAX custom_vjp re-derives through composed ops)",
                                     "training stage 2"),
        "warp_bilinear": ("arseg_tpu_torch/csrc/warp_bilinear.cu",
                          "arseg_tpu/ops/pallas_warp.py:115", "bise18"),
        "creff_phase2_argmax": ("arseg_tpu_torch/csrc/creff_phase2_argmax.cu",
                                "arseg_tpu/ops/pallas_creff.py:485", "psp18 V1"),
        "creff_phase2_argmax_lr": ("arseg_tpu_torch/csrc/creff_phase2_argmax.cu",
                                   "arseg_tpu/ops/pallas_creff.py:485 and the x2 resize before it",
                                   "psp18 V1"),
        "creff_attention": ("arseg_tpu_torch/csrc/creff_attention.cu",
                            "arseg_tpu/ops/pallas_creff.py:151", "bise18 localNoGroup"),
        "creff_phase2_upsample_argmax": ("arseg_tpu_torch/csrc/creff_phase2_upsample_argmax.cu",
                                         "arseg_tpu/ops/pallas_creff.py:648",
                                         "bise18 fused head"),
        "resize_bilinear_backward": ("arseg_tpu_torch/csrc/resize_bilinear_backward.cu",
                                     "none (the JAX package leaves this backward to XLA)",
                                     "training stage 2 main head x8"),
    }
    keys = ("dims", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "resize_k3_ms")
    for name, (source, replaces, shape) in sources.items():
        s = stats[(name, shape, torch.bfloat16)]
        by_path = {p: launches.get(name, 0) for p, launches in paths.items()}
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"], "library_ms": s["library_ms"],
            "shape": shape, "dims": s["dims"], "launches_by_path": by_path,
            "other_shapes": {k[1]: {x: o[x] for x in keys if x in o} for k, o in stats.items()
                             if k[0] == name and k[1] != shape and k[2] == torch.bfloat16},
        }
        if "resize_k3_ms" in s:
            entry["resize_k3_ms"] = s["resize_k3_ms"]
        if "agreement" in s:
            entry["agreement"] = s["agreement"]
            entry["pixels_differ"] = s["pixels_differ"]
            entry["max_abs_err_is"] = ("largest plain-logit gap between the plain version's "
                                       "class and the kernel's where the maps differ")
        kernels.append(entry)
    print(f"-- total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
