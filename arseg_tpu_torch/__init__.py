"""arseg_tpu_torch: the PyTorch/CUDA port of arseg_tpu for NVIDIA Hopper.

AR-Seg serving of compressed video: the keyframe runs the HR branch, every
other frame of the GOP runs the 0.5x LR branch, and the keyframe feature is
MV-warped to each frame and merged by CReFF local attention. The
hand-written CUDA kernels live in ``csrc/``: ``creff_qkv_fused.cu`` (K1,
fused CReFF module), ``creff_phase2_argmax.cu`` (K3, the module + 1x1 conv +
argmax head of camvid-psp18 V1), ``creff_phase2_upsample_argmax.cu`` (K5,
the module + 1x1 conv + x8 bilinear + argmax head of BiSeNet; K1, K3 and
K5 on ``creff_module.cuh``), ``creff_attention.cu`` (K4, windowed attention
of the other local fusion variants) and ``warp_bilinear.cu`` (K2, MV warp).

Serving: ``gop.ARPipeline`` (a GOP a step, B GOPs a step, or a frame a
call) for camvid-bise18, camvid-psp18, cityscapes-bise18 and
cityscapes-psp18 (``models.build_model``); accuracy: ``eval.EvalConstRes``
and ``eval.EvalAlterRes``, and the mIoU_d protocol
``eval.protocol.run_protocol``; training on one device: FST phase 1 and
both phase-2 stages (``train.trainer.train_phase1`` / ``train_phase2``,
the step in ``train.step``, bf16 with float32 master weights), over the
host-side readers of ``data`` and the checkpoints of
``utils.checkpoint``; data parallel over ``torch.distributed``
(``parallel``); the command line (``cli``: ``train``, ``train_pair``,
``evaluation``, ``convert`` and ``infer_video``, run as ``python -m
arseg_tpu_torch.cli.<name>``), video inference over a pinned, side-stream
GOP feeder (``gop.feeder``) and the native decoder (``gop.video_source``,
``tools.video``). The trainers take every PSPNet backbone the
JAX package's do: ResNet-18/34/50/101/152, DenseNet-121 and SqueezeNet
(``nn/resnet.py``, ``nn/extractors.py``).

Layout: models are ``nn.Module``s in NCHW (channels_last in memory) with the
reference checkpoint's state-dict key names; the public ops
(``ops.warp_feature``, ``ops.creff_local_module_resize``) take NHWC tensors.
Entry points default to ``device="cuda"``.
"""

from arseg_tpu_torch._device import resolve_device, set_f32_parity_mode

__version__ = "0.1.0"

__all__ = ["resolve_device", "set_f32_parity_mode", "__version__"]
