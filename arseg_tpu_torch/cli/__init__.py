"""The port's command line, counterparts of ``arseg_tpu/cli``: ``train``
(phase 1), ``train_pair`` (phase 2), ``evaluation`` (the mIoU_d
protocol), ``convert`` (checkpoints), ``infer_video`` (class maps of a
decoded sequence or a compressed stream) and ``preprocess`` (the
compressed datasets, over the native video runtime). Each runs as
``python -m arseg_tpu_torch.cli.<name> ...`` with the JAX command's flags,
plus ``--device`` (default ``cuda``) on the four that compute. Several
cards: ``torchrun --nproc_per_node N -m arseg_tpu_torch.cli.<name> ...
--num_devices N``."""
