"""The port's offline command line, counterparts of ``arseg_tpu/cli``:
``train`` (phase 1), ``train_pair`` (phase 2), ``evaluation`` (the mIoU_d
protocol) and ``convert`` (checkpoints). Each runs as
``python -m arseg_tpu_torch.cli.<name> ...`` with the JAX command's flags,
plus ``--device`` (default ``cuda``) on the three that compute. Several
cards: ``torchrun --nproc_per_node N -m arseg_tpu_torch.cli.<name> ...
--num_devices N``."""
