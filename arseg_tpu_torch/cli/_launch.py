"""Process-group start-up of the command-line entry points: what the JAX
commands get from ``data_mesh``.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) with no group yet,
``launched`` joins the group torchrun describes, ``nccl`` for a CUDA device
and ``gloo`` for the CPU, and leaves it when the command ends. A group the
caller initialised is used as it is. ``--num_devices`` (``--gop_devices``
of ``infer_video``) above 1 in a single process is an error that says how
to launch: no process is spawned here.
"""

import contextlib
import os

import torch.distributed as dist

from arseg_tpu_torch._device import resolve_device


@contextlib.contextmanager
def launched(num_devices, device, command, flag="--num_devices"):
    """Inside the block, the process group of the run is initialised when
    there is one (module docstring). ``flag`` names the option that gave
    ``num_devices`` in the error."""
    created = False
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
            dist.init_process_group(backend)
            created = True
        elif num_devices is not None and num_devices > 1:
            raise SystemExit(
                f"{flag} {num_devices} runs one process per device: launch with "
                f"torchrun --nproc_per_node {num_devices} -m arseg_tpu_torch.cli.{command} ...")
    try:
        yield
    finally:
        if created:
            dist.destroy_process_group()
