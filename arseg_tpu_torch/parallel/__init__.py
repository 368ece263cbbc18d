"""Data parallelism over torch.distributed (``parallel/group.py``): the
counterpart of ``arseg_tpu/parallel``."""

from arseg_tpu_torch.parallel.group import (DataGroup, data_group, gather_rows, psum_hist,
                                            replicate, shard_batch, synced)

__all__ = ["DataGroup", "data_group", "gather_rows", "psum_hist", "replicate", "shard_batch",
           "synced"]
