from arseg_tpu_torch.gop.pipeline import ARPipeline

__all__ = ["ARPipeline"]
