from arseg_tpu_torch.models.registry import build_model, phase2_argmax_head

__all__ = ["build_model", "phase2_argmax_head"]
