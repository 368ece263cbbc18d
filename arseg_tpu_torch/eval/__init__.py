from arseg_tpu_torch.eval.metrics import confusion_update, iou_from_hist, miou_from_hist
from arseg_tpu_torch.eval.engine import EvalConstRes, EvalAlterRes

__all__ = [
    "confusion_update",
    "iou_from_hist",
    "miou_from_hist",
    "EvalConstRes",
    "EvalAlterRes",
]
