"""Confusion-histogram mIoU — port of ``arseg_tpu/eval/metrics.py``.

Per batch, ``bincount(label * n + pred)`` over the pixels whose label is not
the ignore label, added to an [n, n] histogram (rows: label, columns:
prediction); IoU = diag / (column sum + row sum - diag); mIoU is the plain
mean, so a class absent from both label and prediction gives NaN and makes
the mean NaN, as in the reference; ``nanmean=True`` skips it.

The histogram counts in int64. The JAX histogram is float32: the two agree
exactly while every cell stays under 2^24 counts, and the JAX one rounds
past that. The histogram all-reduce of data-parallel eval is not ported.
"""

import torch


def confusion_update(hist, label, pred, n_classes: int, ignore_label: int = 255):
    """hist [n, n] + the bincount of this batch's non-ignored pixels.
    label, pred: integer tensors of one shape. Indices past the histogram
    (labels >= n other than the ignore label) are dropped, as the JAX
    scatter drops them."""
    label = label.reshape(-1).long()
    pred = pred.reshape(-1).long()
    keep = label != ignore_label
    cells = n_classes * n_classes
    idx = label[keep] * n_classes + pred[keep]
    counts = torch.bincount(idx, minlength=cells)[:cells]
    return hist + counts.reshape(n_classes, n_classes).to(hist.dtype)


def iou_from_hist(hist):
    hist = hist.double()
    diag = torch.diagonal(hist)
    return diag / (hist.sum(dim=0) + hist.sum(dim=1) - diag)


def miou_from_hist(hist, nanmean: bool = False):
    ious = iou_from_hist(hist)
    return ious.nanmean() if nanmean else ious.mean()
