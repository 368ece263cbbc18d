"""Training losses — port of ``arseg_tpu/train/losses.py``. Logits and
log-probabilities are NCHW (the class axis is 1, as torch's losses take
them); labels [N, H, W] integers with 255 ignored.

The reference's loss surface (``train.py:210-216``,
``train_pair.py:291-302``): PSPNet-CamVid NLL on log-softmax outputs +
alpha * BCE-with-logits on the class-presence head; PSPNet-Cityscapes CE +
0.4 * aux CE; BiSeNet OHEM CE (0.7) on three heads; FST the MSE between the
teacher's and the student's features.

All loss math runs in float32: under bf16 training the model emits bf16
logits and features, and a bf16 log-softmax or mean over 1e5+ pixels loses
mantissa. The cast is the identity for float32 inputs.

OHEM (``model/bisenet.py:600-614``): keep the per-pixel CE losses above
-log(0.7); if fewer than n_min = n_valid // 16 qualify, take the mean of the
n_min largest. Written as the JAX package writes it, without a
data-dependent shape: the sum of the n_min largest losses is sum(loss >
kth) + kth * (the tied slots), kth the n_min-th largest, from one sort.
That equals topk(n_min).mean() with ties at kth, at kth == 0 (fewer
positive losses than n_min) and when every pixel is ignored, and it needs
no read of the device from the host.
"""

import torch
import torch.nn.functional as F

IGNORE_LABEL = 255


def _picked(log_probs, labels, ignore_label):
    """(-log p of each pixel's label, zero where ignored; the kept mask)."""
    keep = labels != ignore_label
    safe = torch.where(keep, labels, torch.zeros_like(labels)).long()
    picked = log_probs.gather(1, safe.unsqueeze(1)).squeeze(1)
    return -picked * keep, keep


def nll_loss(log_probs, labels, ignore_label=IGNORE_LABEL):
    """log_probs [N, C, H, W] (log-softmax), labels [N, H, W]: the mean over
    the kept pixels (0 when none is kept)."""
    losses, keep = _picked(log_probs.float(), labels, ignore_label)
    return losses.sum() / keep.sum().clamp(min=1)


def cross_entropy(logits, labels, ignore_label=IGNORE_LABEL):
    return nll_loss(F.log_softmax(logits.float(), dim=1), labels, ignore_label)


def bce_with_logits(logits, targets):
    """BCEWithLogitsLoss, mean reduction; logits, targets [N, C]."""
    logits, targets = logits.float(), targets.float()
    losses = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return losses.mean()


def ohem_ce(logits, labels, thresh=0.7, ignore_label=IGNORE_LABEL):
    """OhemCELoss: the mean of the hard examples' CE (module docstring)."""
    losses, keep = _picked(F.log_softmax(logits.float(), dim=1), labels, ignore_label)
    flat = losses.reshape(-1)
    n_min = keep.sum() // 16
    # -log(thresh) in float32, as the JAX package computes it; a host scalar
    t = float(-torch.log(torch.tensor(thresh, dtype=torch.float32)))
    hard = flat > t
    n_hard = hard.sum()
    enough = (flat * hard).sum() / n_hard.clamp(min=1)

    kth_at = (n_min - 1).clamp(0, flat.numel() - 1).reshape(1)
    kth = torch.sort(flat, descending=True).values.index_select(0, kth_at)[0]
    above = flat > kth
    n = n_min.clamp(min=1)
    top = ((flat * above).sum() + kth * (n - above.sum())) / n
    return torch.where(n_hard >= n_min, enough, top)


def mse(a, b):
    return ((a.float() - b.float()) ** 2).mean()


def kl_div_log_target(log_p, log_q):
    """KLDivLoss(log_target=True, reduction='mean'): the mean over all
    elements of exp(log_q) * (log_q - log_p)."""
    log_p, log_q = log_p.float(), log_q.float()
    return (torch.exp(log_q) * (log_q - log_p)).mean()
