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

Data parallel (inside ``parallel.synced(group)``, the step's
``bn_mode="sync"``): every loss is this rank's share of the whole batch's
loss, so that the ranks' shares, and their gradients, sum to the loss of
one process on the whole batch, as the JAX package's jitted step over a
sharded batch computes it. A mean is this rank's sum over the whole
batch's count. OHEM takes its n_min, its hard count and its kth loss over
the whole batch: the ranks' flat losses are gathered (``gather_rows``, an
all-reduce into a zero-filled buffer, differentiable), every rank computes
the whole batch's OHEM loss from that one sort, and its share is
1/size of it. The gathered losses lie in rank order, which is the whole
batch's order, so the sort, its ties and the kth pixel's gradient are the
one-process step's.
"""

import torch
import torch.nn.functional as F

from arseg_tpu_torch.parallel.group import all_reduce_sum, gather_rows, sync_group

IGNORE_LABEL = 255


def _share(total, count):
    """``total / count`` where both are this rank's: the whole batch's
    count inside ``parallel.synced`` (module docstring)."""
    group = sync_group()
    count = torch.as_tensor(count, device=total.device)
    if group is not None:
        count = all_reduce_sum(count, group)
    return total / count.clamp(min=1)


def _mean(x):
    """``x.mean()``, or this rank's share of the whole batch's inside
    ``parallel.synced``."""
    return x.mean() if sync_group() is None else _share(x.sum(), x.numel())


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
    return _share(losses.sum(), keep.sum())


def cross_entropy(logits, labels, ignore_label=IGNORE_LABEL):
    return nll_loss(F.log_softmax(logits.float(), dim=1), labels, ignore_label)


def bce_with_logits(logits, targets):
    """BCEWithLogitsLoss, mean reduction; logits, targets [N, C]."""
    logits, targets = logits.float(), targets.float()
    losses = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return _mean(losses)


def ohem_ce(logits, labels, thresh=0.7, ignore_label=IGNORE_LABEL):
    """OhemCELoss: the mean of the hard examples' CE (module docstring)."""
    losses, keep = _picked(F.log_softmax(logits.float(), dim=1), labels, ignore_label)
    flat = losses.reshape(-1)
    n_keep = keep.sum()
    group = sync_group()
    if group is not None:  # the whole batch's losses, in its order, on every rank
        flat = gather_rows(flat[None], group).reshape(-1)
        n_keep = all_reduce_sum(n_keep, group)
    n_min = n_keep // 16
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
    loss = torch.where(n_hard >= n_min, enough, top)
    return loss if group is None else loss / group.size


def mse(a, b):
    return _mean((a.float() - b.float()) ** 2)


def kl_div_log_target(log_p, log_q):
    """KLDivLoss(log_target=True, reduction='mean'): the mean over all
    elements of exp(log_q) * (log_q - log_p)."""
    log_p, log_q = log_p.float(), log_q.float()
    return _mean(torch.exp(log_q) * (log_q - log_p))
