"""The comparisons that decide ``correct``, and the numbers they print.

Serving: for every sampled pixel the reference's float32 logits are read
at the class the program served; the gap below the reference's best class,
in units of that frame's logit standard deviation, is 0 where the program
picked the reference's class and small where it took the other side of a
near tie. ``gap_max`` is the widest such gap over the sample, ``gap_mean``
its mean over all sampled pixels, ``gap_q9999`` the 99.99th percentile and
``disagree`` the share of pixels whose served class is not the
reference's best.

Training: the loss of each of the first three steps (relative gap), the
norm of each leaf's first gradient as Adam holds it after one step
(``exp_avg / (1 - beta1)``) and of each leaf's change after three steps:
for a leaf the gap between the program's norm and the reference's, over
the larger of the reference's norm of that leaf and of the median leaf;
the worst leaf is the number (``grad_gap``, ``change_gap``; the median
leaf's beside them). A leaf whose reference gradient is under a thousandth
of the median leaf's moves by round-off alone under Adam and is left out
of the change. ``grad_angle`` is 1 - the cosine between the program's and
the reference's whole first gradient.
"""

import math
import statistics

import torch

SKIP_BELOW_MEDIAN = 1e-3


def logit_gaps(logits, served):
    """logits [C, H, W] float32 (reference); served [H, W] class ids ->
    gaps [H, W] in units of the frame's logit standard deviation."""
    best = logits.max(0).values
    picked = logits.gather(0, served.long().unsqueeze(0))[0]
    return (best - picked) / logits.std()


class GapStats:
    def __init__(self):
        self.gaps = []

    def add(self, logits, served):
        self.gaps.append(logit_gaps(logits.float(), served.to(logits.device)).flatten())

    def readings(self):
        if not self.gaps:
            return {"frames_checked": 0}
        g = torch.cat(self.gaps)
        k = max(1, int(round(g.numel() * 1e-4)))
        return {"gap_max": float(g.max()), "gap_mean": float(g.double().mean()),
                "gap_q9999": float(g.topk(k).values[-1]), "disagree": float((g > 0).double().mean()),
                "frames_checked": len(self.gaps)}


def _leaf_gaps(prog, ref, skip=()):
    """A leaf the program has no reading for (no optimizer state) reads 0."""
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys) if keys else 0.0
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def train_readings(prog, ref):
    """prog, ref: {"losses": [3], "grad": {leaf: norm}, "change": {leaf:
    norm}} -> the compared numbers and the worst leaves."""
    med = statistics.median(ref["grad"].values())
    skip = {k for k, v in ref["grad"].items() if v < SKIP_BELOW_MEDIAN * med}
    grad = _leaf_gaps(prog["grad"], ref["grad"])
    change = _leaf_gaps(prog["change"], ref["change"], skip)
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    if not all(math.isfinite(v) for v in prog["losses"]):
        losses = [math.inf]
    worst = lambda d: max(d, key=d.get) if d else None
    a, b = prog["grad_flat"], ref["grad_flat"]
    cos = float(torch.dot(a, b) / (a.norm() * b.norm()).clamp(min=1e-300)) \
        if a.shape == b.shape else 0.0
    return ({"grad_angle": 1.0 - cos,
             "loss_gap": max(losses), "loss_gap_first": losses[0],
             "grad_gap": max(grad.values()), "grad_gap_median": statistics.median(grad.values()),
             "change_gap": max(change.values()),
             "change_gap_median": statistics.median(change.values())},
            {"grad_worst_leaf": worst(grad), "change_worst_leaf": worst(change),
             "change_skipped_leaves": sorted(skip)})


def judge(readings, limits):
    """(correct, {name: {"value", "limit"}}) for every limited reading."""
    out = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name)
        out[name] = {"value": v, "limit": limit}
        if v is None or not math.isfinite(v) or v > limit:
            ok = False
    return ok, out


@torch.no_grad()
def adam_first_grads(optimizer, names, beta1=0.9):
    """The first gradient from Adam's state after one step (exp_avg =
    (1 - beta1) g): ({leaf: norm}, every leaf flattened in name order,
    float64 on the host)."""
    norms, flat = {}, []
    for p, n in sorted(names.items(), key=lambda kv: kv[1]):
        st = optimizer.state.get(p, {})
        if "exp_avg" in st:
            g = st["exp_avg"].double() / (1 - beta1)
            norms[n] = float(g.norm())
            flat.append(g.flatten().cpu())
    return norms, torch.cat(flat) if flat else torch.zeros(0, dtype=torch.float64)
