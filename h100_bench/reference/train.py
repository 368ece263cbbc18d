"""The reference's FST phase-2 stage-2 steps (AR-Seg ``train_pair.py:290-410``),
float32, plain PyTorch: the teacher (HR model of the fused class, eval
mode, no gradient) gives the frame's feature and the keyframe's, the
latter warped by the MVs brought to its grid (scaled, then nearest); the
student runs at ``lr_scale`` in train mode with its two aux heads, fuses
with the warped feature, and takes OHEM cross-entropy (0.7) on its three
heads at the frame's size plus the MSE of its fused feature to the
teacher's; Adam (0.9, 0.999, 1e-8) at a cosine learning rate, the final
conv frozen.

``lowp``: a lower precision the steps are computed in (``lowp_mode``:
float8 for the control, bfloat16 for a witness); ``half_batch``: a
fault, each step on the first half of its batch."""

import contextlib
import math

import torch
import torch.nn.functional as F

from reference.model import BiSeNetV1, flow_to_grid, lowp_mode, up_to, warp

THRESH = float(-torch.log(torch.tensor(0.7, dtype=torch.float32)))
IGNORE = 255


def ohem(logits, y):
    px = F.cross_entropy(logits.float(), y.long(), ignore_index=IGNORE, reduction="none")
    px = px.flatten()
    n_min = int((y != IGNORE).sum()) // 16
    hard = px[px > THRESH]
    if hard.numel() >= n_min:
        return hard.mean()
    return px.topk(max(n_min, 1)).values.mean()


def fst_loss(teacher, student, batch, cfg):
    x_full = batch["image"].permute(0, 3, 1, 2)
    hw = tuple(x_full.shape[-2:])
    lr = tuple(int(v * cfg["lr_scale"]) for v in hw)
    with torch.no_grad():
        target = teacher.key(x_full)[1]
        ref = teacher.key(batch["ref_image"].permute(0, 3, 1, 2))[1]
        fx, fy = flow_to_grid(batch["flow"][..., 0], batch["flow"][..., 1], ref.shape[-2:],
                              "nearest")
        ref = warp(ref, fx, fy)
    out16, out32, mid = student.phase1(up_to(x_full, lr, True))
    out, fused = student.phase2(mid, ref)
    y = batch["label"]
    seg = sum(ohem(up_to(o, hw, True), y) for o in (out, out16, out32))
    return seg + ((target - up_to(fused, target.shape[-2:], True)) ** 2).mean()


def fst_steps(cfg, tr, sd_t, sd_s, batches, device, frozen=(), lowp=None, half_batch=False):
    """Steps over ``batches``: {"losses": [...], "grad": {leaf: norm of the
    first gradient}, "change": {leaf: norm of the change after them}}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = cfg.get("reference_kwargs", {})
    teacher = BiSeNetV1(cfg["n_classes"], with_fuse=True, **kw).to(device).eval()
    teacher.load_state_dict(sd_t)
    teacher.requires_grad_(False)
    student = BiSeNetV1(cfg["n_classes"], with_fuse=True, **kw).to(device).train()
    student.load_state_dict(sd_s)
    for prefix in frozen:
        student.get_submodule(prefix).requires_grad_(False)
    named = [(n, p) for n, p in student.named_parameters() if p.requires_grad]
    opt = torch.optim.Adam([p for _, p in named], lr=tr["lr"], betas=(0.9, 0.999), eps=1e-8)
    start = {n: p.detach().clone() for n, p in named}
    out = {"losses": []}
    for i, b in enumerate(batches):
        b = {k: v.to(device) for k, v in b.items()}
        if half_batch:
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        for group in opt.param_groups:
            group["lr"] = tr["lr"] * 0.5 * (1.0 + math.cos(math.pi * i / tr["t_max"]))
        opt.zero_grad(set_to_none=True)
        with lowp_mode(lowp) if lowp is not None else contextlib.nullcontext():
            loss = fst_loss(teacher, student, b, cfg)
            loss.backward()
        opt.step()
        out["losses"].append(float(loss.detach()))
        if i == 0:
            g = {n: opt.state[p]["exp_avg"].double() / 0.1 for n, p in named}
            out["grad"] = {n: float(v.norm()) for n, v in g.items()}
            out["grad_flat"] = torch.cat([g[n].flatten().cpu() for n in sorted(g)])
    with torch.no_grad():
        out["change"] = {n: float((p - start[n]).norm()) for n, p in named}
    return out
