"""The reference's AR inference of one GOP's frames, float32 (or the fp8
control), frame by frame: the keyframe through the HR model; a frame at
GOP position p > 0 through the AR model's LR phase 1 at ``lr_scale``, its
MVs brought to the keyframe feature's grid, the keyframe feature warped by
them, the CReFF fusion and the x8 head."""

import torch
import torch.nn.functional as F

from reference.model import flow_to_grid, warp


def normalized(frames_u8, mean, std):
    """uint8 NHWC -> float32 NCHW, (x / 255 - mean) / std."""
    x = frames_u8.float() / 255.0
    x = (x - torch.as_tensor(mean, device=x.device)) / torch.as_tensor(std, device=x.device)
    return x.permute(0, 3, 1, 2).contiguous()


@torch.no_grad()
def gop_logits(hr, ar, keyframe, frames, flows, positions, cfg, flow_mode="bilinear"):
    """keyframe [1, H, W, 3] uint8; frames {p: [1, H, W, 3]}, flows
    {p: (fx, fy) [1, H, W]} for p in positions (p > 0), on the device.
    Yields (p, logits [C, H, W]) for each position, 0 being the keyframe."""
    mean, std = cfg["normalize"]["mean"], cfg["normalize"]["std"]
    hw = tuple(cfg["frame_hw"])
    lr = tuple(int(v * cfg["lr_scale"]) for v in hw)
    key_logits, feat = hr.key(normalized(keyframe, mean, std))
    for p in positions:
        if p == 0:
            yield 0, F.interpolate(key_logits, size=hw, mode="bilinear", align_corners=True)[0] \
                if tuple(key_logits.shape[-2:]) != hw else key_logits[0]
            continue
        x = F.interpolate(normalized(frames[p], mean, std), size=lr, mode="bilinear",
                          align_corners=True)
        mid = ar.phase1(x)[-1]
        fx, fy = flow_to_grid(*flows[p], feat.shape[-2:], flow_mode)
        logits, _ = ar.phase2(mid, warp(feat, fx, fy))
        yield p, logits[0]
