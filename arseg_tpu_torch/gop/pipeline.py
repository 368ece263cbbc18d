"""GOP AR inference pipeline — port of ``arseg_tpu/gop/pipeline.py``
(``ARPipeline._gop_step`` with batched phase 1, and ``scan_step``).

Per GOP: the HR model runs on the keyframe (``forward_key``); the G-1
other frames are resized to the LR scale and run through the LR model's
phase 1 in one batch; the flow planes are resized to the feature grid; the
keyframe feature is MV-warped to every frame (K2) and fused with each
frame's LR feature by CReFF, all G-1 frames in one launch each. The head is
the model's ``forward_phase2_argmax`` where ``phase2_argmax_head`` allows
it: camvid-bise18 fuses with K1 (K4 for the other local fusion variants)
and takes the planes head (1x1 conv, x8 bilinear, argmax), or K5 for
fusion and head under ``nn/bisenet.USE_FUSED_UPSAMPLE_HEAD``;
camvid-psp18 V1 fuses at full resolution and runs K3
(module, 1x1 conv and argmax in one kernel). Elsewhere (camvid-psp18 V2)
``forward_phase2`` -> resize -> argmax.

Each stage runs under a ``torch.profiler.record_function`` span named
``gop.<stage>`` (a no-op unless a profiler is recording), which
``tools_torch_profile_gop.py`` reads.
"""

import copy

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.models.registry import phase2_argmax_head
from arseg_tpu_torch.ops.warp import _resize_plane_bilinear, warp_feature


def _resize_flow_planes(flow_planes, feat_hw):
    """(fx, fy) [n, Hf, Wf] -> planes at feat_hw: bilinear align_corners=True,
    then the magnitude rescale feat_h / Hf (exact for power-of-two scales,
    so the order against the resize does not matter there)."""
    fx, fy = flow_planes
    # a host scalar: a tensor copied to the device would wait for its queue
    s = torch.tensor(feat_hw[0] / fx.shape[-2], dtype=torch.float32)
    fx = _resize_plane_bilinear(fx.float(), feat_hw, True) * s
    fy = _resize_plane_bilinear(fy.float(), feat_hw, True) * s
    return fx, fy


def _nchw(x):
    """NHWC tensor -> NCHW view (channels_last in memory when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


class ARPipeline:
    """Batched AR inference over one GOP.

    hr_model / lr_model: registry models (lr_model built with fuse=True;
    for camvid-psp18 V2 the HR model too, with fuse_version=2, so that
    ``forward_key`` returns the backbone feature CReFF takes).
    The pipeline keeps its own copies of them on ``device`` in ``dtype``
    (channels_last, eval mode); the caller's modules are not changed.
    scale: LR branch scale. normalize=(mean, std): frames may be raw uint8
    and are normalised on the device in float32, (x/255 - mean) / std.
    """

    def __init__(self, hr_model, lr_model, scale=0.5, dtype=torch.float32, normalize=None,
                 device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scale = scale

        def place(m):
            m = copy.deepcopy(m).to(self.device, dtype).eval()
            return m.to(memory_format=torch.channels_last)

        self.hr_model = place(hr_model)
        self.lr_model = place(lr_model)
        self.normalize = None
        if normalize is not None:
            mean, std = (torch.as_tensor(v, dtype=torch.float32, device=self.device)
                         for v in normalize)
            self.normalize = (mean, std)

    def _frames(self, x):
        """Move NHWC frames to the device, normalise raw uint8 frames (float
        frames are taken as already normalised), cast to the serving dtype,
        and return NCHW channels_last."""
        x = torch.as_tensor(x, device=self.device)
        if self.normalize is not None and x.dtype == torch.uint8:
            mean, std = self.normalize
            x = (x.float() / 255.0 - mean) / std
        return _nchw(x.to(self.dtype).contiguous())

    @torch.inference_mode()
    def gop_step(self, keyframe, frames, flows, return_fused=False):
        """keyframe [1, H, W, 3]; frames [G-1, H, W, 3] (NHWC, uint8 or
        float); flows (fx, fy) [G-1, Hf, Wf] planes or a packed
        [G-1, Hf, Wf, 2] array, in pixels of the flow grid.
        Returns int32 class maps [G, H, W] (keyframe first); with
        return_fused also the fused features [G-1, h, w, C] (NHWC)."""
        g1, h, w = frames.shape[:3]
        with record_function("gop.hr_key"):
            key_logits, ref_feat = self.hr_model.forward_key(self._frames(keyframe))

        with record_function("gop.flow_resize"):
            if isinstance(flows, tuple):
                fx, fy = flows
            else:
                fx, fy = flows[..., 0], flows[..., 1]
            fx = torch.as_tensor(fx, device=self.device)
            fy = torch.as_tensor(fy, device=self.device)
            fx, fy = _resize_flow_planes((fx, fy), tuple(ref_feat.shape[-2:]))

        with record_function("gop.lr_phase1"):
            lr_hw = (int(h * self.scale), int(w * self.scale))
            x_lr = F.interpolate(self._frames(frames), size=lr_hw, mode="bilinear",
                                 align_corners=True)
            feat = self.lr_model.forward_phase1(x_lr, with_aux=False)

        with record_function("gop.warp"):
            warped = _nchw(warp_feature(ref_feat.permute(0, 2, 3, 1), (fx, fy)))
        with record_function("gop.fuse_head"):
            head = phase2_argmax_head(self.lr_model, warped.shape[-2:], (h, w))
            if head is not None:
                preds = head(feat, warped, return_fused=return_fused)
                if return_fused:
                    preds, fused = preds
            else:
                logits, fused = self.lr_model.forward_phase2(feat, warped)
                logits = F.interpolate(logits, size=(h, w), mode="bilinear",
                                       align_corners=True)
                preds = logits.argmax(dim=1).to(torch.int32)

        with record_function("gop.key_argmax"):
            if tuple(key_logits.shape[-2:]) != (h, w):
                key_logits = F.interpolate(key_logits, size=(h, w), mode="bilinear",
                                           align_corners=True)
            preds = torch.cat([key_logits.argmax(dim=1).to(torch.int32), preds], dim=0)
        if return_fused:
            return preds, fused.permute(0, 2, 3, 1)
        return preds

    def __call__(self, keyframe, frames, flows):
        return self.gop_step(keyframe, frames, flows)

    def scan_step(self, keyframes, frames, fx, fy):
        """Clip mode: K GOPs one after another. keyframes [K, H, W, 3];
        frames [K, G-1, H, W, 3]; fx, fy [K, G-1, Hf, Wf] -> int32
        [K, G, H, W]. Each GOP is exactly ``gop_step``."""
        return torch.stack([
            self.gop_step(keyframes[k : k + 1], frames[k], (fx[k], fy[k]))
            for k in range(keyframes.shape[0])
        ])
