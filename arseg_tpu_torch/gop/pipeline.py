"""GOP AR inference pipeline — port of ``arseg_tpu/gop/pipeline.py``
(``ARPipeline._gop_step`` with batched phase 1, ``_multi_gop_step``,
``scan_step`` and ``streaming_step``).

Per GOP: the HR model runs on the keyframe (``forward_key``); the G-1
other frames are resized to the LR scale and run through the LR model's
phase 1 in one batch; the flow planes are resized to the feature grid; the
keyframe feature is MV-warped to every frame (K2) and fused with each
frame's LR feature by CReFF, all G-1 frames in one launch each. The head is
the model's ``forward_phase2_argmax`` where ``phase2_argmax_head`` allows
it: the BiSeNets fuse with K1 (K4 for the other local fusion variants)
and take the planes head (1x1 conv, x8 bilinear, argmax), or K5 for
fusion and head under ``nn/bisenet.USE_FUSED_UPSAMPLE_HEAD``;
camvid-psp18 V1 fuses at full resolution and runs K3
(module, 1x1 conv and argmax in one kernel). Elsewhere (camvid-psp18 V2,
cityscapes-psp18, whose fusion is K1) ``forward_phase2`` -> resize ->
argmax, the resize and argmax in one kernel on the card
(``ops/resize_argmax_kernel``).

Flows reach the feature grid two ways, each as its JAX counterpart takes
them: ``gop_step`` resizes the planes and then rescales their magnitude
(``_resize_flow_planes``), ``streaming_step`` and the eval engines rescale
and then resize (``ops/warp.scale_and_resize_flow``). Bilinear resizing is
linear, so the two give the same planes up to float32 rounding, and
exactly at power-of-two ratios, as from a frame-sized flow to a 1/8 or
full-size feature. Keeping each path's order keeps each bit for bit with the
JAX function of the same path, which the CPU parity tests hold.

``multi_gop_step`` (and ``gop_step`` given 5-D frames) batches B GOPs: one
HR forward over the B keyframes, and phase 1, warp, fusion and head over
all B*(G-1) frames, one launch each; K2 reads each GOP's keyframe feature
in place. The JAX step maps warp, fusion and head over the frames one at a
time (``lax.map``), which bounded memory and compile time on the TPU; here
they run batched. ``streaming_step`` serves a frame a call with the
keyframe feature kept on the device between calls.

Data parallel (``parallel.DataGroup``, one process per card, every rank
calling with the same inputs): ``sharded_step`` serves S streams, each rank
its S/n, and ``gop_parallel_step`` spreads one GOP's frames over the ranks,
each rank computing the keyframe's HR branch itself; both put the maps
together with ``parallel.gather_rows`` (the counterparts of
``arseg_tpu/gop/pipeline.py:392-478``).

Each stage runs under a ``torch.profiler.record_function`` span named
``gop.<stage>`` (a no-op unless a profiler is recording), which
``tools_torch_profile_gop.py`` reads, and the benchmark's per-layer
readers too (``h100_bench/metrics``: ``lr_phase1_ms.serve``,
``fuse_head_ms.serve``, ``resize_argmax_ms.serve``, and the idle gaps of
its traced runs). Inside ``gop.fuse_head``, the resize-and-argmax head runs
under ``gop.head_chunk`` (once a launch on the card, once a chunk of frames
on the CPU), in this fallback head and in BiSeNet's planes head.
"""

import copy

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.models.registry import phase2_argmax_head
from arseg_tpu_torch.ops.resize_argmax_kernel import resized_argmax
from arseg_tpu_torch.ops.warp import _resize_plane_bilinear, scale_and_resize_flow, warp_feature
from arseg_tpu_torch.parallel.group import check_group, gather_rows, pad_rows, shard_batch


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


def place_model(model, device, dtype=None):
    """A copy of ``model`` on ``device``, in ``dtype`` unless None, in eval
    mode and channels_last; the caller's module is not changed."""
    m = copy.deepcopy(model).to(device).eval()
    if dtype is not None:
        m = m.to(dtype)
    return m.to(memory_format=torch.channels_last)


def device_frames(x, device, dtype=None, normalize=None):
    """NHWC frames -> NCHW (channels_last in memory) on ``device``. With
    normalize=(mean, std) tensors on the device, raw uint8 frames become
    (x/255 - mean) / std in float32 (float frames are taken as already
    normalised); then the cast to ``dtype`` unless None."""
    x = torch.as_tensor(x, device=device)
    if normalize is not None and x.dtype == torch.uint8:
        mean, std = normalize
        x = (x.float() / 255.0 - mean) / std
    if dtype is not None:
        x = x.to(dtype)
    return _nchw(x.contiguous())


class ARPipeline:
    """Batched AR inference over one GOP.

    hr_model / lr_model: registry models (lr_model built with fuse=True;
    for camvid-psp18 V2 the HR model too, with fuse_version=2, so that
    ``forward_key`` returns the backbone feature CReFF takes).
    The pipeline keeps its own copies of them on ``device`` in ``dtype``
    (the models' own dtype if None; channels_last, eval mode); the caller's
    modules are not changed.
    scale: LR branch scale. normalize=(mean, std): frames may be raw uint8
    and are normalised on the device in float32, (x/255 - mean) / std.
    """

    def __init__(self, hr_model, lr_model, scale=0.5, dtype=torch.float32, normalize=None,
                 device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.scale = scale
        self.hr_model = place_model(hr_model, self.device, dtype)
        self.lr_model = place_model(lr_model, self.device, dtype)
        self.normalize = None
        if normalize is not None:
            mean, std = (torch.as_tensor(v, dtype=torch.float32, device=self.device)
                         for v in normalize)
            self.normalize = (mean, std)

    def _frames(self, x):
        """``device_frames`` with the pipeline's device, dtype and
        normalisation."""
        return device_frames(x, self.device, self.dtype, self.normalize)

    def _flow_planes(self, flows):
        """(fx, fy) planes on the device from a tuple of planes or a packed
        [..., 2] array."""
        fx, fy = flows if isinstance(flows, tuple) else (flows[..., 0], flows[..., 1])
        return torch.as_tensor(fx, device=self.device), torch.as_tensor(fy, device=self.device)

    def _lr_feature(self, frames, hw):
        """LR phase 1 of NHWC frames [n, H, W, 3] at ``scale``."""
        lr_hw = (int(hw[0] * self.scale), int(hw[1] * self.scale))
        x_lr = F.interpolate(self._frames(frames), size=lr_hw, mode="bilinear",
                             align_corners=True)
        return self.lr_model.forward_phase1(x_lr, with_aux=False)

    def _fuse_branch(self, feat, ref_feat, flow_planes, out_hw, return_fused=False):
        """Warp + CReFF + head for frames whose phase-1 features are
        computed: feat [n, C, h1, w1]; ref_feat [S, C, hf, wf], frame i
        taking keyframe feature i // (n // S); flow planes at the keyframe
        feature's grid. Returns int32 maps [n, *out_hw] (and the fused
        feature, NCHW, with return_fused)."""
        with record_function("gop.warp"):
            warped = _nchw(warp_feature(ref_feat.permute(0, 2, 3, 1), flow_planes))
        with record_function("gop.fuse_head"):
            head = phase2_argmax_head(self.lr_model, warped.shape[-2:], out_hw)
            if head is not None:
                return head(feat, warped, return_fused=return_fused)
            logits, fused = self.lr_model.forward_phase2(feat, warped)
            preds = self._resized_argmax(logits, out_hw)
            return (preds, fused) if return_fused else preds

    @staticmethod
    def _resized_argmax(logits, out_hw):
        """int32 maps [n, *out_hw]: the argmax of the logits resized to
        out_hw (align_corners=True), ``ops/resize_argmax_kernel``'s: one
        kernel launch on a card, the resize and argmax over ``frame_chunks``
        on the CPU; each under a ``gop.head_chunk`` span."""
        return resized_argmax(logits, out_hw, align_corners=True)

    def _key_maps(self, key_logits, hw):
        with record_function("gop.key_argmax"):
            if tuple(key_logits.shape[-2:]) != tuple(hw):
                key_logits = F.interpolate(key_logits, size=tuple(hw), mode="bilinear",
                                           align_corners=True)
            return key_logits.argmax(dim=1).to(torch.int32)

    @torch.inference_mode()
    def gop_step(self, keyframe, frames, flows, return_fused=False):
        """keyframe [1, H, W, 3]; frames [G-1, H, W, 3] (NHWC, uint8 or
        float); flows (fx, fy) [G-1, Hf, Wf] planes or a packed
        [G-1, Hf, Wf, 2] array, in pixels of the flow grid.
        Returns int32 class maps [G, H, W] (keyframe first); with
        return_fused also the fused features [G-1, h, w, C] (NHWC).
        5-D frames [B, G-1, H, W, 3] (keyframes [B, H, W, 3]) go to
        ``multi_gop_step``, as in the JAX step."""
        if frames.ndim == 5:
            return self.multi_gop_step(keyframe, frames, flows, return_fused)
        flows = tuple(f[None] for f in flows) if isinstance(flows, tuple) else flows[None]
        out = self.multi_gop_step(keyframe, frames[None], flows, return_fused)
        return (out[0][0], out[1]) if return_fused else out[0]

    @torch.inference_mode()
    def multi_gop_step(self, keyframes, frames, flows, return_fused=False):
        """Throughput mode: B GOPs in one step. keyframes [B, H, W, 3];
        frames [B, G-1, H, W, 3]; flows (fx, fy) [B, G-1, Hf, Wf] or packed
        [B, G-1, Hf, Wf, 2]. Returns int32 [B, G, H, W] (with return_fused
        also the fused features [B*(G-1), h, w, C], NHWC). The HR forward
        runs over the B keyframes, phase 1 over the B*(G-1) frames, and the
        warp (K2 reading GOP i's keyframe feature for its frames, in place),
        the fusion and the head over all B*(G-1) frames, one launch each."""
        b, g1, h, w = frames.shape[:4]
        with record_function("gop.hr_key"):
            key_logits, ref_feat = self.hr_model.forward_key(self._frames(keyframes))

        with record_function("gop.flow_resize"):
            fx, fy = self._flow_planes(flows)
            fx, fy = _resize_flow_planes((fx.reshape(b * g1, *fx.shape[2:]),
                                          fy.reshape(b * g1, *fy.shape[2:])),
                                         tuple(ref_feat.shape[-2:]))

        with record_function("gop.lr_phase1"):
            feat = self._lr_feature(frames.reshape(b * g1, *frames.shape[2:]), (h, w))

        out = self._fuse_branch(feat, ref_feat, (fx, fy), (h, w), return_fused)
        preds, fused = out if return_fused else (out, None)
        key = self._key_maps(key_logits, (h, w))
        preds = torch.cat([key[:, None], preds.reshape(b, g1, h, w)], dim=1)
        if return_fused:
            return preds, fused.permute(0, 2, 3, 1)
        return preds

    def streaming_step(self):
        """Latency mode, a frame a call: returns (key_step, frame_step).
        ``key_step(keyframe [1, H, W, 3])`` -> (int32 map [1, H, W],
        ref_feat); ``frame_step(ref_feat, frame [1, H, W, 3], flow)`` ->
        int32 map [1, H, W], flow being (fx, fy) [1, Hf, Wf] planes or a
        packed [1, Hf, Wf, 2] array. ref_feat, the state between calls,
        stays on the device. A frame takes the same warp, fusion and head
        as ``gop_step``."""

        @torch.inference_mode()
        def key_step(keyframe):
            x = self._frames(keyframe)
            key_logits, ref_feat = self.hr_model.forward_key(x)
            return self._key_maps(key_logits, x.shape[-2:]), ref_feat

        @torch.inference_mode()
        def frame_step(ref_feat, frame, flow):
            hw = tuple(frame.shape[1:3])
            planes = scale_and_resize_flow(self._flow_planes(flow), tuple(ref_feat.shape[-2:]),
                                           mode="bilinear", split=True)
            return self._fuse_branch(self._lr_feature(frame, hw), ref_feat, planes, hw)

        return key_step, frame_step

    def __call__(self, keyframe, frames, flows):
        return self.gop_step(keyframe, frames, flows)

    def sharded_step(self, group):
        """Multi-stream serving over a ``parallel.DataGroup``: S independent
        streams, each rank running its S/n (contiguous) streams batched
        (``multi_gop_step``: one HR forward, one phase-1 forward and one
        launch of each kernel for all of them), no traffic between ranks
        until the maps are put together.
        Returns fn(keyframes [S, H, W, 3], frames [S, G-1, H, W, 3], fx, fy
        [S, G-1, Hf, Wf]) -> int32 maps [S, G, H, W] of every stream, on
        every rank; each rank reads only its streams' rows. S must be a
        multiple of the group's size."""
        group = check_group(group)

        @torch.inference_mode()
        def fn(keyframes, frames, fx, fy):
            local = shard_batch(dict(kf=keyframes, fr=frames, fx=fx, fy=fy), group)
            maps = self.multi_gop_step(local["kf"], local["fr"], (local["fx"], local["fy"]))
            return gather_rows(maps, group)

        return fn

    def gop_parallel_step(self, group):
        """Latency scale-out for one stream over a ``parallel.DataGroup``:
        every rank runs the HR branch on the keyframe, and the GOP's G-1
        frames, zero-padded to a multiple of n, are spread over the ranks,
        each running phase 1, the warp, the fusion and the head on its
        frames. The maps are gathered and the pad frames' dropped. Returns
        fn with ``gop_step``'s single-GOP signature (keyframe [1, H, W, 3],
        frames [G-1, H, W, 3], flows (fx, fy) [G-1, Hf, Wf] or packed
        [G-1, Hf, Wf, 2]) -> int32 maps [G, H, W], on every rank."""
        group = check_group(group)
        n = 1 if group is None else group.size

        @torch.inference_mode()
        def fn(keyframe, frames, flows):
            fx, fy = flows if isinstance(flows, tuple) else (flows[..., 0], flows[..., 1])
            g1 = frames.shape[0]
            local = shard_batch(pad_rows(dict(fr=frames, fx=fx, fy=fy), n), group)
            out = self.gop_step(keyframe, local["fr"], (local["fx"], local["fy"]))
            maps = gather_rows(out[1:], group)[:g1]
            return torch.cat([out[:1], maps])

        return fn

    def scan_step(self, keyframes, frames, fx, fy):
        """Clip mode: K GOPs one after another. keyframes [K, H, W, 3];
        frames [K, G-1, H, W, 3]; fx, fy [K, G-1, Hf, Wf] -> int32
        [K, G, H, W]. Each GOP is exactly ``gop_step``."""
        return torch.stack([
            self.gop_step(keyframes[k : k + 1], frames[k], (fx[k], fy[k]))
            for k in range(keyframes.shape[0])
        ])
