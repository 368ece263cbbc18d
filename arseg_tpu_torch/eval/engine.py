"""Evaluation engines — port of ``arseg_tpu/eval/engine.py``: the
reference's EvalConstRes and EvalAlterRes over a loader of batches.

A loader yields dicts of NHWC arrays (numpy or tensors): ``image`` (frames
already normalised) and ``label`` (int, the ignore label where a pixel is
not scored); EvalAlterRes also reads ``ref_image`` (the decoded keyframe of
each frame) and ``flow`` [..., 2], split into (fx, fy) planes on the host.

EvalConstRes: downscale (bilinear, align_corners=True) -> forward -> logits
resized to the label's size (align_corners=True) -> argmax -> histogram.
EvalAlterRes (the AR path) runs an ``ARPipeline`` over the two models, so
that it measures the maps the pipeline serves: the HR model's
``forward_key`` on ref_image, taking its feature -> the flow
magnitude-rescaled and resized to the feature's grid (bilinear) -> the
LR model's phase 1 on the downscaled image -> the pipeline's
``_fuse_branch`` (K2 with one source per frame, the fusion, and the head
``phase2_argmax_head`` picks, else forward_phase2 -> resize -> argmax) ->
histogram. ``predictions`` yields each batch's labels and class maps; the
histogram stays on the device and comes back once, at the end.

``dtype`` casts the frames and copies of the models, as ``ARPipeline``
does; the caller's models are not changed. Models run in eval mode.

The JAX engines pad a ragged last batch (``_equalized``, ``_pad_rows``) to
the first batch's row count, so that every step shares one compiled shape.
Eager PyTorch needs no fixed shape, and padded rows carry the ignore label
and add nothing to the histogram, so the port runs each batch as it comes
and the result is the same.

``mesh`` (a ``parallel.DataGroup`` of n ranks, each running the engine on
the same loader): each batch is padded to a multiple of n rows, the pad
rows zero frames and flows with the ignore label (``engine.py:199-201`` of
the JAX package), and each rank runs its contiguous rows and counts them
into its int64 histogram; ``histogram`` returns the ranks' sum
(``parallel.psum_hist``), the same on every rank. ``predictions`` yields
this rank's rows. The JAX ``prefetch`` (a host stage that stages batches on
the device ahead) is not ported.
"""

import torch
import torch.nn.functional as F

from arseg_tpu_torch._device import resolve_device
from arseg_tpu_torch.eval.metrics import confusion_update, miou_from_hist
from arseg_tpu_torch.gop.pipeline import ARPipeline, device_frames, place_model
from arseg_tpu_torch.ops.warp import scale_and_resize_flow
from arseg_tpu_torch.parallel.group import check_group, pad_rows, psum_hist, shard_batch


def _resize(x, hw):
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class _Engine:
    def __init__(self, scale=0.5, ignore_label=255, nanmean=False, mesh=None, dtype=None,
                 device=None):
        self.scale = scale
        self.ignore_label = ignore_label
        self.nanmean = nanmean
        self.mesh = check_group(mesh)
        self.dtype = dtype
        self.device = resolve_device(device if device is not None or mesh is None
                                     else mesh.device)

    def _batches(self, loader):
        """The loader's batches, each cut to this rank's rows under a mesh."""
        n = 1 if self.mesh is None else self.mesh.size
        for batch in loader:
            yield shard_batch(pad_rows(batch, n, {"label": self.ignore_label}), self.mesh)

    def _label(self, batch):
        return torch.as_tensor(batch["label"], device=self.device)

    def _histogram(self, predictions, n_classes, progress):
        """The int64 confusion histogram [n, n] of the (label, map) pairs,
        on the device, summed over the mesh's ranks."""
        hist = torch.zeros((n_classes, n_classes), dtype=torch.int64, device=self.device)
        with torch.inference_mode():
            for label, pred in predictions:
                hist = confusion_update(hist, label, pred, n_classes, self.ignore_label)
                if progress:
                    progress()
            return psum_hist(hist, self.mesh)

    def __call__(self, *args, **kwargs):
        """The mIoU of ``histogram(*args, **kwargs)``, as a float."""
        return float(miou_from_hist(self.histogram(*args, **kwargs).cpu(), self.nanmean))


class EvalConstRes(_Engine):
    """Constant-resolution eval: ``__call__(model, loader, n_classes)`` ->
    mIoU; ``histogram`` with the same arguments gives the histogram. The
    model's ``forward`` output's first element is the logits."""

    @torch.inference_mode()
    def predictions(self, model, loader):
        """(label, int32 class map) of each batch (this rank's rows under a
        mesh), on the device."""
        model = place_model(model, self.device, self.dtype)
        for batch in self._batches(loader):
            label = self._label(batch)
            image = device_frames(batch["image"], self.device, self.dtype)
            h, w = image.shape[-2:]
            out = model(_resize(image, (int(h * self.scale), int(w * self.scale))))
            logits = out[0] if isinstance(out, tuple) else out
            yield label, _resize(logits, label.shape[1:3]).argmax(dim=1).to(torch.int32)

    def histogram(self, model, loader, n_classes, progress=None):
        return self._histogram(self.predictions(model, loader), n_classes, progress)


class EvalAlterRes(_Engine):
    """Altering-resolution (AR) eval: ``__call__(highres_model, model,
    loader, n_classes)`` -> mIoU; ``histogram`` with the same arguments
    gives the histogram. highres_model: ``forward_key`` gives the keyframe
    feature; model: the fused LR model."""

    @torch.inference_mode()
    def predictions(self, highres_model, model, loader):
        """(label, int32 class map) of each batch (this rank's rows under a
        mesh), on the device."""
        pipe = ARPipeline(highres_model, model, self.scale, dtype=self.dtype, device=self.device)
        for batch in self._batches(loader):
            label = self._label(batch)
            ref_feat = pipe.hr_model.forward_key(pipe._frames(batch["ref_image"]))[-1]
            flow = torch.as_tensor(batch["flow"])  # split into planes on the host
            planes = scale_and_resize_flow(pipe._flow_planes((flow[..., 0], flow[..., 1])),
                                           tuple(ref_feat.shape[-2:]), mode="bilinear",
                                           split=True)
            feat = pipe._lr_feature(batch["image"], tuple(batch["image"].shape[1:3]))
            yield label, pipe._fuse_branch(feat, ref_feat, planes, tuple(label.shape[1:3]))

    def histogram(self, highres_model, model, loader, n_classes, progress=None):
        return self._histogram(self.predictions(highres_model, model, loader), n_classes,
                               progress)
