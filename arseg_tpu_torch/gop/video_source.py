"""Direct video -> card GOP source: decode compressed streams in memory —
port of ``arseg_tpu/gop/video_source.py``.

`VideoGOPSource` feeds `GOPFeeder` straight from the two elementary
streams the AR-Seg protocol defines:

  frames  <- the HEVC bitstream (what the method segments),
  MVs     <- the H.264 carrier (what the method warps by), or the HEVC
             encode's own x265 analysis sidecar (mv_kind="analysis"),

decoded in-process by the native runtime (libavcodec callback API,
`native/arsegvid.cpp:arsegvid_decode_frames_cb/_decode_mvs_cb`, bound by
``tools/video.py``) and chain-merged per GOP in memory
(`arsegvid_merge_mv`) — no intermediate file, no PNG codec anywhere. RGB
bytes are identical to the `decoded-%03d.png` artifacts (same swscale
conversion, byte-for-byte), so the maps equal those of the file-fed path
over the same decoded frames and merged MVs.

The merge parallelizes rows with OpenMP; hosts running many feeder
workers / streams should bound the team via `merge_threads` (~cores /
streams) to avoid oversubscription.
"""

import queue
import threading

import numpy as np


class VideoGOPSource:
    """Sequential GOP source over (hevc_path, carrier_path).

    iter_gops() yields GOPFeeder host items: (keyframe [1,H,W,3] float32
    normalized, frames [G-1,H,W,3], fx [G-1,H,W], fy [G-1,H,W] float pixel
    displacements current->keyframe), each written into a buffer from
    ``alloc(shape, dtype) -> (owner, numpy view)`` (the feeder passes
    pinned host tensors when it stages; numpy arrays by default). Frame
    and MV decode each run on their own thread (ctypes releases the GIL
    inside libavcodec), bounded to `lookahead` GOPs of host memory. A
    trailing partial GOP is dropped (same `len(ds) // g` convention as the
    file-based path).
    """

    def __init__(self, hevc_path, carrier_path, ref_gap, mean, std,
                 native=None, lookahead=2, device_normalize=False,
                 merge_threads=0, mv_kind="carrier"):
        if native is None:
            from arseg_tpu_torch.tools.video import load_native

            native = load_native()  # raises NativeUnavailable, saying why
        self.native = native
        self.hevc_path = hevc_path
        self.carrier_path = carrier_path
        self.g = int(ref_gap)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.lookahead = max(1, int(lookahead))
        # device_normalize: yield RAW uint8 frames for an
        # ARPipeline(normalize=(mean, std)) — the host sheds the f32
        # broadcasting and the H2D copy moves 4x fewer bytes; the card's
        # float32 (x/255 - mean)/std is bitwise the host's
        # (gop/pipeline.device_frames)
        self.device_normalize = bool(device_normalize)
        # merge_threads bounds the chain-merge's row-parallel OpenMP team
        # (0 = all cores); hosts serving several streams/workers should
        # pass ~cores/streams so concurrent merges don't oversubscribe
        self.merge_threads = int(merge_threads)
        # mv_kind: 'carrier' decodes carrier_path as an H.264 stream with
        # export_mvs; 'analysis' reads it as the x265 analysis-save sidecar
        # the HEVC encode dumped (arsegvid_encode_analysis) — the
        # HEVC-native MV source, no carrier stream at all. Both yield the
        # same per-frame int16 [H, W, 3] maps.
        if mv_kind not in ("carrier", "analysis"):
            raise ValueError(f"mv_kind must be carrier|analysis, got {mv_kind}")
        self.mv_kind = mv_kind

    class _Abort(Exception):
        """Internal: consumer abandoned the iteration; unwind the decode."""

    _EOS = object()

    def _decode_thread(self, decode_fn, path, out_q, stop):
        """Run a native callback decode, pushing per-GOP lists of frame
        copies; _EOS terminates, an Exception propagates. `stop` aborts the
        native decode from inside its callback (return <0) so an abandoned
        iteration releases decoder contexts and buffered GOPs instead of
        blocking forever on the bounded queue."""
        g = self.g
        acc = []

        def put(item):
            while True:
                if stop.is_set():
                    raise VideoGOPSource._Abort()
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def on_frame(idx, arr):
            acc.append(arr.copy())
            if len(acc) == g:
                put(list(acc))
                acc.clear()

        try:
            decode_fn(path, on_frame)
            put(self._EOS)  # (partial tail in `acc` is dropped)
        except VideoGOPSource._Abort:
            pass
        except Exception as e:  # pragma: no cover - surfaced in iter_gops
            if not stop.is_set():
                out_q.put(e)

    def iter_gops(self, alloc=None):
        if alloc is None:
            def alloc(shape, dtype):
                a = np.empty(shape, dtype)
                return a, a
        frame_q = queue.Queue(maxsize=self.lookahead)
        mv_q = queue.Queue(maxsize=self.lookahead)
        stop = threading.Event()
        threads = [
            threading.Thread(
                target=self._decode_thread,
                args=(self.native.decode_frames_cb, self.hevc_path, frame_q, stop),
                daemon=True,
            ),
            threading.Thread(
                target=self._decode_thread,
                args=(self.native.decode_mvs_cb if self.mv_kind == "carrier"
                      else self.native.hevc_analysis_mvs_cb,
                      self.carrier_path, mv_q, stop),
                daemon=True,
            ),
        ]
        for t in threads:
            t.start()
        try:
            first = True
            while True:
                frames = frame_q.get()
                mvs = mv_q.get()
                for item in (frames, mvs):
                    if isinstance(item, Exception):
                        raise item
                if frames is self._EOS or mvs is self._EOS:
                    if (frames is self._EOS) != (mvs is self._EOS):
                        raise RuntimeError(
                            "frame/carrier stream GOP counts differ — encode "
                            "both from the same frames with the same --ref_gap"
                        )
                    return
                if first:
                    first = False
                    if frames[0].shape[:2] != mvs[0].shape[:2]:
                        raise RuntimeError(
                            f"frame/carrier resolutions differ: frames "
                            f"{frames[0].shape[:2]} vs MV maps "
                            f"{mvs[0].shape[:2]} — wrong --mv_carrier?"
                        )
                h, w = frames[0].shape[:2]
                kf, kf_np = alloc((1, h, w, 3), np.uint8 if self.device_normalize else np.float32)
                fr, fr_np = alloc((self.g - 1, h, w, 3), kf_np.dtype)
                for k, img in enumerate(frames):
                    dst = kf_np[0] if k == 0 else fr_np[k - 1]
                    if self.device_normalize:
                        dst[...] = img  # uint8, normalized on device
                    else:
                        # exactly data/transform.normalize (/ std, not * inv)
                        dst[...] = img
                        dst /= 255.0
                        dst -= self.mean
                        dst /= self.std
                # chain-merge this GOP's MV maps (frames key+1..key+G-1)
                # into keyframe displacements; bins are qpel int16, flow px
                merged = self.native.merge_mv(
                    np.stack(mvs[1:]), max_ref=self.g,
                    threads=self.merge_threads)
                # qpel int16 -> px f32 per plane, written in place (*0.25 is
                # exact: bitwise the reader's astype(f32) / 4.0)
                fx, fx_np = alloc((self.g - 1, h, w), np.float32)
                fy, fy_np = alloc((self.g - 1, h, w), np.float32)
                for view, plane in ((fx_np, 0), (fy_np, 1)):
                    view[...] = merged[1:, ..., plane]
                    view *= 0.25
                yield (kf, fr, fx, fy)
        finally:
            stop.set()
            for q in (frame_q, mv_q):  # unblock producers promptly
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
