"""ctypes bindings for the native arsegvid video runtime (native/arsegvid.cpp)
plus a vectorized numpy reference of the MV chain-merge — a copy of
``arseg_tpu/tools/video.py`` whose loader says why it failed.

The native library replaces the reference's external x265 / dec265-MV /
ffmpeg CLI calls (reference pre-process/generate_compressed_dataset_camvid.py:222-246)
with in-process libavcodec pipelines; see native/arsegvid.h for the artifact
contracts (decoded `decoded-%03d.png`, per-frame `test_%03d.bin` int16
[H, W, 3] qpel MVs, merged `merged_test_%03d.bin` int16 [H, W, 2]).

The library is built from the checkout's own ``native/`` sources by
``make -C native`` (the FFmpeg development stack: libavcodec, libavformat,
libavutil, libswscale, with libx264 and libx265) the first time it is
loaded. ``load_native`` raises ``NativeUnavailable`` with the reason when
it cannot be built or loaded: the tail of make's standard error, or the
loader's ``OSError``.
"""

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libarsegvid.so")
_ERR_LINES = 5  # lines of make's standard error kept in the reason


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded; the message says
    why."""


def build_native():
    """Build native/ with make, one process at a time (a lock file in
    native/build/). Raises NativeUnavailable with the tail of make's
    standard error when the build fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".make.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True, text=True)
        except FileNotFoundError as e:
            raise NativeUnavailable(f"make -C native: {e}") from e
    if r.returncode:
        tail = (r.stderr or r.stdout).strip().splitlines()[-_ERR_LINES:]
        raise NativeUnavailable(f"make -C native exited {r.returncode}: " + "\n".join(tail))


def load_native(auto_build=True):
    """A NativeVideo over native/build/libarsegvid.so, built first when it
    is missing. A stale prebuilt .so missing newer symbols (AttributeError
    from ctypes) gets one rebuild — make re-links when the sources are
    newer. Raises NativeUnavailable when the library cannot be built or
    loaded."""
    if not os.path.exists(_LIB_PATH):
        if not auto_build:
            raise NativeUnavailable(f"{_LIB_PATH} is not built (run `make -C native`)")
        build_native()
    try:
        return NativeVideo(_LIB_PATH)
    except AttributeError as e:
        if not auto_build:
            raise NativeUnavailable(f"{_LIB_PATH} lacks a symbol: {e}") from e
        build_native()
    except OSError as e:
        raise NativeUnavailable(f"cannot load {_LIB_PATH}: {e}") from e
    try:
        return NativeVideo(_LIB_PATH)
    except (OSError, AttributeError) as e:
        raise NativeUnavailable(f"cannot load {_LIB_PATH} after a rebuild: {e}") from e


class NativeVideo:
    """Thin typed wrapper over the arsegvid C API."""

    def __init__(self, lib_path=_LIB_PATH):
        lib = ctypes.CDLL(lib_path)
        lib.arsegvid_errmsg.restype = ctypes.c_char_p
        lib.arsegvid_encode.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.arsegvid_decode.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.arsegvid_mvdump.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        self._RGB_CB = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        )
        self._MV_CB = ctypes.CFUNCTYPE(
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int16),
        )
        lib.arsegvid_decode_frames_cb.argtypes = [
            ctypes.c_char_p, self._RGB_CB, ctypes.c_void_p,
        ]
        lib.arsegvid_decode_mvs_cb.argtypes = [
            ctypes.c_char_p, self._MV_CB, ctypes.c_void_p,
        ]
        lib.arsegvid_merge_mv_mt.argtypes = [
            ctypes.POINTER(ctypes.c_int16), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int16),
            ctypes.c_int,
        ]
        lib.arsegvid_gop_pipeline.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.arsegvid_gop_pipeline2.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.arsegvid_encode_analysis.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ]
        lib.arsegvid_hevc_mvdump.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.arsegvid_hevc_analysis_mvs_cb.argtypes = [
            ctypes.c_char_p, self._MV_CB, ctypes.c_void_p,
        ]
        self._lib = lib

    def _check(self, ret):
        if ret < 0:
            raise RuntimeError(self._lib.arsegvid_errmsg().decode())
        return ret

    @staticmethod
    def _paths(paths):
        arr = (ctypes.c_char_p * len(paths))()
        arr[:] = [os.fspath(p).encode() for p in paths]
        return arr

    def encode(self, image_paths, out_path, codec="libx265", fps=30,
               bitrate_kbps=3000, gop=12):
        self._check(self._lib.arsegvid_encode(
            self._paths(image_paths), len(image_paths),
            os.fspath(out_path).encode(), codec.encode(), fps, bitrate_kbps,
            gop))

    def decode(self, bitstream_path, out_dir):
        """Returns the number of decoded frames."""
        return self._check(self._lib.arsegvid_decode(
            os.fspath(bitstream_path).encode(), os.fspath(out_dir).encode()))

    def mvdump(self, bitstream_path, out_dir):
        return self._check(self._lib.arsegvid_mvdump(
            os.fspath(bitstream_path).encode(), os.fspath(out_dir).encode()))

    def encode_analysis(self, image_paths, out_path, analysis_out, fps=30,
                        bitrate_kbps=3000, gop=12):
        """libx265 encode that ALSO dumps the encoder's analysis data
        (PU-level HEVC MVs) to `analysis_out` — the HEVC-native MV source
        (see native/arsegvid.h)."""
        self._check(self._lib.arsegvid_encode_analysis(
            self._paths(image_paths), len(image_paths),
            os.fspath(out_path).encode(), fps, bitrate_kbps, gop,
            os.fspath(analysis_out).encode()))

    def hevc_mvdump(self, analysis_path, out_dir):
        """Rasterize an x265 analysis-save file into per-frame
        test_%03d.bin MV maps (same contract as mvdump). Returns frame
        count."""
        return self._check(self._lib.arsegvid_hevc_mvdump(
            os.fspath(analysis_path).encode(), os.fspath(out_dir).encode()))

    def hevc_analysis_mvs_cb(self, analysis_path, on_frame):
        """In-memory per-frame MV maps from an analysis-save file (every
        frame; keyframes get the all-intra map), int16 [h, w, 3]."""
        err = []

        def _cb(_user, idx, w, h, ptr):
            try:
                arr = np.ctypeslib.as_array(ptr, shape=(h, w, 3))
                on_frame(idx, arr)
                return 0
            except Exception as e:  # noqa: BLE001
                err.append(e)
                return -1

        ret = self._lib.arsegvid_hevc_analysis_mvs_cb(
            os.fspath(analysis_path).encode(), self._MV_CB(_cb), None)
        if err:
            raise err[0]
        return self._check(ret)

    def _decode_cb(self, native_fn, cbtype, bitstream_path, on_frame):
        """Shared callback decode: `on_frame(idx, arr)` gets an
        array VIEW valid only inside the callback (copy to keep); a raised
        exception aborts the native decode and re-raises here. Returns the
        frame count."""
        err = []

        def _cb(_user, idx, w, h, ptr):
            try:
                arr = np.ctypeslib.as_array(ptr, shape=(h, w, 3))
                on_frame(idx, arr)
                return 0
            except Exception as e:  # surface to the caller, abort decode
                err.append(e)
                return -1

        ret = native_fn(os.fspath(bitstream_path).encode(), cbtype(_cb), None)
        if err:
            raise err[0]
        return self._check(ret)

    def decode_frames_cb(self, bitstream_path, on_frame):
        """In-memory decode: `on_frame(idx, rgb)` per frame, uint8
        [h, w, 3]. No PNG round trip — the RGB bytes are identical to the
        decoded-%03d.png artifacts (same swscale conversion)."""
        return self._decode_cb(self._lib.arsegvid_decode_frames_cb,
                               self._RGB_CB, bitstream_path, on_frame)

    def decode_mvs_cb(self, bitstream_path, on_frame):
        """In-memory MV dump: `on_frame(idx, mv3)` per frame (EVERY frame —
        keyframes get the all-intra map), int16 [h, w, 3]."""
        return self._decode_cb(self._lib.arsegvid_decode_mvs_cb,
                               self._MV_CB, bitstream_path, on_frame)

    def merge_mv(self, bins, max_ref=3, threads=0):
        """bins: int16 [n_frames, h, w, 3] (frames 1..n). Returns int16
        [n_frames + 1, h, w, 2] merged qpel keyframe displacement maps.
        threads bounds the row-parallel OpenMP team (0 = library default);
        pass ~cores/workers when merging from several worker threads."""
        bins = np.ascontiguousarray(bins, dtype=np.int16)
        n, h, w, _ = bins.shape
        out = np.empty((n + 1, h, w, 2), dtype=np.int16)
        self._check(self._lib.arsegvid_merge_mv_mt(
            bins.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n, h, w,
            max_ref, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            int(threads)))
        return out

    def gop_pipeline(self, image_paths, out_dir, fps=30, bitrate_kbps=3000,
                     gop=12, merge_upto=0, mv_source="carrier"):
        """mv_source: 'carrier' (H.264 re-encode MVs, legacy) or 'hevc'
        (the HEVC encode's own analysis MVs — the reference-faithful
        source, no carrier encode)."""
        src = {"carrier": 0, "hevc": 1}[mv_source]
        self._check(self._lib.arsegvid_gop_pipeline2(
            self._paths(image_paths), len(image_paths),
            os.fspath(out_dir).encode(), fps, bitrate_kbps, gop, merge_upto,
            src))


def merge_motion_np(bins, max_ref=3):
    """Vectorized numpy reference of the MV chain-merge (oracle for the C++
    arsegvid_merge_mv; semantics of reference ...camvid.py:6-56).

    bins: int16 [n_frames, h, w, 3] per-frame qpel MVs for frames 1..n
    (channel 2 = ref offset, 0 = previous frame; <0 or >= max_ref = intra,
    absorbed as zero MV to the previous frame).
    Returns int16 [n_frames + 1, h, w, 2]: per-distance displacement
    current -> keyframe, quarter-pel; distance 0 is zero.
    """
    bins = np.asarray(bins)
    n, h, w, _ = bins.shape
    yy, xx = np.mgrid[0:h, 0:w]
    # anc[f]: int32 [h, w, 2] keyframe-ancestor (x, y) of each pixel of frame f
    anc = [np.stack([xx, yy], axis=-1).astype(np.int32)]
    out = np.zeros((n + 1, h, w, 2), dtype=np.int16)
    for f1 in range(1, n + 1):
        mv = bins[f1 - 1].astype(np.int64)
        intra = (mv[..., 2] < 0) | (mv[..., 2] >= max_ref)
        mv = np.where(intra[..., None], 0, mv)
        # np.round matches the C++ nearbyint (round-half-to-even)
        x2 = np.clip(xx + np.round(mv[..., 0] / 4.0).astype(np.int64), 0, w - 1)
        y2 = np.clip(yy + np.round(mv[..., 1] / 4.0).astype(np.int64), 0, h - 1)
        f2 = np.maximum(0, f1 - mv[..., 2] - 1)
        a = np.empty((h, w, 2), dtype=np.int32)
        for fv in np.unique(f2):
            m = f2 == fv
            a[m] = anc[int(fv)][y2[m], x2[m]]
        anc.append(a)
        out[f1, ..., 0] = ((a[..., 0] - xx) * 4).astype(np.int16)
        out[f1, ..., 1] = ((a[..., 1] - yy) * 4).astype(np.int16)
    return out
