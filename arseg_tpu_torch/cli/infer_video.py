"""AR video inference command — port of ``arseg_tpu/cli/infer_video.py``:
the GOP pipeline over a decoded sequence or a compressed stream, per-frame
class maps written as PNGs.

    python -m arseg_tpu_torch.cli.infer_video --data_path D --flow_path F \\
        --out_dir O --hr_snapshot HR --ar_snapshot AR [--backend camvid-psp18]
    python -m arseg_tpu_torch.cli.infer_video --video s.hevc --mv_carrier s.264 ...
    torchrun --nproc_per_node N -m arseg_tpu_torch.cli.infer_video \\
        --streams d0:f0,d1:f1,... --num_devices N ...   (or --gop_devices N)

Input is the label-free sequence layout (``CamVidWithFlowTest``): decoded
frames ``NNNNN.png``, keyframes under --ref_path, merged MV bins under
--flow_path; or, with --video, the HEVC stream and its MVs (an H.264
carrier, or the x265 analysis sidecar) decoded in-process by the native
runtime (``gop/video_source.py``). The flags are the JAX command's, with
the same meaning and errors, plus --device (default ``cuda``; ``cpu`` runs
the kernels' plain versions).

How the flags map: --gop_batch B serves B GOPs a step
(``ARPipeline.multi_gop_step``); --streams serves one stream per
``data_dir:flow_dir[:ref_dir]`` (or ``video:carrier``) spec, each rank of
the group its own contiguous streams batched in one ``multi_gop_step`` (the
per-rank body of ``sharded_step``), decoding and writing only those
(``out_dir/s<k>/``); --gop_devices N spreads one stream's GOP frames over
N ranks (``gop_parallel_step``): every rank reads the stream and rank 0
writes; --stats_json writes ``StepTimer.summary()``. --streams,
--num_devices N and --gop_devices N run under torchrun, one process per
device (``cli/_launch.py``). The port has no chunked LR path (a TPU v5e
workaround, ``arseg_tpu/gop/pipeline.py:120-134``): --lr_chunk other than
1 is an error.

--hr_snapshot / --ar_snapshot take what ``utils/checkpoint.load_checkpoint``
reads: a port or reference ``.pth``, or a JAX ``.npz``. The pipeline keeps
its models on the device in the serving --dtype, cast once at load.

Serving loop: ``GOPFeeder`` reads and stages GOPs --prefetch ahead (pinned
host memory, copies on a side stream; 0 = serial loading), the step runs,
one element of its maps is read back (the step's one synchronisation,
inside the timed block), and ``AsyncWriter`` copies the maps back and
encodes the PNGs on its own thread.

Two clocks, both in --stats_json: ``StepTimer``'s keys time the step alone
(the step's latency: the waits for the feed and for the writer fall
outside them), and the ``loop_*`` keys time the loop end to end, from the
end of the warm-up step to the last PNG written, over the steps after the
warm-up, with the seconds spent waiting for the feeder and for the
writers (``_LoopTimer``).
"""

import argparse
import os
import time

import torch
import torch.distributed as dist

from arseg_tpu_torch.cli._launch import launched


def main(argv=None):
    p = argparse.ArgumentParser(description="AR video inference over a decoded sequence.")
    p.add_argument("--data_path", default=None,
                   help="decoded frame dir (NNNNN.png); required unless --streams")
    p.add_argument("--ref_path", default=None,
                   help="decoded keyframe dir (default: --data_path — "
                        "keyframes read from the decoded sequence itself)")
    p.add_argument("--flow_path", default=None,
                   help="merged MV bin dir; required unless --streams")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--hr_snapshot", required=True)
    p.add_argument("--ar_snapshot", required=True)
    p.add_argument("--backend", default="camvid-psp18")
    p.add_argument("--ref_gap", type=int, default=12)
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    p.add_argument("--lr_chunk", type=int, default=1,
                   help="1 only: the port runs phase 1 over the GOP's frames in one batch")
    p.add_argument("--colorize", action="store_true")
    p.add_argument("--flow_shape", type=int, nargs=2, default=None)
    p.add_argument("--prefetch", type=int, default=2,
                   help="GOPs staged ahead (host decode + H2D overlap device "
                        "compute; 0 = serial loading)")
    p.add_argument("--io_workers", type=int, default=2)
    p.add_argument("--gop_batch", type=int, default=1,
                   help="GOPs per step (multi-GOP throughput mode: HR keyframes, "
                        "LR phase 1 and the kernels batch across the stack; "
                        "1 = latency-oriented GOP-at-a-time)")
    p.add_argument("--streams", default=None,
                   help="multi-stream serving: comma list of "
                        "data_dir:flow_dir[:ref_dir] specs (or video:carrier), one "
                        "per stream; each rank serves its contiguous share; outputs "
                        "land in out_dir/s<k>/. Stream count must be a multiple of "
                        "--num_devices.")
    p.add_argument("--num_devices", type=int, default=None,
                   help="ranks for --streams (default: all ranks that divide the "
                        "stream count); above 1, run under torchrun with one process "
                        "per device")
    p.add_argument("--stats_json", default=None,
                   help="write serving stats (per-step p50/p95/max ms, "
                        "frames/sec; the loop's end-to-end ms per step and "
                        "frames/sec) to this JSON file at exit")
    p.add_argument("--gop_devices", type=int, default=None,
                   help="latency scale-out for ONE stream: the GOP's non-key "
                        "frames spread over N ranks (ARPipeline.gop_parallel_step; "
                        "keyframe branch on every rank), run under torchrun. "
                        "Mutually exclusive with --gop_batch/--streams.")
    p.add_argument("--video", default=None,
                   help="serve DIRECTLY from a compressed HEVC bitstream "
                        "(frames decoded in-process, no PNG intermediary); "
                        "requires --mv_carrier. Mutually exclusive with "
                        "--data_path/--flow_path/--streams.")
    p.add_argument("--mv_carrier", default=None,
                   help="H.264 carrier bitstream for --video (same frames, "
                        "same --ref_gap; MVs decoded + chain-merged in "
                        "memory)")
    p.add_argument("--mv_analysis", default=None,
                   help="x265 analysis-save sidecar of the --video stream: "
                        "HEVC-native PU MVs, no carrier needed. Mutually "
                        "exclusive with --mv_carrier.")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    # flag validation BEFORE the expensive model/checkpoint loads
    if args.gop_batch > 1 and args.lr_chunk > 1:
        p.error("--gop_batch requires the default lr_chunk=1 (batched phase 1)")
    if args.lr_chunk != 1:
        p.error("--lr_chunk must be 1: the port has no chunked LR path (phase 1 runs "
                "the GOP's frames in one batch)")
    if args.streams:
        if args.gop_batch > 1:
            p.error("--streams and --gop_batch are mutually exclusive "
                    "(streams batch across the mesh instead)")
        if args.video or args.mv_carrier or args.mv_analysis:
            p.error("--video serves one stream; use --streams OR --video")
        if args.gop_devices:
            p.error("--streams and --gop_devices are mutually exclusive "
                    "(shard streams over the mesh OR one stream's frames)")
        for s_ in args.streams.split(","):
            spec = s_.split(":")
            if _is_video_spec(spec):
                missing = [f for f in spec if not os.path.isfile(f)]
                if missing:
                    raise SystemExit(f"video stream file(s) not found: {missing}")
    elif args.video or args.mv_carrier or args.mv_analysis:
        if args.mv_carrier and args.mv_analysis:
            p.error("--mv_carrier and --mv_analysis are mutually exclusive")
        if not (args.video and (args.mv_carrier or args.mv_analysis)):
            p.error("--video goes with --mv_carrier or --mv_analysis")
        if args.data_path or args.flow_path:
            p.error("--video is mutually exclusive with --data_path/--flow_path")
    elif not (args.data_path and args.flow_path):
        p.error("--data_path and --flow_path are required unless --streams "
                "or --video is given")
    if args.gop_devices and args.gop_batch > 1:
        p.error("--gop_devices and --gop_batch are mutually exclusive "
                "(frame-parallel latency mode vs multi-GOP throughput)")

    if args.gop_devices:
        ranks, flag = args.gop_devices, "--gop_devices"
    else:
        ranks, flag = (args.num_devices if args.streams else None), "--num_devices"
    with launched(ranks, args.device, "infer_video", flag):
        _run(args)


def _run(args):
    from arseg_tpu_torch._device import resolve_device
    from arseg_tpu_torch.data.camvid import FLOW_SHAPE, CamVidWithFlowTest
    from arseg_tpu_torch.parallel import data_group
    from arseg_tpu_torch.parallel.group import is_main

    flow_shape = tuple(args.flow_shape) + (2,) if args.flow_shape else FLOW_SHAPE
    g = args.ref_gap
    group = None
    if args.streams:
        specs = _stream_specs(args.streams)
        if dist.is_initialized():
            group = _streams_group(args, len(specs))
            if group is None:  # a rank outside the group
                return
    elif args.gop_devices and dist.is_initialized():
        world = dist.get_world_size()
        # honor the request exactly: data_group would serve on the first N
        if args.gop_devices > world:
            raise SystemExit(f"--gop_devices {args.gop_devices} > {world} ranks in the "
                             "process group")
        group = data_group(args.gop_devices, device=args.device)
        if group is None:
            return
    device = group.device if group is not None else resolve_device(args.device)
    pipe = _pipeline(args, device)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.streams:
        _run_streams(args, pipe, specs, group, flow_shape)
        return
    step = pipe.gop_step
    if args.gop_devices:
        step = pipe.gop_parallel_step(group)
    write = is_main(group)
    if args.video:
        from arseg_tpu_torch.gop.video_source import VideoGOPSource

        mean, std = _backend_norm(args.backend)
        src = VideoGOPSource(args.video, args.mv_carrier or args.mv_analysis, g, mean, std,
                             device_normalize=True,
                             mv_kind="analysis" if args.mv_analysis else "carrier")
        _serve_gops(args, step, src, None, device, write)
        return

    ds = CamVidWithFlowTest(args.data_path, ref_gap=g, ref_path=args.ref_path or args.data_path,
                            flow_path=args.flow_path, flow_shape=flow_shape)
    if len(ds) < g:
        raise SystemExit(f"sequence has {len(ds)} frames < --ref_gap {g}")
    names = [os.path.basename(p_)[:-4] for p_ in ds.data]
    _serve_gops(args, step, ds, names, device, write)


def _pipeline(args, device):
    """The AR pipeline of --backend on ``device`` in --dtype, its two
    models loaded from the snapshots (strictly) on the CPU first."""
    from arseg_tpu_torch.gop import ARPipeline
    from arseg_tpu_torch.models import build_model
    from arseg_tpu_torch.utils.checkpoint import load_weights

    hr_model = build_model(args.backend, fuse=False, device="cpu")
    ar_model = build_model(args.backend, fuse=True, device="cpu")
    load_weights(hr_model, args.hr_snapshot, args.backend)
    load_weights(ar_model, args.ar_snapshot, args.backend)
    # normalize= is inert for the host-normalised float32 file feeds; it
    # lets --video ship raw uint8 frames and normalise on the device
    return ARPipeline(hr_model, ar_model, scale=args.scale, dtype=getattr(torch, args.dtype),
                      normalize=_backend_norm(args.backend), device=device)


class _LoopTimer:
    """The serve loop's rate on the host clock, end to end: from the end of
    the warm-up step (the step ``StepTimer.summary`` leaves out) to the
    writers' close, over the frames of the steps after it. The warm-up
    GOP's PNG encoding falls inside that span, so the rate errs low. The
    span splits into the steps, the waits for the feeder (``fed``: from
    the last mark to a GOP's arrival) and the waits in the writers'
    ``put`` and ``close`` (``written``, ``closed``)."""

    def __init__(self):
        self.t0 = self.mark = None
        self.steps = 0
        self.frames = 0
        self.seconds = self.feed_s = self.write_s = 0.0

    def _since_mark(self):
        now = time.perf_counter()
        span = 0.0 if self.t0 is None else now - self.mark
        self.mark = now
        return span

    def fed(self):
        self.feed_s += self._since_mark()

    def stepped(self, frames):
        if self.t0 is None:
            self.t0 = self.mark = time.perf_counter()
        else:
            self.mark = time.perf_counter()
            self.steps += 1
            self.frames += frames

    def written(self):
        self.write_s += self._since_mark()

    def closed(self):
        if self.t0 is not None:
            self.written()
            self.seconds = self.mark - self.t0

    def summary(self):
        timed = self.steps > 0 and self.seconds > 0
        return {"loop_s": self.seconds, "loop_steps": self.steps,
                "loop_ms_per_step": 1e3 * self.seconds / self.steps if timed else None,
                "loop_frames_per_sec": self.frames / self.seconds if timed else None,
                "loop_feed_wait_s": self.feed_s, "loop_write_wait_s": self.write_s}


def _finish(args, timer, loop, summary_line):
    """Write --stats_json and print the run's line."""
    s = timer.summary()
    t = loop.summary()
    if args.stats_json:
        import json

        with open(args.stats_json, "w") as f:
            json.dump({**s, **t}, f, indent=2)
    rate = (f"{s['frames_per_sec']:.1f} frames/sec in the step, "
            f"{t['loop_frames_per_sec']:.1f} end to end" if t["loop_steps"]
            else f"single GOP incl. warm-up: {s['mean_ms'] / 1e3:.1f}s")
    print(summary_line(rate))


def _sync(preds):
    """The step's one synchronisation: one element read back."""
    preds[(0,) * preds.ndim].item()


def _serve_gops(args, step, source, names, device, write):
    """The single-stream serve loop shared by the file-based and --video
    paths: GOPFeeder in, AsyncWriter out (when this rank writes). `names`:
    per-frame output names, or None to index-name (video sources have no
    input files)."""
    from arseg_tpu_torch.gop.feeder import AsyncWriter, GOPFeeder
    from arseg_tpu_torch.utils.profiling import StepTimer

    g = args.ref_gap
    # with gop_batch > 1 each staged item is a [B, ...] stack (~gop_batch x
    # the device memory), so staging depth is held at 1
    feeder = GOPFeeder(source, g, num_workers=args.io_workers,
                       depth=max(1, args.prefetch if args.gop_batch == 1 else 1),
                       stage=args.prefetch > 0, gop_batch=args.gop_batch, device=device)
    writer = AsyncWriter(args.out_dir, colorize=args.colorize) if write else None
    timer = StepTimer(frames_per_step=g)
    loop = _LoopTimer()
    total = 0
    try:
        for gi, keyframe, frames, flows in feeder:
            loop.fed()
            n_frames = frames.shape[0] * g if frames.ndim == 5 else g
            with timer.step(n_frames):
                preds = step(keyframe, frames, flows)
                _sync(preds)
            loop.stepped(n_frames)
            if writer is not None:
                nm = (names[gi * g:gi * g + n_frames] if names is not None
                      else [f"{i:05d}" for i in range(gi * g, gi * g + n_frames)])
                writer.put(preds.reshape(-1, *preds.shape[-2:]), nm)
            loop.written()
            total += n_frames
    finally:
        if writer is not None:
            writer.close()
    loop.closed()
    if total == 0:
        raise SystemExit(f"no full GOP in the input (< --ref_gap {g} frames?)")
    if write:
        _finish(args, timer, loop, lambda rate: f"{total} frames -> {args.out_dir}  ({rate})")


_VIDEO_EXTS = (".hevc", ".265", ".264", ".h264", ".mp4", ".bin")


def _is_video_spec(spec):
    """A 2-element --streams spec naming bitstream files (vs PNG/bin dirs)."""
    return len(spec) == 2 and (spec[0].lower().endswith(_VIDEO_EXTS) or os.path.isfile(spec[0]))


def _backend_norm(backend):
    """Normalization constants of the backend's training dataset."""
    backend = backend.lower()  # build_model lowercases its key too
    if backend.startswith("camvid"):
        from arseg_tpu_torch.data.camvid import CAMVID_MEAN, CAMVID_STD

        return CAMVID_MEAN, CAMVID_STD
    from arseg_tpu_torch.data.cityscapes import MEANS

    return MEANS["bisenet" if "bise" in backend else "pspnet"]


def _stream_specs(streams):
    specs = [s.split(":") for s in streams.split(",") if s]
    for spec in specs:
        if len(spec) not in (2, 3):
            raise SystemExit(f"bad --streams entry {':'.join(spec)!r} "
                             "(want data_dir:flow_dir[:ref_dir], or video.hevc:carrier.264)")
    return specs


def _streams_group(args, s_count):
    """This rank's group for --streams under a process group (None for a
    rank outside it)."""
    from arseg_tpu_torch.parallel import data_group

    world = dist.get_world_size()
    if args.num_devices is not None:
        # honor the request exactly — data_group's divisibility clamp would
        # silently serve on fewer devices than asked
        if s_count % args.num_devices:
            raise SystemExit(f"{s_count} streams not divisible by --num_devices "
                             f"{args.num_devices}")
        if args.num_devices > world:
            raise SystemExit(f"--num_devices {args.num_devices} > {world} ranks in the "
                             "process group")
        return data_group(args.num_devices, device=args.device)
    return data_group(batch_size=s_count, device=args.device)


def _stack(items, f):
    """Field f (keyframe, frames, fx, fy) of the streams' feeder items
    stacked along a new first axis (the keyframes' [1, H, W, 3] along their
    own): on the device for staged tensors, on the host for numpy."""
    parts = [(it[1][0], it[2], *it[3])[f] for it in items]
    if torch.is_tensor(parts[0]):
        return torch.stack(parts)
    import numpy as np

    return np.stack(parts)


def _run_streams(args, pipe, specs, group, flow_shape):
    """Multi-stream serving: one sequence per stream, each rank serving its
    contiguous share of the streams batched in one ``multi_gop_step`` a GOP
    (the per-rank body of ``ARPipeline.sharded_step``; no rank gathers,
    decodes or writes another rank's streams). One GOPFeeder per stream;
    stream k's outputs go to out_dir/s<k>/. A rank stops at its shortest
    stream."""
    from arseg_tpu_torch.data.camvid import CamVidWithFlowTest
    from arseg_tpu_torch.gop.feeder import AsyncWriter, GOPFeeder
    from arseg_tpu_torch.utils.profiling import StepTimer

    g = args.ref_gap
    s_count = len(specs)
    n = 1 if group is None else group.size
    rank = 0 if group is None else group.rank
    local = range(rank * s_count // n, (rank + 1) * s_count // n)
    # all streams stack into one batch, so every stream must contribute the
    # same dtype: an all-video fleet ships raw uint8 (normalised on the
    # device, 4x less H2D); any file-based stream forces host-normalised
    # float32 everywhere
    all_video = all(_is_video_spec(s) for s in specs)
    sources = {}
    for k in local:
        spec = specs[k]
        if _is_video_spec(spec):
            from arseg_tpu_torch.gop.video_source import VideoGOPSource

            mean, std = _backend_norm(args.backend)
            sources[k] = VideoGOPSource(
                spec[0], spec[1], g, mean, std, device_normalize=all_video,
                merge_threads=max(1, (os.cpu_count() or 1) // s_count))
            continue
        data_dir, flow_dir = spec[0], spec[1]
        ref_dir = spec[2] if len(spec) == 3 else data_dir
        sources[k] = CamVidWithFlowTest(data_dir, ref_gap=g, ref_path=ref_dir,
                                        flow_path=flow_dir, flow_shape=flow_shape)
    short = [specs[k][0] for k, d in sources.items()
             if not hasattr(d, "iter_gops") and len(d) < g]
    if short:
        raise SystemExit(f"stream(s) shorter than --ref_gap {g}: {short}")

    writers, names = {}, {}
    for k, ds in sources.items():
        sub = os.path.join(args.out_dir, f"s{k}")
        os.makedirs(sub, exist_ok=True)
        writers[k] = AsyncWriter(sub, colorize=args.colorize)
        # video streams have no input filenames; index-named outputs
        names[k] = (None if hasattr(ds, "iter_gops")
                    else [os.path.basename(p_)[:-4] for p_ in ds.data])

    per_stream_workers = max(1, -(-args.io_workers // len(local)))  # ceil, >= 1
    feeders = [iter(GOPFeeder(ds, g, num_workers=per_stream_workers,
                              depth=max(1, args.prefetch), stage=args.prefetch > 0,
                              device=pipe.device))
               for ds in sources.values()]
    timer = StepTimer(frames_per_step=len(local) * g)
    loop = _LoopTimer()
    n_gops = 0
    try:
        for gi, items in enumerate(zip(*feeders)):  # stops at the shortest stream
            loop.fed()
            n_gops = gi + 1
            kf, fr, fx, fy = (_stack(items, f) for f in range(4))
            with timer:
                preds = pipe.multi_gop_step(kf, fr, (fx, fy))
                _sync(preds)
            loop.stepped(len(local) * g)
            for j, k in enumerate(sources):
                nm = (names[k][gi * g:(gi + 1) * g] if names[k] is not None
                      else [f"{i:05d}" for i in range(gi * g, (gi + 1) * g)])
                writers[k].put(preds[j], nm)
            loop.written()
    finally:
        for f in feeders:  # stops the decode threads of longer streams
            f.close()
        for w in writers.values():
            w.close()
    loop.closed()
    if n_gops == 0:
        raise SystemExit(f"no full GOP served — every stream needs >= --ref_gap {g} frames")
    if rank == 0:
        _finish(args, timer, loop, lambda rate: (
            f"{s_count} streams x {n_gops * g} frames -> {args.out_dir} "
            f"({n}-rank group; rank 0 serves {len(local)} of them at {rate})"))


if __name__ == "__main__":
    main()
