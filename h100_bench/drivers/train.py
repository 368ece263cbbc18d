"""FST phase 2, stage 2, as a user trains an AR model: the program's
``TrainLoop.run_epoch`` over ``make_train_step``'s step of
``build_phase2_loss(stage2=True)`` (the frozen HR teacher, K2, the student
with K1 forward and backward, OHEM and MSE feature losses, Adam on float32
masters, bf16 compute), batches staged by the loop's own
``device_prefetch`` from pinned host memory.

Set-up builds one student, optimizer and step, drives them through their
first ``check_steps`` steps on distinct batches through ``run_epoch`` (the
window's own call and feed), and the window goes on training that same
object. The check holds those first steps against the float32 reference.

Traffic parameters: ``batch``, ``pool_batches`` (distinct batches, cycled;
at least ``check_steps``), ``check_steps``, ``lr``, ``t_max``,
``trace_from_step``, ``trace_steps``.
"""

import torch

from harness import checks, models, seeded
from harness.runctx import Outcome, free, memory_peak
from harness.trace import Capture, span

FROZEN = ("conv_out.conv_out",)  # FST's final conv, grafted from the teacher


def weights(ctx):
    """(teacher, student) float32 state dicts; the student's final conv is
    the teacher's."""
    cfg, dev = ctx.cfg, ctx.device
    teacher = models.weights(cfg, ctx.seed, "teacher", True, dev)
    student = models.weights(cfg, ctx.seed, "student", True, dev)
    for k in teacher:
        if k.startswith(("conv_out.conv_out.", "final_conv.")):
            student[k] = teacher[k]
    return teacher, student


def batches(ctx):
    """``pool_batches`` batches as the CamVid readers give them: normalised
    float32 frames and keyframes, labels with ~5% ignored, MVs in pixels."""
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    n, hw = tr["batch"], tuple(cfg["frame_hw"])
    mean = torch.tensor(cfg["normalize"]["mean"], device=dev)
    std = torch.tensor(cfg["normalize"]["std"], device=dev)
    out = []
    for i in range(tr["pool_batches"]):
        def image(name):
            return (seeded.frames(ctx.seed, f"{name}{i}", n, hw, dev).float() / 255 - mean) / std

        b = {"image": image("image"), "ref_image": image("ref"),
             "label": seeded.labels(ctx.seed, f"label{i}", n, hw, cfg["n_classes"], dev,
                                    cfg["ignore_label"]),
             "flow": seeded.block_flows(ctx.seed, f"flow{i}", n, hw, dev)}
        pin = dev.type == "cuda"
        out.append({k: (v.cpu().pin_memory() if pin else v.cpu()) for k, v in b.items()})
    return out


def run(ctx):
    from arseg_tpu_torch.train.objectives import build_phase2_loss
    from arseg_tpu_torch.train.optim import cosine_schedule, make_optimizer
    from arseg_tpu_torch.train.step import make_train_step, teacher_copy, trainable_parameters
    from arseg_tpu_torch.train.trainer import TrainLoop

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    h, w = cfg["frame_hw"]
    sd_t, sd_s = weights(ctx)
    ctx.mark("weights")
    teacher = teacher_copy(models.loaded(models.port_model(cfg, True, dev), sd_t), dev,
                           getattr(torch, cfg["dtype"]))
    student = models.loaded(models.port_model(cfg, True, dev), sd_s)
    student = student.to(memory_format=torch.channels_last)
    params = trainable_parameters(student, FROZEN)
    names = {p: n for n, p in student.named_parameters() if p.requires_grad}
    opt = make_optimizer("adam", cosine_schedule(tr["lr"], tr["t_max"]), params)
    step = make_train_step(build_phase2_loss("bisenet", "camvid", (w, h), cfg["lr_scale"],
                                             stage2=True),
                           opt, compute_dtype=getattr(torch, cfg["dtype"]), device=dev)
    loop = TrainLoop(dev, verbose=False)
    ctx.mark("models")
    pool = batches(ctx)
    ctx.mark("pool")
    start = {n: p.detach().clone() for p, n in names.items()}
    prog = {"losses": []}
    for i in range(tr["check_steps"]):
        prog["losses"].append(loop.run_epoch(step, student, teacher, [pool[i]], 0))
        if i == 0:
            prog["grad"], prog["grad_flat"] = checks.adam_first_grads(opt.optimizer, names)
        ctx.mark(f"step{i}")
    with torch.no_grad():
        prog["change"] = {n: float((p.detach() - start[n]).norm()) for p, n in names.items()}
    del start
    cap = Capture(dev) if ctx.trace else None
    if cap is not None:
        cap.warm()
    ctx.sync()
    setup_s = ctx.now() - ctx.t_start
    count = [0]

    def feed():
        t0 = ctx.now()
        while ctx.now() - t0 < ctx.seconds:
            k = count[0]
            if cap is not None and k == tr["trace_from_step"]:
                cap.start()
            if cap is not None and k == tr["trace_from_step"] + tr["trace_steps"]:
                cap.stop()
            count[0] += 1
            with span("bench.batch"):
                batch = pool[(tr["check_steps"] + k) % len(pool)]
            yield batch

    t0 = ctx.now()
    mean_loss = loop.run_epoch(step, student, teacher, feed(), 0)
    window = ctx.now() - t0
    if cap is not None:
        cap.stop()
    steps = count[0]
    peak = memory_peak(dev)
    del student, teacher, opt, step, loop, params, names
    free(dev)
    ref = reference_steps(ctx, sd_t, sd_s, pool[:tr["check_steps"]])
    readings, worst = checks.train_readings(prog, ref)
    return Outcome(
        e2e={"train_step_ms": window / steps * 1e3, "setup_s": setup_s},
        attempted=steps, failed=0 if mean_loss == mean_loss else steps,
        memory_peak_bytes=peak, readings=readings,
        info={"steps": steps, "window_s": window, "window_mean_loss": mean_loss,
              "first_losses": prog["losses"], "reference_losses": ref["losses"], **worst},
        host={"steps": steps, "window_s": window,
              "traced_steps": max(0, min(steps, tr["trace_from_step"] + tr["trace_steps"])
                                  - tr["trace_from_step"])},
        trace=cap.trace if cap is not None else None)


def reference_steps(ctx, sd_t, sd_s, batches_, lowp=None, half_batch=False):
    """The float32 reference's first steps: {"losses", "grad", "change"}."""
    from reference.train import fst_steps

    return fst_steps(ctx.cfg, ctx.traffic, sd_t, sd_s, batches_, ctx.device, frozen=FROZEN,
                     lowp=lowp, half_batch=half_batch)
