"""Learning-rate schedules and optimizers — port of
``arseg_tpu/train/optim.py``.

The reference's policy (``train.py:190-203``, ``train_pair.py:259-279``):
Adam for CamVid, SGD (momentum 0.9, weight decay 5e-4) for Cityscapes,
CosineAnnealingLR stepped every iteration with T_max = epochs *
(len(dataset) // batch + 1); finetuning from a snapshot takes a 500-step
linear warmup from 1e-5 (GradualWarmupScheduler) that hands over to the
cosine schedule.

The schedules are plain functions of the update count. ``make_optimizer``
returns a ``ScheduledOptimizer``: a torch optimizer whose learning rate is
written into its parameter groups from the schedule before each update.
Update k (counted from 0, as optax counts) takes schedule(k). The count
lives in each parameter group under ``"updates"``, so that it travels with
the optimizer's ``state_dict``. ``torch.optim.Adam(betas=(0.9, 0.999),
eps=1e-8)`` is optax's ``scale_by_adam`` (both divide by sqrt(v_hat) +
eps); ``torch.optim.SGD(momentum=0.9, dampening=0, weight_decay=5e-4)`` is
``add_decayed_weights`` followed by ``trace``.
"""

import math

import torch


def cosine_schedule(base_lr: float, t_max: int):
    """torch CosineAnnealingLR (eta_min=0) in closed form."""

    def schedule(step):
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * step / t_max))

    return schedule


def warmup_cosine_schedule(base_lr: float, warmup_start_lr: float, warmup_steps: int,
                           t_max: int):
    """GradualWarmupScheduler(multiplier=base/start, total=warmup_steps,
    after=CosineAnnealingLR(T_max=t_max)): a linear ramp from warmup_start
    to base over warmup_steps, then the cosine schedule from its own step 0,
    which it reaches at step warmup_steps + 1."""
    mult = base_lr / warmup_start_lr

    def schedule(step):
        if step <= warmup_steps:
            return warmup_start_lr * ((mult - 1.0) * step / warmup_steps + 1.0)
        cos_step = max(step - (warmup_steps + 1), 0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * cos_step / t_max))

    return schedule


def t_max_for(epochs: int, n_samples: int, batch_size: int):
    return epochs * (n_samples // batch_size + 1)


class ScheduledOptimizer:
    """A torch optimizer and the schedule of its learning rate."""

    def __init__(self, optimizer, schedule):
        self.optimizer = optimizer
        self.schedule = schedule
        for group in optimizer.param_groups:
            group.setdefault("updates", 0)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def updates(self):
        return self.optimizer.param_groups[0]["updates"]

    def zero_grad(self):
        self.optimizer.zero_grad(set_to_none=True)

    def step(self):
        """One update at the learning rate schedule(updates)."""
        for group in self.optimizer.param_groups:
            group["lr"] = float(self.schedule(group["updates"]))
        self.optimizer.step()
        for group in self.optimizer.param_groups:
            group["updates"] += 1

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state):
        self.optimizer.load_state_dict(state)


def make_optimizer(kind: str, schedule, params, momentum=0.9, weight_decay=5e-4):
    """kind: "adam" (CamVid) or "sgd" (Cityscapes), over ``params`` (the
    trainable parameters: ``step.trainable_parameters``)."""
    params = list(params)
    lr = float(schedule(0))
    if kind == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif kind == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0,
                              weight_decay=weight_decay, nesterov=False)
    else:
        raise ValueError(kind)
    return ScheduledOptimizer(opt, schedule)
