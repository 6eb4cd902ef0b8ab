"""The port's own copy of what ``whisper_medusa_tpu/training/train.py::make_optimizer``
takes from optax 0.2.6: ``optax.adafactor`` with its defaults, ``optax.adamw``
(weight decay 0), the linear and constant warmup schedules
(``optax.join_schedules`` of ``linear_schedule`` / ``constant_schedule``) and
gradient accumulation (``optax.MultiSteps``).

Every optimizer here reads ``p.grad`` and skips a parameter whose grad is
None; a frozen slice of a trained leaf carries a zero gradient, and both
rules give it an update of exactly zero, as optax does.  The schedule is
evaluated at the count of updates made so far (0 on the first), in float32.
``torch.optim.Adafactor`` is a different optimizer (no parameter-scale step)
and is not used.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# Schedules (optax.linear_schedule, constant_schedule, join_schedules)
# ---------------------------------------------------------------------------

def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: float(np.float32(init_value))

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac + np.float32(end_value))
    return schedule


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(np.float32(value))


def join_schedules(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def warmup_schedule(kind: str, lr: float, warmup_steps: int, total_steps: int) -> Schedule:
    """``make_optimizer``'s schedules: linear warmup from 0 to ``lr``, then
    linear decay to 0 at ``total_steps`` (``"linear"``) or constant
    (``"constant"``)."""
    if kind == "linear":
        after = linear_schedule(lr, 0.0, max(total_steps - warmup_steps, 1))
    elif kind == "constant":
        after = constant_schedule(lr)
    else:
        raise ValueError(f"unknown lr schedule {kind!r}")
    return join_schedules([linear_schedule(0.0, lr, warmup_steps), after], [warmup_steps])


# ---------------------------------------------------------------------------
# Adafactor (optax.adafactor)
# ---------------------------------------------------------------------------

# optax.adafactor's defaults, the only values make_optimizer uses.
MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
CLIPPING_THRESHOLD = 1.0
EPS = 1e-30
EPS_SCALE = 1e-3


def factored_dims(shape):
    """The two largest dims (d1, d0) to factor over, or None (optax's rule)."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(x * x))


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(learning_rate)`` with its defaults: factored second
    moments over the two largest dims when both are >= 128 (per-row and
    per-column means, decay ``1 - (t + 1)^-0.8``, ``eps`` 1e-30 added to the
    squared gradient), the update clipped to RMS 1 per leaf, times the
    learning rate, times the leaf's parameter RMS (at least 1e-3), no
    momentum, no weight decay.  State and arithmetic are in the parameter's
    dtype, with the decay blend in float32 as optax promotes it."""

    def __init__(self, params, lr):
        self.schedule = lr if callable(lr) else constant_schedule(lr)
        super().__init__(params, dict(count=0))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            count = group["count"]
            decay = float(np.float32(1) - np.float32(count + 1) ** np.float32(-DECAY_RATE))
            lr = self.schedule(count)
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(self._update(p, p.grad, decay, lr))
            group["count"] = count + 1

    def _update(self, p, g, decay, lr):
        dt, st = p.dtype, self.state[p]
        dims = factored_dims(p.shape)
        gsq = g * g + EPS
        blend = lambda old, new: (decay * old.float() + (1.0 - decay) * new.float()).to(dt)
        if dims is not None:
            d1, d0 = dims
            if not st:
                st["v_row"] = torch.zeros_like(gsq.mean(d0))
                st["v_col"] = torch.zeros_like(gsq.mean(d1))
            st["v_row"] = v_row = blend(st["v_row"], gsq.mean(d0))
            st["v_col"] = v_col = blend(st["v_col"], gsq.mean(d1))
            row_mean = v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
            row_factor = (v_row / row_mean) ** -0.5
            u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        else:
            if not st:
                st["v"] = torch.zeros_like(p)
            st["v"] = v = blend(st["v"], gsq)
            u = g * v ** -0.5
        u = u / torch.clamp(_rms(u) / CLIPPING_THRESHOLD, min=1.0)
        u = torch.tensor(lr, dtype=dt, device=u.device) * u
        rms = _rms(p)
        u = u * torch.where(rms <= EPS_SCALE, torch.tensor(EPS_SCALE, dtype=dt, device=p.device),
                            rms)
        return u * -1


# ---------------------------------------------------------------------------
# AdamW (optax.adamw, weight decay 0) and gradient accumulation
# ---------------------------------------------------------------------------

class ScheduledAdamW(torch.optim.AdamW):
    """``torch.optim.AdamW`` (betas 0.9 / 0.999, eps 1e-8, no weight decay,
    optax's defaults) with its learning rate taken from ``schedule`` at the
    count of updates made so far."""

    def __init__(self, params, schedule: Schedule):
        self.schedule = schedule
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                         weight_decay=0.0, foreach=False)
        for group in self.param_groups:
            group["count"] = 0

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self.schedule(group["count"])
        super().step()
        for group in self.param_groups:
            group["count"] += 1


class MultiSteps:
    """``optax.MultiSteps(opt, k)``: keeps the running mean of k
    micro-batches' gradients and lets the inner optimizer update on the k-th;
    the other calls change no parameter."""

    def __init__(self, inner: torch.optim.Optimizer, every_k: int):
        self.inner, self.every_k = inner, every_k
        self.mini_step = 0
        self.acc: Dict[int, torch.Tensor] = {}

    @torch.no_grad()
    def step(self):
        params = [p for group in self.inner.param_groups for p in group["params"]]
        for i, p in enumerate(params):
            if p.grad is not None:
                acc = self.acc.get(i, torch.zeros_like(p.grad))
                self.acc[i] = acc + (p.grad - acc) / (self.mini_step + 1)
        if self.mini_step == self.every_k - 1:
            for i, p in enumerate(params):
                p.grad = self.acc.get(i)
            self.inner.step()
            for p in params:
                p.grad = None
            self.acc = {}
        self.mini_step = (self.mini_step + 1) % self.every_k

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": dict(self.acc)}

    def load_state_dict(self, sd):
        self.inner.load_state_dict(sd["inner"])
        self.mini_step = sd["mini_step"]
        self.acc = {int(i): a for i, a in sd["acc"].items()}


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What ``make_optimizer`` returns (optax's GradientTransformation
    role): ``init(params)`` makes the optimizer over a list of leaves."""

    name: str
    schedule: Schedule
    gradient_accumulation_steps: int = 1

    def init(self, params: Sequence[torch.Tensor]):
        opt = (Adafactor(params, lr=self.schedule) if self.name == "adafactor"
               else ScheduledAdamW(params, self.schedule))
        if self.gradient_accumulation_steps > 1:
            return MultiSteps(opt, self.gradient_accumulation_steps)
        return opt
