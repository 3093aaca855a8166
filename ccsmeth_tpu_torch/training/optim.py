"""Optimizers and LR schedules as plain torch functions on tensors.

Counterpart of ``ccsmeth_tpu/training/optim.py``: the same five chains
(``build_optimizer :83-120``), each after ``clip_by_global_norm(0.5)``, with
optax 0.2.6's arithmetic rather than ``torch.optim``'s, which computes
something else:

- clipping keeps g when ||g|| < 0.5 and otherwise uses g / ||g|| * 0.5 (torch
  adds 1e-6 to the norm);
- Adam: bias-corrected moments, eps 1e-8 outside the sqrt;
- RMSprop: decay 0.99, eps inside the sqrt, g * rsqrt(nu + eps) (torch puts
  it outside);
- SGD: trace t = g + 0.8 t, update -lr t;
- Ranger: gradient centralization on leaves with >= 2 dims (``:22-41``),
  RAdam (b1 0.95, b2 0.999, eps 1e-5, threshold 5), scale by -lr, lookahead
  k = 6, alpha = 0.5 (``:49-80``);
- LookaheadAdam: Adam's scaling, -lr, lookahead k = 5, alpha = 0.5.

``Optimizer.step`` updates the parameter tensors in place. Its state is a
dict of plain tensors and ints (``state_dict``/``load_state_dict``), so
training can save and resume it. ``LrSchedule`` is host code, copied.
"""

from __future__ import annotations

import math

import numpy as np
import torch

KINDS = ("Adam", "RMSprop", "SGD", "Ranger", "LookaheadAdam")
_LOOKAHEAD = {"Ranger": (6, 0.5), "LookaheadAdam": (5, 0.5)}
# (b1, b2, eps) of the Adam-family moment estimates
_ADAM = {"Adam": (0.9, 0.999, 1e-8), "LookaheadAdam": (0.9, 0.999, 1e-8),
         "Ranger": (0.95, 0.999, 1e-5)}
RMS_DECAY, RMS_EPS = 0.99, 1e-8
SGD_MOMENTUM = 0.8
RADAM_THRESHOLD = 5.0


def global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm, without a host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def centralize(grads, gc_dims=None):
    """Ranger's gradient centralization: subtract the mean over ``gc_dims``
    (by default every dim but the first) from each leaf with >= 2 dims; a
    callable ``gc_dims[i]`` centralizes leaf i itself (a leaf that the JAX
    package keeps as several)."""
    out = []
    for i, g in enumerate(grads):
        spec = gc_dims[i] if gc_dims is not None else None
        if callable(spec):
            g = spec(g)
        elif g.dim() > 1:
            dims = spec if spec is not None else tuple(range(1, g.dim()))
            g = g - g.mean(dim=dims, keepdim=True)
        out.append(g)
    return out


def _bias_correction(decay: float, count: int) -> float:
    # 1 - decay**count in float32, as optax computes it
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count),
                                            dtype=np.float32))


class Optimizer:
    """One of the five chains of ``KINDS`` with an injectable learning rate.

    ``init(params, gc_dims)`` makes the state for a list of parameter tensors;
    ``gc_dims[i]`` overrides the dims that Ranger's centralization averages
    over for leaf i (the model gives (0,) for a Linear weight, which the JAX
    package keeps input-major). ``step(params, grads)`` clips, transforms and
    applies the update in place."""

    def __init__(self, optim_type: str, lr: float, grad_clip: float = 0.5):
        if optim_type not in KINDS:
            raise ValueError("--optim_type is not right!")
        self.optim_type = optim_type
        self.lr = float(lr)
        self.grad_clip = grad_clip
        self.gc_dims = None
        self.state: dict = {}

    def set_learning_rate(self, lr: float) -> None:
        self.lr = float(lr)

    def init(self, params, gc_dims=None) -> None:
        params = list(params)
        self.gc_dims = gc_dims

        def zeros():
            return [torch.zeros_like(p) for p in params]

        kind = self.optim_type
        st: dict = {"count": 0}
        if kind in _ADAM:
            st["mu"], st["nu"] = zeros(), zeros()
        elif kind == "RMSprop":
            st["nu"] = zeros()
        else:
            st["trace"] = zeros()
        if kind in _LOOKAHEAD:
            st["slow"] = [p.detach().clone() for p in params]
        self.state = st

    @torch.no_grad()
    def step(self, params, grads) -> None:
        params = list(params)
        grads = clip_by_global_norm([g.float() for g in grads], self.grad_clip)
        kind = self.optim_type
        st = self.state
        st["count"] += 1
        n = st["count"]
        if kind == "Ranger":
            grads = centralize(grads, self.gc_dims)
        if kind in _ADAM:
            updates = self._adam(grads, n)
        elif kind == "RMSprop":
            updates = []
            for g, nu in zip(grads, st["nu"]):
                nu.copy_((1 - RMS_DECAY) * (g * g) + RMS_DECAY * nu)
                updates.append(torch.rsqrt(nu + RMS_EPS) * g)
        else:
            for g, t in zip(grads, st["trace"]):
                t.copy_(g + SGD_MOMENTUM * t)
            updates = st["trace"]
        updates = [(-self.lr) * u for u in updates]
        if kind in _LOOKAHEAD:
            k, alpha = _LOOKAHEAD[kind]
            if n % k == 0:
                for i, (u, s, p) in enumerate(zip(updates, st["slow"], params)):
                    s.copy_(s + alpha * ((p + u) - s))
                    updates[i] = s - p
        for p, u in zip(params, updates):
            p.add_(u)

    def _adam(self, grads, n: int):
        """Adam's (or RAdam's for Ranger) scaled moments for step n."""
        b1, b2, eps = _ADAM[self.optim_type]
        st = self.state
        bc1, bc2 = _bias_correction(b1, n), _bias_correction(b2, n)
        radam_r = None
        if self.optim_type == "Ranger":
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            b2t = float(np.power(np.float32(b2), np.float32(n), dtype=np.float32))
            ro = ro_inf - 2 * n * b2t / (1 - b2t)
            if ro >= RADAM_THRESHOLD:
                radam_r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                    / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        out = []
        for g, mu, nu in zip(grads, st["mu"], st["nu"]):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            mu_hat, nu_hat = mu / bc1, nu / bc2
            if self.optim_type != "Ranger":
                out.append(mu_hat / (torch.sqrt(nu_hat) + eps))
            elif radam_r is not None:
                out.append(radam_r * mu_hat / (torch.sqrt(nu_hat) + eps))
            else:
                out.append(mu_hat)
        return out

    def state_dict(self) -> dict:
        """{'optim_type', 'lr', 'count', and per-leaf tensor lists}."""
        sd = {"optim_type": self.optim_type, "lr": self.lr}
        sd.update(self.state)
        return sd

    def load_state_dict(self, sd: dict) -> None:
        if sd["optim_type"] != self.optim_type:
            raise ValueError("optimizer state is {}, this run uses {}".format(
                sd["optim_type"], self.optim_type))
        self.lr = float(sd["lr"])
        for key, val in sd.items():
            if key in ("optim_type", "lr"):
                continue
            if key == "count":
                self.state["count"] = int(val)
                continue
            mine = self.state[key]
            if len(mine) != len(val):
                raise ValueError("optimizer state {} has {} leaves, the model "
                                 "{}".format(key, len(val), len(mine)))
            for dst, src in zip(mine, val):
                dst.copy_(torch.as_tensor(np.asarray(src)).to(dst.device, dst.dtype))


def build_optimizer(optim_type: str, lr: float, grad_clip: float = 0.5) -> Optimizer:
    """The optimizer of ``--optim_type`` with its learning rate settable
    between steps (``Optimizer.set_learning_rate``)."""
    return Optimizer(optim_type, lr, grad_clip)


class LrSchedule:
    """Host-side LR schedule: StepLR / ReduceLROnPlateau (train.py:161-167,315-326)."""

    def __init__(self, kind: str, lr: float, decay: float = 0.1, decay_step: int = 1,
                 patience: int = 0, mode_strategy: str = "last"):
        if kind not in ("StepLR", "ReduceLROnPlateau"):
            raise ValueError("--lr_scheduler is not right!")
        self.kind = kind
        self.lr = lr
        self.decay = decay
        self.decay_step = decay_step
        self.patience = patience
        self.mode_strategy = mode_strategy
        self._epochs = 0
        self._best = -np.inf
        self._bad = 0

    def epoch_end(self, accuracies_per_epoch: list[float]) -> float:
        """Advance one epoch; returns the (possibly updated) learning rate."""
        self._epochs += 1
        if self.kind == "StepLR":
            if self._epochs % self.decay_step == 0:
                self.lr *= self.decay
            return self.lr
        if self.mode_strategy == "mean":
            metric = float(np.mean(accuracies_per_epoch))
        elif self.mode_strategy == "last":
            metric = float(accuracies_per_epoch[-1])
        elif self.mode_strategy == "max":
            metric = float(np.max(accuracies_per_epoch))
        else:
            raise ValueError("--lr_mode_strategy is not right!")
        if metric > self._best:
            self._best = metric
            self._bad = 0
        else:
            self._bad += 1
            if self._bad > self.patience:
                self.lr *= self.decay
                self._bad = 0
        return self.lr
