"""Minimal optimizers (port of ``repro/optim/optimizers.py``).

Each optimizer is a pair ``(init(params) -> state, update(grads, state,
params, step) -> (updates, state))``; apply with :func:`apply_updates`.
Parameters are flat ``{name: tensor}`` dicts.  The paper's update (eq.
(11)) is plain ``sgd``; ``momentum`` (optionally Nesterov), ``adam`` and
``adamw`` (decoupled weight decay) keep the reference's states and
defaults, and a learning rate may be a schedule ``step -> lr``
(:func:`cosine_schedule`).  Updates make new tensors: a state is never
written in place, so a guard-rejected round can keep the old one.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

Params = dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]


def constant_schedule(lr: float):
    return lambda step: float(lr)


def cosine_schedule(lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    """Linear warm-up to ``lr`` over ``warmup`` steps, then a cosine decay
    to ``min_ratio * lr`` at ``total``; a 0-dim float32 tensor."""
    def sched(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = lr * (min_ratio + (1 - min_ratio) * 0.5
                    * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return sched


def _as_schedule(lr):
    return lr if callable(lr) else constant_schedule(lr)


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params=None, step=0):
        rate = sched(step)
        return {k: -rate * g for k, g in grads.items()}, state

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum ``m <- beta m + g``; the update is ``-lr m`` (or
    ``-lr (g + beta m)`` with ``nesterov``)."""
    sched = _as_schedule(lr)

    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(grads, state, params=None, step=0):
        new_m = {k: beta * state[k] + g for k, g in grads.items()}
        upd = ({k: g + beta * new_m[k] for k, g in grads.items()}
               if nesterov else new_m)
        rate = sched(step)
        return {k: -rate * u for k, u in upd.items()}, new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Params
    nu: Params


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam, and AdamW (decoupled weight decay) when ``weight_decay`` > 0;
    moments in float32, the bias corrections in float32 from ``step + 1``."""
    sched = _as_schedule(lr)

    def init(params):
        return AdamState(
            mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()},
            nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()})

    def update(grads, state, params=None, step=0):
        step_f = torch.as_tensor(step, dtype=torch.float32) + 1.0
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.float()
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.float())
              for k, g in grads.items()}
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** step_f
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** step_f
        rate = sched(step)
        updates = {}
        for k in grads:
            u = (mu[k] / bc1.to(mu[k].device)) / (
                torch.sqrt(nu[k] / bc2.to(nu[k].device)) + eps)
            if weight_decay:
                u = u + weight_decay * params[k].float()
            updates[k] = (-rate * u).to(params[k].dtype)
        return updates, AdamState(mu, nu)

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.float() + updates[k].float()).to(p.dtype)
            for k, p in params.items()}


_OPTIMIZERS = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw}

OPTIMIZER_NAMES = tuple(_OPTIMIZERS)


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    """The optimizer ``name`` (:data:`OPTIMIZER_NAMES`) at learning rate (or
    schedule) ``lr``, with its keywords (``beta``, ``nesterov``; ``b1``,
    ``b2``, ``eps``, ``weight_decay``)."""
    try:
        make = _OPTIMIZERS[name]
    except KeyError:
        raise ValueError(f"unknown optimizer {name!r}; known: "
                         f"{', '.join(OPTIMIZER_NAMES)}") from None
    return make(lr, **kw)
