"""Minimal optimizers (port of ``repro/optim/optimizers.py``, the ``sgd``
part the paper's update eq. (11) uses).

Each optimizer is a pair ``(init(params) -> state, update(grads, state,
params, step) -> (updates, state))``; apply with :func:`apply_updates`.
Parameters are flat ``{name: tensor}`` dicts.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Params = dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., tuple[Params, Any]]


def constant_schedule(lr: float):
    return lambda step: float(lr)


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


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: (p.float() + updates[k].float()).to(p.dtype)
            for k, p in params.items()}


def get_optimizer(name: str, lr) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    raise ValueError(
        f"optimizer {name!r} is not ported yet (ROADMAP.md Queue A item 1); "
        "ported: sgd")
