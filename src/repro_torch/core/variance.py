"""Pluggable variance reduction: the :class:`VarianceReducer` strategy layer
(port of ``repro/core/variance.py``).

The step builder never branches on ``cfg.vr``: it dispatches through the
reducer :func:`get_reducer` builds.  Ported reducers: ``sgd`` (plain
stochastic gradients), ``minibatch`` (the paper's BSGD: each worker's mean
gradient over a drawn minibatch) and ``saga`` (Alg. 1, packed table
updated in place).  ``lsvrg`` waits for ROADMAP.md Queue A item 7b.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import saga as saga_lib

# correct() -> (messages, new_state, metrics)
CorrectOut = tuple[torch.Tensor, object, dict]


class VarianceReducer:
    """Base strategy: no reduction (plain stochastic gradients).  The base
    class IS the ``sgd`` reducer."""

    name = "sgd"

    def __init__(self, cfg=None):
        self.cfg = cfg

    def index_shape(self, num_workers: int) -> tuple[int, ...]:
        """Shape of one step's sample draw: (W,), one sample a worker."""
        return (num_workers,)

    def draw_indices(self, generator: torch.Generator, num_workers: int,
                     num_samples: int) -> torch.Tensor:
        """This step's sample draw, :meth:`index_shape` int64 on the
        generator's device."""
        return torch.randint(0, num_samples, self.index_shape(num_workers),
                             generator=generator, device=generator.device)

    def init_sim(self, params, *,
                 per_sample_grads_fn: Callable[[], torch.Tensor],
                 num_workers: int):
        """Initial state on the finite-sum simulation path.
        ``per_sample_grads_fn()`` returns the packed (W, J, D) Alg.-1 table;
        it is called only by reducers that need it."""
        return None

    def correct(self, state, grads: torch.Tensor,
                sample_idx: torch.Tensor) -> CorrectOut:
        return grads, state, {}


class MinibatchReducer(VarianceReducer):
    """The paper's BSGD baseline: mean gradient of a random minibatch.
    Reduction happens in the SAMPLING (a (W, B) index draw feeding a mean
    loss, B = ``cfg.minibatch_size``), so the correction itself is the
    identity."""

    name = "minibatch"

    def index_shape(self, num_workers):
        """(W, B): B samples a worker, drawn with replacement."""
        return (num_workers, self.cfg.minibatch_size)


class SagaReducer(VarianceReducer):
    """Paper Alg. 1: per-sample gradient table + running average
    (:mod:`repro_torch.core.saga`), O((J+1) D) per worker."""

    name = "saga"

    def init_sim(self, params, *, per_sample_grads_fn, num_workers):
        return saga_lib.saga_init(per_sample_grads_fn())

    def correct(self, state, grads, sample_idx) -> CorrectOut:
        msgs, new_state = saga_lib.saga_correct_scatter(state, grads,
                                                        sample_idx)
        return msgs, new_state, {}


_REDUCERS: dict[str, type[VarianceReducer]] = {
    "sgd": VarianceReducer,
    "minibatch": MinibatchReducer,
    "saga": SagaReducer,
}

VR_NAMES = tuple(_REDUCERS)

# The reference's reducers that the port does not carry yet.
UNPORTED = ("lsvrg",)


def get_reducer(cfg) -> VarianceReducer:
    """Build the variance reducer named by ``cfg.vr``."""
    try:
        cls = _REDUCERS[cfg.vr]
    except KeyError:
        raise ValueError(
            f"unknown variance reducer {cfg.vr!r}; ported: "
            f"{', '.join(sorted(_REDUCERS))}; still to port from the "
            f"reference: {', '.join(UNPORTED)} (ROADMAP.md Queue A item 7b)"
        ) from None
    return cls(cfg)
