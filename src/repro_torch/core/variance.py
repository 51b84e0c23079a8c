"""Pluggable variance reduction: the :class:`VarianceReducer` strategy layer
(port of ``repro/core/variance.py``).

The step builder never branches on ``cfg.vr``: it dispatches through the
reducer :func:`get_reducer` builds.  Reducers: ``sgd`` (plain stochastic
gradients), ``minibatch`` (the paper's BSGD: each worker's mean gradient
over a drawn minibatch), ``saga`` (Alg. 1, packed table updated in place)
and ``lsvrg`` (loopless SVRG, arXiv:2303.04560: a snapshot and its full
local gradient per worker, O(2D) state).

``correct(state, grads, sample_idx, **kw)`` takes, besides the drawn
gradients and samples, the step builder's keywords:

* ``rows`` -- (W,) distinct client rows of state resident per client
  (partial participation), or None when slot w owns state row w;
* ``params`` -- the slots' current parameters, packed (W, D);
* ``grads_at(p)`` -- each slot's gradient at packed params ``p`` (W, D) on
  this step's drawn samples;
* ``full_grads_at(sel)`` -- the full local gradients of the slots ``sel``
  at their current parameters, packed (len(sel), D);
* ``generator`` and ``coin`` -- lsvrg's per-worker refresh draw, or the
  caller's (W,) bool coin in its place (a test hands in the reference's).

Reducers that ignore a keyword take it all the same.  Stateful reducers
update their state in place; :meth:`VarianceReducer.hold` copies the rows a
correction will write and :meth:`VarianceReducer.restore` puts them back,
which is how a rejected round (the guards' verdict) keeps its state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import participation as participation_lib
from repro_torch.core import saga as saga_lib

# correct() -> (messages, new_state, metrics)
CorrectOut = tuple[torch.Tensor, object, dict]


class LsvrgState(NamedTuple):
    """Per-worker (per-client under partial participation) loopless-SVRG
    memory, packed: ``snapshot`` (W, D) the parameters at each worker's
    last refresh, ``anchor`` (W, D) its full local gradient there."""

    snapshot: torch.Tensor
    anchor: torch.Tensor


class VarianceReducer:
    """Base strategy: no reduction (plain stochastic gradients).  The base
    class IS the ``sgd`` reducer."""

    name = "sgd"
    #: whether ``correct`` reads the oracles params/grads_at/full_grads_at
    uses_oracles = False

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
                 num_workers: int,
                 full_grads_fn: Optional[Callable[[], torch.Tensor]] = None,
                 spec=None):
        """Initial state on the finite-sum simulation path, for
        ``num_workers`` state rows.  ``per_sample_grads_fn()`` returns the
        packed (W, J, D) Alg.-1 table and ``full_grads_fn()`` the packed
        (W, D) full local gradients at ``params``; each is called only by
        the reducer that needs it."""
        return None

    def correct(self, state, grads: torch.Tensor,
                sample_idx: torch.Tensor, **kw) -> CorrectOut:
        return grads, state, {}

    def hold(self, state, sample_idx: torch.Tensor, rows=None):
        """Copies of the state entries :meth:`correct` will write."""
        return None

    def restore(self, state, held, sample_idx: torch.Tensor,
                rows=None) -> None:
        """Put :meth:`hold`'s copies back, in place."""


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

    def init_sim(self, params, *, per_sample_grads_fn, num_workers,
                 full_grads_fn=None, spec=None):
        return saga_lib.saga_init(per_sample_grads_fn())

    def correct(self, state, grads, sample_idx, *, rows=None,
                **kw) -> CorrectOut:
        msgs, new_state = saga_lib.saga_correct_scatter(state, grads,
                                                        sample_idx, rows)
        return msgs, new_state, {}

    def hold(self, state, sample_idx, rows=None):
        return saga_lib.held_rows(state, sample_idx, rows)

    def restore(self, state, held, sample_idx, rows=None):
        saga_lib.restore_rows(state, held, sample_idx, rows)


class LooplessSvrgReducer(VarianceReducer):
    """Byzantine-robust loopless SVRG (arXiv:2303.04560).

    Message: ``m_w = g_w(x) - g_w(x~_w) + mu_w`` on the drawn sample, then
    with probability ``cfg.lsvrg_p`` (one coin a worker a step) the
    snapshot refreshes: ``x~_w <- x``, ``mu_w <- grad f_w(x)`` (the full
    local gradient).  The reference computes the full gradient for every
    worker and selects it where the coin came up; this port reads the coin
    on the host (one sync a step) and computes it only for those workers,
    which is the same function at a fraction of the work (a step where no
    coin comes up computes none).  State is updated in place.
    """

    name = "lsvrg"
    uses_oracles = True

    def init_sim(self, params, *, per_sample_grads_fn, num_workers,
                 full_grads_fn=None, spec=None):
        flat = spec.pack(params, batch_ndim=0)
        snapshot = flat[None].expand(num_workers, flat.shape[0]).clone()
        return LsvrgState(snapshot=snapshot, anchor=full_grads_fn())

    def correct(self, state, grads, sample_idx, *, rows=None, params=None,
                grads_at=None, full_grads_at=None, generator=None, coin=None,
                **kw) -> CorrectOut:
        if params is None or grads_at is None:
            raise ValueError(
                "lsvrg needs params= and grads_at= (gradients at the "
                "snapshot); the step builder must bind both oracles")
        snap, anchor = (state if rows is None else
                        participation_lib.gather_rows(state, rows))
        msgs = grads - grads_at(snap) + anchor
        w = grads.shape[0]
        if coin is None:
            coin = torch.rand((w,), generator=generator,
                              device=grads.device) < self.cfg.lsvrg_p
        else:
            coin = torch.as_tensor(coin, dtype=torch.bool, device=grads.device)
            if tuple(coin.shape) != (w,):
                raise ValueError(f"lsvrg: coin must be ({w},), got "
                                 f"{tuple(coin.shape)}")
        sel = torch.nonzero(coin).flatten()
        if sel.numel():
            fresh = (full_grads_at(sel) if full_grads_at is not None
                     else grads[sel])
            dst = sel if rows is None else rows[sel]
            state.snapshot[dst] = params[sel].to(state.snapshot.dtype)
            state.anchor[dst] = fresh.to(state.anchor.dtype)
        return msgs, state, {"vr_snapshot_rate": torch.mean(coin.float())}

    def hold(self, state, sample_idx, rows=None):
        if rows is None:
            return LsvrgState(*(t.clone() for t in state))
        return participation_lib.gather_rows(state, rows)

    def restore(self, state, held, sample_idx, rows=None):
        if rows is None:
            for t, h in zip(state, held):
                t.copy_(h)
        else:
            participation_lib.scatter_rows(state, rows, held)


_REDUCERS: dict[str, type[VarianceReducer]] = {
    "sgd": VarianceReducer,
    "minibatch": MinibatchReducer,
    "saga": SagaReducer,
    "lsvrg": LooplessSvrgReducer,
}

VR_NAMES = tuple(_REDUCERS)

# The reference's reducers that the port does not carry yet.
UNPORTED: tuple[str, ...] = ()


def get_reducer(cfg) -> VarianceReducer:
    """Build the variance reducer named by ``cfg.vr``."""
    try:
        cls = _REDUCERS[cfg.vr]
    except KeyError:
        raise ValueError(
            f"unknown variance reducer {cfg.vr!r}; known: "
            f"{', '.join(sorted(_REDUCERS))}") from None
    return cls(cfg)
