"""SAGA variance reduction on the packed per-worker gradient table, paper
Alg. 1 (port of ``repro/core/saga.py``).

Each honest worker ``w`` keeps ``table[w]`` -- the latest per-sample
gradient of each of its J samples, packed to (J, D) -- and ``avg[w]``, their
running mean.  Per step it draws ``i`` and sends

    m_w = f'_{w,i}(x) - table[w, i] + avg[w]

then sets ``avg[w] += (f'_{w,i}(x) - table[w, i]) / J`` and
``table[w, i] = f'_{w,i}(x)``.

The port keeps the state packed for the whole run -- table (W, J, D), avg
(W, D) -- and updates both IN PLACE: the table is the O(W*J*D) memory wall
(9.5 GB for the Table I network at MNIST size), so no step may hold a copy
of it.  On a CUDA device the update is kernel K1.  Under partial
participation the state is resident per client, (C, J, D) and (C, D), and
the round's cohort works on its own rows through K1's client-row route.

The state lives in the wire's buffer dtype: bfloat16 on the bf16 wire
(half the table), float32 otherwise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import packing
from repro_torch.kernels import ops


class SagaState(NamedTuple):
    """Per-worker SAGA memory: ``table`` (W, J, D), ``avg`` (W, D)."""

    table: torch.Tensor
    avg: torch.Tensor

    @property
    def num_samples(self) -> int:
        return self.table.shape[1]


def saga_init(per_sample_grads: torch.Tensor) -> SagaState:
    """Initialize from the packed gradients of *all* J samples at x^0
    (Alg. 1 init), shape (W, J, D).  The table IS ``per_sample_grads``: it
    is not copied.  The mean is accumulated in float32 and rounded once to
    the table's dtype, as ``jnp.mean`` does for a bf16 table."""
    avg = torch.mean(per_sample_grads, dim=1, dtype=torch.float32)
    return SagaState(table=per_sample_grads,
                     avg=avg.to(per_sample_grads.dtype))


def saga_init_zeros(params: dict[str, torch.Tensor], num_workers: int,
                    num_samples: int, dtype: torch.dtype | None = None
                    ) -> SagaState:
    """Cold-start init with a zero packed table (the table warms up over
    the first epoch); on the device of ``params``, in ``dtype`` (default
    float32, the packed buffer's)."""
    spec = packing.pack_spec(params, batch_ndim=0)
    dev = next(iter(params.values())).device
    dtype = dtype or torch.float32
    return SagaState(
        table=torch.zeros((num_workers, num_samples, spec.padded_dim),
                          dtype=dtype, device=dev),
        avg=torch.zeros((num_workers, spec.padded_dim), dtype=dtype,
                        device=dev))


def saga_correct_scatter(state: SagaState, grads: torch.Tensor,
                         sample_idx: torch.Tensor,
                         rows: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, SagaState]:
    """SAGA correction and table update for every worker at once.

    ``grads``: (W, D) fresh stochastic gradients; ``sample_idx``: (W,)
    int64 drawn rows; ``rows``: (W,) distinct client rows of a state
    resident per client, or None (worker w owns state row w).  Returns
    ``(messages (W, D), state)``, where ``state`` is the SAME object with
    ``table`` and ``avg`` updated in place (the TPU kernel's
    ``input_output_aliases`` contract).  Callers that need the old state
    must copy it first (:func:`held_rows`).
    """
    msgs = ops.saga_correct(grads, state.table, state.avg, sample_idx, rows)
    return msgs, state


def _state_rows(state: SagaState, sample_idx: torch.Tensor,
                rows: torch.Tensor | None) -> torch.Tensor:
    if rows is not None:
        return rows
    return torch.arange(sample_idx.shape[0], device=sample_idx.device)


def held_rows(state: SagaState, sample_idx: torch.Tensor,
              rows: torch.Tensor | None = None):
    """Copies of the entries a correction with these draws will write --
    ``table[r, sample_idx]`` and ``avg[r]``, (W, D) each -- so that a
    rejected round can put them back (:func:`restore_rows`)."""
    r = _state_rows(state, sample_idx, rows)
    return state.table[r, sample_idx], state.avg[r]


def restore_rows(state: SagaState, held, sample_idx: torch.Tensor,
                 rows: torch.Tensor | None = None) -> None:
    """Write :func:`held_rows`' copies back into the state, in place."""
    r = _state_rows(state, sample_idx, rows)
    state.table[r, sample_idx] = held[0]
    state.avg[r] = held[1]
