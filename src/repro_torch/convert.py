"""Carry weights and training state from the JAX reference to the port.

Both take the reference's objects with numpy (or array-like) leaves -- for
example ``jax.tree.map(np.asarray, state)`` -- so this module needs no
JAX.  After conversion both packages compute the same step on the same
numbers, which is what the parity tests check.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.robust_step import FederatedState
from repro_torch.core.saga import SagaState
from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device


def params_from_jax(tree: dict[str, Any], *,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> dict[str, torch.Tensor]:
    """A flat ``{name: array}`` parameter dict -> ``{name: tensor}``."""
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            raise ValueError(f"params_from_jax takes a flat dict; {k!r} is "
                             "nested")
        out[k] = torch.as_tensor(np.array(v), device=dev)
    return out


def state_from_jax(state: Any, *, seed: int | torch.Generator = 0,
                   device: str | torch.device = DEFAULT_DEVICE
                   ) -> FederatedState:
    """A reference ``FederatedState`` of the packed master or decentralized
    path -> the port's.  Carries params (per-node (N, ...) leaves on the
    decentralized path), the packed ``SagaState`` table (W_h, J, D) and avg
    (W_h, D), and step; the optimizer must be stateless (``sgd``).  The
    reference's PRNG key has no torch counterpart: the port's generator is
    seeded with ``seed``."""
    dev = resolve_device(device)
    opt = state.opt_state
    if not (opt is None or (isinstance(opt, tuple) and not opt)):
        raise ValueError("state_from_jax carries the stateless sgd optimizer "
                         "only; other optimizers are still to port")
    vr = state.vr
    if vr is not None:
        if not hasattr(vr, "table") or isinstance(vr.table, dict):
            raise ValueError("state_from_jax expects the packed SagaState "
                             "(table (W, J, D), avg (W, D))")
        vr = SagaState(
            table=torch.as_tensor(np.array(vr.table, np.float32), device=dev),
            avg=torch.as_tensor(np.array(vr.avg, np.float32), device=dev))
    return FederatedState(params_from_jax(state.params, device=dev), (), vr,
                          int(np.asarray(state.step)), generator_for(seed, dev))
