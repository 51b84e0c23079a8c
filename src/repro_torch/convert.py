"""Carry weights and training state from the JAX reference to the port.

Each takes the reference's objects with numpy (or array-like) leaves -- for
example ``jax.tree.map(np.asarray, state)`` -- so this module needs no
JAX.  After conversion both packages compute the same step on the same
numbers, which is what the parity tests check.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.robust_step import FederatedState
from repro_torch.core.saga import SagaState
from repro_torch.core.variance import LsvrgState
from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device
from repro_torch.models import transformer as tfm


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
    (W_h, D) or ``LsvrgState`` snapshot and anchor (W_h, D) -- per client,
    (C, ...), under partial participation; in bfloat16 on the bf16 wire --
    the staleness counters, sign1's error-feedback residuals ``ef``, the
    guards' health vector and step; the optimizer must be stateless
    (``sgd``).  The reference's PRNG key has no torch counterpart: the
    port's generator is seeded with ``seed``."""
    dev = resolve_device(device)
    opt = state.opt_state
    if not (opt is None or (isinstance(opt, tuple) and not opt)):
        raise ValueError("state_from_jax carries the stateless sgd optimizer "
                         "only; other optimizers are still to port")

    def tensor(a, dtype=np.float32):
        return torch.as_tensor(np.array(a, dtype), device=dev)

    def buffer(a):
        """A packed buffer in its own dtype: bfloat16 stays bfloat16."""
        return _tensor(a).to(dev) if np.asarray(a).dtype.name == "bfloat16" \
            else tensor(a)

    vr = state.vr
    if vr is not None:
        if hasattr(vr, "snapshot") and not isinstance(vr.snapshot, dict):
            vr = LsvrgState(snapshot=buffer(vr.snapshot),
                            anchor=buffer(vr.anchor))
        elif hasattr(vr, "table") and not isinstance(vr.table, dict):
            vr = SagaState(table=buffer(vr.table), avg=buffer(vr.avg))
        else:
            raise ValueError("state_from_jax expects a packed SagaState "
                             "(table (W, J, D), avg (W, D)) or LsvrgState "
                             "(snapshot, anchor (W, D))")
    staleness = getattr(state, "staleness", None)
    ef = getattr(state, "ef", None)
    health = getattr(state, "health", None)
    return FederatedState(
        params_from_jax(state.params, device=dev), (), vr,
        int(np.asarray(state.step)), generator_for(seed, dev),
        None if staleness is None else tensor(staleness, np.int32),
        None if ef is None else tensor(ef),
        None if health is None else tensor(health))


def _flatten(tree: dict[str, Any], prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{name}."))
        else:
            out[name] = v
    return out


def _tensor(leaf: Any) -> torch.Tensor:
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _empty_maker(dtype: torch.dtype, device: torch.device):
    def make(path, shape, init=None) -> torch.nn.Parameter:
        del path, init
        return torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                              device=device), requires_grad=False)
    return make


def model_params_from_jax(tree: dict[str, Any], cfg: ModelConfig, *,
                          device: str | torch.device = DEFAULT_DEVICE
                          ) -> tfm.Decoder:
    """The reference's decoder parameter tree (``build_model(cfg).init``:
    ``embed``, ``blocks.pos{i}.<sublayer>.<leaf>`` stacked over the periods,
    ``final_norm``, ``unembed``) -> the port's :class:`Decoder` in
    ``cfg.dtype``.  Period ``p`` of pattern position ``i`` becomes layer
    ``p * len(pattern) + i``; a MoE block's leaves (``moe.router``, the
    stacked experts ``moe.w_in``/``w_gate``/``w_out`` (E, ...) and the
    shared MLP ``moe.shared.*``) by the same rule.  Raises on a missing or extra leaf and on a
    shape that does not match."""
    dev = resolve_device(device)
    pat, periods = cfg.resolve_pattern()
    model = tfm.decoder_params(_empty_maker(cfg.dtype, dev), cfg)
    want = dict(model.named_parameters())
    got = {}
    for name, leaf in _flatten(tree).items():
        t = _tensor(leaf)
        parts = name.split(".")
        if parts[0] == "blocks":
            i = int(parts[1].removeprefix("pos"))
            if t.shape[:1] != (periods,):
                raise ValueError(f"model_params_from_jax: {name} "
                                 f"{tuple(t.shape)} is not stacked over "
                                 f"{periods} periods")
            for p in range(periods):
                got[".".join(["blocks", str(p * len(pat) + i), *parts[2:]])] = t[p]
        else:
            got[name] = t
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"model_params_from_jax: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, param in want.items():
            if tuple(got[name].shape) != tuple(param.shape):
                raise ValueError(f"model_params_from_jax: {name} is "
                                 f"{tuple(got[name].shape)}, the port's "
                                 f"{tuple(param.shape)}")
            param.copy_(got[name].to(param.dtype))
    return model
