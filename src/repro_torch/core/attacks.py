"""Byzantine attack models of the paper's Sec. V (port of
``repro/core/attacks.py``).

An attack maps the honest workers' packed messages (W_h, D) to the full
message set (W_h + B, D) by appending B malicious rows; the attackers see
the honest messages (omniscient, colluding).

* ``gaussian``      -- N(mean(honest), 30 I) per coordinate.
* ``sign_flip``     -- u * mean(honest) with u = -3.
* ``zero_gradient`` -- -(1/B) sum(honest): the mean of all W messages is 0.
* ``alie``          -- "a little is enough": mean + z * std per coordinate
  (the population std, as ``jnp.std``), written against coordinate-wise
  rules.
* ``ipm``           -- inner-product manipulation: -eps * mean(honest).
* ``straggler``     -- a report stale by ``straggler_k`` rounds, proxied as
  the honest mean scaled by ``1 + 0.25 * straggler_k``; its slot carries
  staleness ``straggler_k`` (:mod:`repro_torch.core.participation`).
* ``dropout``       -- an absent participant: all-zero rows whose staleness
  saturates at the bound, so staleness-aware rules weight them to 0.
* ``none``          -- no Byzantine rows.

Fault attacks (``FAULT_ATTACKS``), outside the paper's threat model; the
guards of :mod:`repro_torch.core.guards` contain them:

* ``nan``           -- every real coordinate NaN (padding stays 0).
* ``inf_overflow``  -- +-1e30 signed like the honest mean: finite, but its
  squared norm overflows float32.
* ``bitflip``       -- the high exponent bit of ~``bitflip_prob`` of the
  honest mean's coordinates flipped, at coordinates picked by an integer
  hash of (row, leaf, coordinate, seed) -- no random stream, so the port
  corrupts exactly the reference's coordinates.

``gaussian`` draws its noise from the caller's :class:`torch.Generator`, or
takes it ready-made as ``noise`` (standard-normal draws, (B, D)) so a test
can hand in the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.core import packing


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    name: str = "none"
    num_byzantine: int = 0
    # Attack-specific knobs (paper values as defaults).
    gaussian_variance: float = 30.0
    sign_flip_magnitude: float = -3.0
    alie_z: float = 1.0
    ipm_eps: float = 0.5
    straggler_k: int = 4
    bitflip_prob: float = 0.02
    bitflip_seed: int = 0


# Magnitude of the ``inf_overflow`` payload: finite in float32, but its
# squared norm overflows to +inf.
OVERFLOW_MAGNITUDE = 1e30

_M32 = 0xFFFFFFFF


def _append(honest: torch.Tensor, byz: torch.Tensor) -> torch.Tensor:
    return torch.cat([honest, byz.to(honest.dtype)], dim=0)


def _rows(vec: torch.Tensor, b: int) -> torch.Tensor:
    return vec[None].expand(b, -1)


def none_attack(cfg, honest, generator, noise, spec=None):
    return honest


def gaussian_attack(cfg, honest, generator, noise, spec=None):
    mean = torch.mean(honest, dim=0)
    shape = (cfg.num_byzantine, honest.shape[1])
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=honest.device)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"gaussian: noise must be {shape}, got "
                         f"{tuple(noise.shape)}")
    std = math.sqrt(cfg.gaussian_variance)
    return _append(honest, mean[None] + std * noise.to(honest.device))


def sign_flip_attack(cfg, honest, generator, noise, spec=None):
    mean = torch.mean(honest, dim=0)
    return _append(honest, _rows(cfg.sign_flip_magnitude * mean,
                                 cfg.num_byzantine))


def zero_gradient_attack(cfg, honest, generator, noise, spec=None):
    # m_byz = -(1/B) * sum_honest  =>  sum over all W messages == 0.
    return _append(honest, _rows(-torch.sum(honest, dim=0) / cfg.num_byzantine,
                                 cfg.num_byzantine))


def alie_attack(cfg, honest, generator, noise, spec=None):
    if honest.dtype == torch.bfloat16:
        # jnp.std is the root of the variance in the buffer's dtype: on the
        # bf16 wire the variance is rounded to bf16 before the root.
        std = torch.sqrt(torch.var(honest, dim=0, correction=0))
    else:
        std = torch.std(honest, dim=0, correction=0)
    stats = torch.mean(honest, dim=0) + cfg.alie_z * std
    return _append(honest, _rows(stats, cfg.num_byzantine))


def ipm_attack(cfg, honest, generator, noise, spec=None):
    return _append(honest, _rows(-cfg.ipm_eps * torch.mean(honest, dim=0),
                                 cfg.num_byzantine))


def straggler_attack(cfg, honest, generator, noise, spec=None):
    scale = 1.0 + 0.25 * cfg.straggler_k
    return _append(honest, _rows(scale * torch.mean(honest, dim=0),
                                 cfg.num_byzantine))


def dropout_attack(cfg, honest, generator, noise, spec=None):
    return _append(honest, torch.zeros((cfg.num_byzantine, honest.shape[1]),
                                       dtype=honest.dtype,
                                       device=honest.device))


def _fault_fill(value_fn, mean: torch.Tensor, spec=None) -> torch.Tensor:
    """Coordinate-wise fault payload from the honest mean (D,) or (R, D);
    the padding coordinates past ``spec.dim`` stay 0, as in every honest
    row."""
    out = value_fn(mean)
    if spec is None or spec.pad == 0:
        return out
    keep = torch.arange(mean.shape[-1], device=mean.device) < spec.dim
    return torch.where(keep, out, torch.zeros_like(mean))


def _hash01(row_ids: torch.Tensor, n: int, salt: int) -> torch.Tensor:
    """(R, n) float32 pseudo-uniforms in [0, 1) from an integer hash of
    (row id, coordinate, salt): the reference's wrapping uint32 hash, in
    int64 with every product and sum masked to its low 32 bits (a wrapped
    int64 product keeps them), then converted to float32 with round to
    nearest, as XLA's u32 -> f32."""
    r = row_ids.to(torch.int64)[:, None] & _M32
    c = torch.arange(n, dtype=torch.int64, device=row_ids.device)[None, :]
    h = (((r * 0x9E3779B9) & _M32) + ((c * 0x85EBCA6B) & _M32)) & _M32
    h = (h + (((salt & _M32) * 0xC2B2AE35) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & _M32
    h = h ^ (h >> 16)
    return h.to(torch.float32) / 4294967296.0


def _flip_exponent_bit(x: torch.Tensor) -> torch.Tensor:
    """XOR the high exponent bit of the float32 encoding: magnitudes jump
    by ~2^128 (values in [1, 4) become inf or NaN)."""
    return (x.float().contiguous().view(torch.int32) ^ (1 << 30)
            ).view(torch.float32)


def _segments(spec, d: int) -> tuple[tuple[int, int], ...]:
    """The leaf segments the hash runs over: the spec's boundaries, or the
    whole row as one leaf."""
    return tuple(spec.boundaries) if spec is not None else ((0, d),)


def bitflip_rows(mean: torch.Tensor, row_ids: torch.Tensor, *, prob: float,
                 seed: int, spec=None) -> torch.Tensor:
    """Byzantine rows of the ``bitflip`` attack: the honest mean (D,)
    broadcast to ``len(row_ids)`` rows, the exponent bit of ~``prob`` of
    each row's coordinates flipped.  The hash runs per leaf segment of
    ``spec`` with salt ``seed * 1000003 + leaf``; ``row_ids`` are the rows'
    relative Byzantine indices; padding is never corrupted."""
    d = mean.shape[-1]
    rows = mean.float()[None].expand(row_ids.shape[0], d)
    out = rows.clone()
    for i, (a, b) in enumerate(_segments(spec, d)):
        u = _hash01(row_ids, b - a, seed * 1000003 + i)
        out[:, a:b] = torch.where(u < prob, _flip_exponent_bit(rows[:, a:b]),
                                  rows[:, a:b])
    return out.to(mean.dtype)


def bitflip_edges(mean: torch.Tensor, sender_ids: torch.Tensor, *,
                  prob: float, seed: int, spec=None) -> torch.Tensor:
    """Per-edge ``bitflip`` payloads (R, S, D): sender ``s``'s message
    toward receiver ``r`` is r's neighbourhood mean ``mean[r]`` with the
    exponent bit flipped at coordinates hashed per (sender id, coordinate),
    so a sender corrupts the same positions toward every receiver."""
    r, d = mean.shape
    rows = mean.float()[:, None].expand(r, sender_ids.shape[0], d)
    out = rows.clone()
    for i, (a, b) in enumerate(_segments(spec, d)):
        u = _hash01(sender_ids, b - a, seed * 1000003 + i)
        out[..., a:b] = torch.where(u[None] < prob,
                                    _flip_exponent_bit(rows[..., a:b]),
                                    rows[..., a:b])
    return out.to(mean.dtype)


def _nan_fill(m: torch.Tensor) -> torch.Tensor:
    return torch.full_like(m, torch.nan)


def _overflow_fill(m: torch.Tensor) -> torch.Tensor:
    return torch.where(m < 0, -OVERFLOW_MAGNITUDE, OVERFLOW_MAGNITUDE
                       ).to(m.dtype)


def nan_attack(cfg, honest, generator, noise, spec=None):
    byz = _fault_fill(_nan_fill, torch.mean(honest, dim=0), spec)
    return _append(honest, _rows(byz, cfg.num_byzantine))


def inf_overflow_attack(cfg, honest, generator, noise, spec=None):
    byz = _fault_fill(_overflow_fill, torch.mean(honest, dim=0), spec)
    return _append(honest, _rows(byz, cfg.num_byzantine))


def bitflip_attack(cfg, honest, generator, noise, spec=None):
    ids = torch.arange(cfg.num_byzantine, device=honest.device)
    return _append(honest, bitflip_rows(
        torch.mean(honest, dim=0), ids, prob=cfg.bitflip_prob,
        seed=cfg.bitflip_seed, spec=spec))


_ATTACKS: dict[str, Callable] = {
    "none": none_attack,
    "gaussian": gaussian_attack,
    "sign_flip": sign_flip_attack,
    "zero_gradient": zero_gradient_attack,
    "alie": alie_attack,
    "ipm": ipm_attack,
    "straggler": straggler_attack,
    "dropout": dropout_attack,
    "nan": nan_attack,
    "inf_overflow": inf_overflow_attack,
    "bitflip": bitflip_attack,
}

ATTACK_NAMES = tuple(_ATTACKS)

# The reference's attacks that the port does not carry yet.
UNPORTED: tuple[str, ...] = ()

# Attacks whose Byzantine slots carry nonzero staleness counters: with one
# of them (or partial participation) the steps aggregate with staleness
# weights.
STALENESS_ATTACKS = ("straggler", "dropout")

# Payloads with non-finite or norm-overflowing coordinates.
FAULT_ATTACKS = ("nan", "inf_overflow", "bitflip")


def check_attack_name(name: str) -> None:
    if name not in _ATTACKS:
        raise ValueError(f"unknown attack {name!r}; known: "
                         f"{', '.join(sorted(_ATTACKS))}")


def apply_attack(cfg: AttackConfig, honest: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 noise: Optional[torch.Tensor] = None,
                 spec=None) -> torch.Tensor:
    """Return the full (W_h + B, D) message set seen by the master.
    ``spec`` is the buffer's PackSpec: the fault attacks keep its padding
    at 0 and hash ``bitflip`` per leaf segment.  ``honest`` may also be a
    dict of per-leaf (W_h, *shape) messages (the per-leaf baseline): it is
    packed, attacked with its PackSpec and unpacked to (W_h + B, *shape)
    leaves, which is the reference's per-leaf attack (every attack is
    coordinate-separable, and the packed ``gaussian`` and ``bitflip`` draw
    and hash per leaf); ``noise`` is then packed (B, D) too."""
    check_attack_name(cfg.name)
    if cfg.num_byzantine == 0:
        return honest
    if isinstance(honest, dict):
        spec = packing.pack_spec(honest)
        out = _ATTACKS[cfg.name](cfg, spec.pack(honest), generator, noise, spec)
        return spec.unpack(out)
    return _ATTACKS[cfg.name](cfg, honest, generator, noise, spec)
