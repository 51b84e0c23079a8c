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
* ``none``          -- no Byzantine rows.

``gaussian`` draws its noise from the caller's :class:`torch.Generator`, or
takes it ready-made as ``noise`` (standard-normal draws, (B, D)) so a test
can hand in the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    name: str = "none"
    num_byzantine: int = 0
    # Attack-specific knobs (paper values as defaults).
    gaussian_variance: float = 30.0
    sign_flip_magnitude: float = -3.0
    alie_z: float = 1.0
    ipm_eps: float = 0.5


def _append(honest: torch.Tensor, byz: torch.Tensor) -> torch.Tensor:
    return torch.cat([honest, byz.to(honest.dtype)], dim=0)


def _rows(vec: torch.Tensor, b: int) -> torch.Tensor:
    return vec[None].expand(b, -1)


def none_attack(cfg, honest, generator, noise):
    return honest


def gaussian_attack(cfg, honest, generator, noise):
    mean = torch.mean(honest, dim=0)
    shape = (cfg.num_byzantine, honest.shape[1])
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=honest.device)
    elif tuple(noise.shape) != shape:
        raise ValueError(f"gaussian: noise must be {shape}, got "
                         f"{tuple(noise.shape)}")
    std = math.sqrt(cfg.gaussian_variance)
    return _append(honest, mean[None] + std * noise.to(honest.device))


def sign_flip_attack(cfg, honest, generator, noise):
    mean = torch.mean(honest, dim=0)
    return _append(honest, _rows(cfg.sign_flip_magnitude * mean,
                                 cfg.num_byzantine))


def zero_gradient_attack(cfg, honest, generator, noise):
    # m_byz = -(1/B) * sum_honest  =>  sum over all W messages == 0.
    return _append(honest, _rows(-torch.sum(honest, dim=0) / cfg.num_byzantine,
                                 cfg.num_byzantine))


def alie_attack(cfg, honest, generator, noise):
    stats = (torch.mean(honest, dim=0)
             + cfg.alie_z * torch.std(honest, dim=0, correction=0))
    return _append(honest, _rows(stats, cfg.num_byzantine))


def ipm_attack(cfg, honest, generator, noise):
    return _append(honest, _rows(-cfg.ipm_eps * torch.mean(honest, dim=0),
                                 cfg.num_byzantine))


_ATTACKS: dict[str, Callable] = {
    "none": none_attack,
    "gaussian": gaussian_attack,
    "sign_flip": sign_flip_attack,
    "zero_gradient": zero_gradient_attack,
    "alie": alie_attack,
    "ipm": ipm_attack,
}

ATTACK_NAMES = tuple(_ATTACKS)

# The reference's attacks that the port does not carry yet.
UNPORTED = ("straggler", "dropout", "nan", "inf_overflow", "bitflip")


def check_attack_name(name: str) -> None:
    if name not in _ATTACKS:
        raise ValueError(
            f"unknown attack {name!r}; ported: "
            f"{', '.join(sorted(_ATTACKS))}; still to port from the "
            f"reference: {', '.join(UNPORTED)} (ROADMAP.md Queue A item 5)")


def apply_attack(cfg: AttackConfig, honest: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Return the full (W_h + B, D) message set seen by the master."""
    check_attack_name(cfg.name)
    if cfg.num_byzantine == 0:
        return honest
    return _ATTACKS[cfg.name](cfg, honest, generator, noise)
