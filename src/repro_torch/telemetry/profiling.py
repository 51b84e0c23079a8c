"""Per-phase wall-clock timers for a train loop (port of
``repro/telemetry/profiling.py``).

CUDA calls return before the card has finished, so a timer that only read
the host clock would time the launches.  :class:`PhaseTimer` therefore
synchronizes the device at both ends of every phase (``device=None`` skips
that, for host-only phases): a phase's seconds include the device work it
queued."""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

import torch


class PhaseTimer:
    """Accumulate wall-clock seconds per phase; ``snapshot()`` drains.
    ``device``: the CUDA device to synchronize at phase boundaries (the
    current one by default when a card is present; None on the CPU)."""

    def __init__(self, device: Optional[str | torch.device] = "auto"):
        if device == "auto":
            device = "cuda" if torch.cuda.is_available() else None
        self.device = None if device is None else torch.device(device)
        self._acc: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self._acc[name] = (self._acc.get(name, 0.0)
                               + time.perf_counter() - t0)

    def snapshot(self) -> dict[str, float]:
        """``{"time_<phase>_s": seconds}`` accumulated since the last
        snapshot, then reset."""
        out = {f"time_{k}_s": round(v, 6) for k, v in self._acc.items()}
        self._acc = {}
        return out
