"""Buffered JSONL run logging (port of ``repro/telemetry/runlogger.py``).

:class:`RunLogger` takes each step's metrics dict with its values still on
the device and moves on; the buffered rows are copied to the host together
at each flush, so the train loop does not wait on the card every step.

Layout of a run directory::

    <log_dir>/metrics.jsonl   one JSON object per logged step
    <log_dir>/meta.json       the run's configuration and facts

With ``log_dir=None`` the logger writes nothing and only drives the
console callback.
"""
from __future__ import annotations

import atexit
import json
import os
from typing import Any, Callable, Optional

import numpy as np
import torch


def _host(x):
    """A metric value as JSON data: tensors and numpy values become Python
    numbers or nested lists."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, (np.ndarray, np.generic)):
        if x.ndim == 0:
            return x.item()
        return np.asarray(x).tolist()
    return x


class RunLogger:
    """Buffered metrics sink: a JSONL file and an optional console line.

    ``log_every``: keep every N-th step.  ``flush_every``: how many buffered
    rows trigger a write.  ``console``: ``(step, row) -> None`` called at
    flush time on the rows where ``console_every`` hits.  ``on_row``:
    ``(row) -> None`` called on every flushed row in step order.  A final
    flush is registered with ``atexit`` (and dropped by :meth:`close`), so
    rows buffered when the process dies still reach ``metrics.jsonl``.
    """

    def __init__(self, log_dir: Optional[str] = None, *, log_every: int = 1,
                 flush_every: int = 32,
                 console: Optional[Callable[[int, dict], None]] = None,
                 console_every: int = 0,
                 on_row: Optional[Callable[[dict], None]] = None):
        self.log_dir = log_dir
        self.log_every = max(int(log_every), 1)
        self.flush_every = max(int(flush_every), 1)
        self.console = console
        self.console_every = max(int(console_every), 0)
        self.on_row = on_row
        self._buf: list[tuple[int, dict, dict]] = []
        self._file = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "w")
        atexit.register(self.close)

    def write_meta(self, **fields: Any) -> None:
        """Write ``meta.json``; nothing without a ``log_dir``."""
        if self.log_dir is None:
            return
        with open(os.path.join(self.log_dir, "meta.json"), "w") as f:
            json.dump(fields, f, indent=2, sort_keys=True, default=str)
            f.write("\n")

    def log_step(self, step: int, metrics: dict,
                 host: Optional[dict] = None) -> None:
        """Buffer one step's metrics (device tensors are not read here);
        ``host`` carries values already on the host."""
        printing = self.console is not None and self.console_every and (
            step % self.console_every == 0)
        if step % self.log_every != 0 and not printing:
            return
        self._buf.append((step, dict(metrics), dict(host or {})))
        if len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        """Copy everything buffered to the host, then write the JSONL rows
        and the console lines."""
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        for step, metrics, host in buf:
            row = {"step": step}
            # Metric keys in sorted order, as the reference's rows have them.
            row.update({k: _host(metrics[k]) for k in sorted(metrics)})
            row.update({k: _host(v) for k, v in host.items()})
            if self._file is not None and step % self.log_every == 0:
                self._file.write(json.dumps(row) + "\n")
            if self.on_row is not None:
                self.on_row(row)
            if (self.console is not None and self.console_every
                    and step % self.console_every == 0):
                self.console(step, row)
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None
        atexit.unregister(self.close)

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
