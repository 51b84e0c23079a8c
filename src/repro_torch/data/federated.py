"""Federated partitioning (port of ``repro/data/federated.py``).

The split is drawn with numpy's seeded generator exactly as the reference
draws it, so the same dataset and seed give the same worker shards.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def partition(data: dict[str, torch.Tensor], num_workers: int, *,
              mode: str = "iid", seed: int = 0,
              samples_per_worker: int | None = None,
              device: str | torch.device = DEFAULT_DEVICE
              ) -> dict[str, torch.Tensor]:
    """Return worker-stacked data on ``device``: values (W, J, ...).

    ``data`` maps names to tensors (or arrays) with a leading sample axis.
    ``mode``:
      * ``iid``        -- random shuffle, even contiguous split.
      * ``replicated`` -- every worker holds the same J samples (delta^2=0,
                          paper Fig. 5).
      * ``sorted``     -- sorted by the last name's values (the labels), a
                          stable sort: maximal heterogeneity (beyond-paper).
    """
    dev = resolve_device(device)
    names = sorted(data)
    leaves = [torch.as_tensor(data[k], device=dev) for k in names]
    n = leaves[0].shape[0]
    rng = np.random.default_rng(seed)

    if mode == "replicated":
        j = samples_per_worker or n
        idx = torch.as_tensor(rng.permutation(n)[:j], device=dev)
        return {k: l[idx].unsqueeze(0).expand(
                    (num_workers,) + (-1,) * l.dim()).contiguous()
                for k, l in zip(names, leaves)}
    if mode == "iid":
        order = rng.permutation(n)
    elif mode == "sorted":
        order = np.argsort(leaves[-1].cpu().numpy(), kind="stable")
    else:
        raise ValueError(f"unknown partition mode {mode!r}")
    j = samples_per_worker or (n // num_workers)
    if num_workers * j > n:
        raise ValueError(f"need {num_workers * j} samples, have {n}")
    order = torch.as_tensor(order[: num_workers * j].reshape(num_workers, j),
                            device=dev)
    return {k: l[order] for k, l in zip(names, leaves)}
