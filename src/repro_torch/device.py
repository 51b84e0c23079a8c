"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """Map a ``device=`` argument to a :class:`torch.device`.

    Asking for CUDA on a machine without a usable card raises: the port
    never drops to the CPU on its own.  Pass ``device="cpu"`` to run the
    plain PyTorch path.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(dev)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev


def generator_for(seed: int | torch.Generator, device: torch.device) -> torch.Generator:
    """A :class:`torch.Generator` on ``device`` seeded with ``seed`` (an
    existing generator is returned as it is)."""
    if isinstance(seed, torch.Generator):
        return seed
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
