"""The paper's Table I network (port of ``benchmarks/table1_nn.py``'s
model): 784 inputs, one hidden layer of 50 tanh units, 10 classes."""
from __future__ import annotations

import torch

from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device

HIDDEN = 50


def init_params(seed: int | torch.Generator, p: int = 784, h: int = HIDDEN,
                classes: int = 10, *,
                device: str | torch.device = DEFAULT_DEVICE
                ) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    g = generator_for(seed, dev)
    return {"w1": 0.05 * torch.randn((p, h), generator=g, device=dev),
            "b1": torch.zeros((h,), device=dev),
            "w2": 0.05 * torch.randn((h, classes), generator=g, device=dev),
            "b2": torch.zeros((classes,), device=dev)}


def _logits(params, x):
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def nn_loss(params, batch):
    """Mean softmax cross-entropy; ``batch["y"]`` holds integer labels."""
    logits = _logits(params, batch["x"])
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, batch["y"].long()[:, None])[:, 0]
    return torch.mean(lse - tgt)


def accuracy(params, batch) -> float:
    with torch.no_grad():
        pred = torch.argmax(_logits(params, batch["x"]), dim=-1)
        return float(torch.mean((pred == batch["y"]).float()))
