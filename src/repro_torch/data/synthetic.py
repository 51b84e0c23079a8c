"""Synthetic datasets matched to the paper's workloads (port of
``repro/data/synthetic.py``).

Data is drawn from a seeded :class:`torch.Generator` on the target device,
so a full-size set is made in bulk where it will be used.  The draws are
not JAX's: parity tests build their arrays with the reference and hand them
in (``convert.params_from_jax`` / ``torch.as_tensor``).

* :func:`logreg_dataset` -- binary classification with labels in {-1, +1}
  from a planted logistic model (IJCNN1-like: p=22; COVTYPE-like: p=54).
* :func:`mnist_like`     -- 10-class Gaussian-blob images (p=784) for the
  one-hidden-layer network of Table I.
* :func:`token_stream`   -- one language-model batch of random tokens and
  their next-token labels.
* :func:`logreg_loss` / :func:`logreg_full_loss_and_opt` -- the paper's
  l2-regularized logistic loss and its full-batch optimum f(x*).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DEFAULT_DEVICE, generator_for, resolve_device


class Dataset(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor


def logreg_dataset(seed: int | torch.Generator, n: int, p: int, *,
                   noise: float = 0.1, scale: float = 1.0,
                   device: str | torch.device = DEFAULT_DEVICE) -> Dataset:
    """Features ~ N(0, scale); labels from a planted logistic model with
    label-flip noise."""
    dev = resolve_device(device)
    g = generator_for(seed, dev)
    x = scale * torch.randn((n, p), generator=g, device=dev)
    w_true = torch.randn((p,), generator=g, device=dev)
    y = torch.sign(x @ w_true)
    flip = torch.rand((n,), generator=g, device=dev) < noise
    y = torch.where(flip, -y, y)
    y = torch.where(y == 0, torch.ones_like(y), y)
    return Dataset(x=x, y=y)


def ijcnn1_like(seed: int | torch.Generator, n: int = 4_000, *,
                device: str | torch.device = DEFAULT_DEVICE) -> Dataset:
    """IJCNN1 surrogate: p=22 (real set: 49,990 x 22)."""
    return logreg_dataset(seed, n, 22, device=device)


def covtype_like(seed: int | torch.Generator, n: int = 4_000, *,
                 device: str | torch.device = DEFAULT_DEVICE) -> Dataset:
    """COVTYPE surrogate: p=54 (real set: 581,012 x 54)."""
    return logreg_dataset(seed, n, 54, device=device)


def mnist_like(seed: int | torch.Generator, n: int = 2_000,
               num_classes: int = 10, p: int = 784, *,
               device: str | torch.device = DEFAULT_DEVICE) -> Dataset:
    """Gaussian class-blob images in [0,1]^784 with int64 labels."""
    dev = resolve_device(device)
    g = generator_for(seed, dev)
    centers = torch.rand((num_classes, p), generator=g, device=dev)
    y = torch.arange(n, device=dev) % num_classes
    noise = 0.3 * torch.randn((n, p), generator=g, device=dev)
    x = torch.clamp(centers[y] + noise, 0.0, 1.0)
    return Dataset(x=x, y=y)


def token_stream(batch: int, seq_len: int, vocab: int, *,
                 generator: int | torch.Generator = 0,
                 device: str | torch.device = DEFAULT_DEVICE
                 ) -> dict[str, torch.Tensor]:
    """One LM training batch: ``tokens`` (batch, seq_len) drawn uniformly
    from [0, vocab) and ``labels``, the same stream shifted by one (the next
    token); int64, torch's index dtype (the reference's are int32)."""
    dev = resolve_device(device)
    g = generator_for(generator, dev)
    toks = torch.randint(0, vocab, (batch, seq_len + 1), generator=g,
                         device=dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def logreg_loss(rho: float = 0.01):
    """l2-regularized logistic loss of the paper (Sec. V-A):
    f(x) = ln(1 + exp(-b <a, x>)) + rho/2 ||x||^2, averaged over the batch."""

    def loss(params, batch):
        w = params["w"]
        margins = -batch["b"] * (batch["a"] @ w)
        nll = torch.mean(torch.logaddexp(torch.zeros_like(margins), margins))
        return nll + 0.5 * rho * torch.sum(w * w)

    return loss


def logreg_full_loss_and_opt(data: Dataset, rho: float = 0.01,
                             iters: int = 4000, lr: float = 0.5):
    """Solve the full-batch problem by constant-step gradient descent to get
    f(x*) for optimality gaps.  Runs on the device that holds ``data``."""
    loss = logreg_loss(rho)
    batch = {"a": data.x, "b": data.y}
    params = {"w": torch.zeros((data.x.shape[1],), dtype=torch.float32,
                               device=data.x.device)}
    grad = torch.func.grad(loss)
    for _ in range(iters):
        params = {"w": params["w"] - lr * grad(params, batch)["w"]}
    with torch.no_grad():
        return params, float(loss(params, batch))
