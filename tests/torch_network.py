"""K4's and K5's sorting network emulated in torch on the CPU, as the CUDA
kernels of ``csrc/robust_stats.cu`` run it; shared by
``tests/test_torch_aggregators.py``, ``tests/test_torch_median_pairs.py`` and
``tests/test_torch_trimmed_pairs.py``.
Imports torch and the port only (no JAX)."""
import torch

from repro_torch.kernels import robust_stats as rs


def network_sort(z: torch.Tensor, n: int,
                 pairs: list[tuple[int, int]]) -> list[torch.Tensor]:
    """The network of K4 and K5 emulated in torch, as the kernels run it on
    each column of ``z`` (W <= n rows): each NaN enters as +inf, the column
    is padded with +inf to ``n`` wires and ``pairs`` sort it with float
    min/max.  Returns the ``n`` sorted wires."""
    v = list(torch.where(torch.isnan(z), torch.inf, z)) + [
        torch.full_like(z[0], torch.inf)] * (n - z.shape[0])
    for a, b in pairs:
        v[a], v[b] = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])
    return v


def network_median(z: torch.Tensor) -> torch.Tensor:
    """K4's network route: the sorted wires of :func:`network_sort`, a
    rank of W - #NaN or more reading NaN."""
    w = z.shape[0]
    v = network_sort(z, *rs.median_network_pairs(w))
    count = torch.isnan(z).sum(0)

    def rank(r):
        return torch.where(r >= w - count, torch.nan, v[r])
    lo, hi = (w - 1) // 2, w // 2
    return rank(lo) if lo == hi else (rank(lo) + rank(hi)) * 0.5


def network_trimmed_mean(z: torch.Tensor, trim: int) -> torch.Tensor:
    """K5's network route: the kept ranks [trim, W - trim) of the sorted
    wires of :func:`network_sort` added in ascending rank order in float32
    from +0 and divided by W - 2 trim, NaN where #NaN > trim."""
    w = z.shape[0]
    n, pairs = rs.median_network_pairs(w)
    v = network_sort(z, n, pairs)
    acc = torch.zeros_like(z[0])
    for r in range(trim, w - trim):
        acc = acc + v[r]
    acc = acc / float(w - 2 * trim)
    return torch.where(torch.isnan(z).sum(0) > trim, torch.nan, acc)
