"""Mixture-of-Experts layer: top-k routing, optional shared experts,
capacity-based dispatch and combine (port of ``repro/models/moe.py``).

The reference routes each group of ``group`` tokens through one-hot
dispatch and combine einsums ((g, E, C) tensors, a ``lax.scan`` over the
groups).  The port computes the same values by indices, all groups at once:
each kept (token, k) pair is written into its slot of an (E, G * C, D)
buffer, the experts run as one batched product per projection
(``torch.bmm``, the stacked (E, D, F) weights), and each pair's output is
read back from its slot and weighted by its gate.  These are plain products
that the reference leaves to XLA, outside any Pallas kernel.

Routing, as the reference's (``moe.py:55-101``):

* tokens flattened to (T, D) and zero-padded to a multiple of
  ``group = min(group_size, T)``;
* capacity ``cap = max(int(group * top_k / E * capacity_factor), top_k)``,
  in Python float arithmetic;
* float32 softmax over ``x @ router``, top-k (among equal probabilities the
  lower expert first, as ``lax.top_k``), the gates renormalised;
* a pair's slot in its expert's buffer from a cumsum over the token-major
  flattened (g, k) one-hots; pairs at or past ``cap`` are dropped;
* the combine in float32; shared experts a dense MLP added after.

The Switch aux loss ``E * sum(frac * pmean)`` takes ``frac`` from the top-1
assignment and averages over the groups, padding rows included.
"""
from __future__ import annotations

import torch

from repro_torch.models import mlp as mlp_lib
from repro_torch.models.common import ACTIVATIONS

# The reference's sharding of the routed leaves over the "model" axis (the
# experts' hidden dimension), as spec tuples (repro/models/moe.py:28-33); the
# shared experts are an MLP and take mlp's.
PARAM_SPECS = {"moe.router": (None, None), "moe.w_in": (None, None, "model"),
               "moe.w_gate": (None, None, "model"),
               "moe.w_out": (None, "model", None)}


class MoEParams(torch.nn.Module):
    """The parameters of one MoE block: ``router`` (D, E), ``w_in`` and
    ``w_gate`` (E, D, F), ``w_out`` (E, F, D) and, with shared experts,
    ``shared`` (an MLP's ``ParameterDict``).  Read by key, as a dict."""

    def __init__(self, routed: dict, shared=None):
        super().__init__()
        for name, p in routed.items():
            self.register_parameter(name, p)
        if shared is not None:
            self.shared = shared

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return hasattr(self, name)


def moe_params(make, prefix: str, *, d_model: int, moe_d_ff: int,
               num_experts: int, num_shared_experts: int,
               activation: str) -> MoEParams:
    """In the reference's leaf order; ``w_gate`` exists for every
    activation, as there."""
    routed = {
        "router": make(f"{prefix}.router", (d_model, num_experts)),
        "w_in": make(f"{prefix}.w_in", (num_experts, d_model, moe_d_ff)),
        "w_gate": make(f"{prefix}.w_gate", (num_experts, d_model, moe_d_ff)),
        "w_out": make(f"{prefix}.w_out", (num_experts, moe_d_ff, d_model)),
    }
    shared = None
    if num_shared_experts:
        shared = mlp_lib.mlp_params(make, f"{prefix}.shared", d_model=d_model,
                                    d_ff=num_shared_experts * moe_d_ff,
                                    activation=activation)
    return MoEParams(routed, shared)


def _expert_ffn(params, xe: torch.Tensor, activation: str) -> torch.Tensor:
    """xe (E, N, D) -> (E, N, D): each expert's gated or plain FFN."""
    up = torch.bmm(xe, params["w_in"])
    if activation in mlp_lib.GATED:
        h = ACTIVATIONS[mlp_lib.GATED[activation]](
            torch.bmm(xe, params["w_gate"])) * up
    else:
        h = ACTIVATIONS[activation](up)
    return torch.bmm(h, params["w_out"])


def capacity(group: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert and group, the reference's Python arithmetic."""
    return max(int(group * top_k / num_experts * capacity_factor), top_k)


def route(logits: torch.Tensor, top_k: int):
    """Float32 router ``logits`` (G, g, E) -> (probs (G, g, E), gate values
    (G, g, k) renormalised, expert ids (G, g, k)).  A stable descending
    sort keeps the lower expert first among equal probabilities."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :top_k], idx[..., :top_k]
    return probs, gate / torch.sum(gate, dim=-1, keepdim=True), idx


def moe(params, x: torch.Tensor, *, num_experts: int, top_k: int,
        activation: str, capacity_factor: float = 1.25,
        group_size: int = 2048,
        num_shared_experts: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D) in x's dtype, aux load-balance loss
    (0-dim float32))."""
    b, s, d = x.shape
    t = b * s
    e = num_experts
    group = min(group_size, t)
    pad = (-t) % group
    xf = x.reshape(t, d)
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, d)])
    n_groups = xf.shape[0] // group
    cap = capacity(group, top_k, e, capacity_factor)

    logits = (xf @ params["router"]).float().reshape(n_groups, group, e)
    probs, gate, idx = route(logits, top_k)
    onehot = torch.nn.functional.one_hot(idx, e)                 # (G, g, k, E)
    # Slot of each (token, k) in its expert's buffer: the running count of
    # earlier pairs (token-major) routed to the same expert.  The count runs
    # along the last dimension of an (G, E, g * k) copy: a scan along an
    # outer dimension took 1.9 ms a layer at qwen2-moe's prefill on an H100.
    flat = onehot.to(torch.int32).reshape(n_groups, group * top_k, e)
    pos = torch.cumsum(flat.transpose(1, 2).contiguous(), dim=-1) - 1   # (G, E, g * k)
    pos = torch.gather(pos, 1, idx.reshape(n_groups, 1, group * top_k))
    pos = pos.reshape(n_groups, group, top_k).long()
    keep = pos < cap
    gate = gate * keep

    # Kept pairs go to row (g * E + expert) * cap + pos of the buffer; the
    # dropped ones to one spare row past its end, which nothing reads.
    spare = n_groups * e * cap
    grp = torch.arange(n_groups, device=x.device)[:, None, None]
    slot = torch.where(keep, (grp * e + idx) * cap + pos, spare).reshape(-1)
    rows = xf.repeat_interleave(top_k, dim=0)                     # (T_pad * k, D)
    xe = xf.new_zeros(spare + 1, d).index_copy(0, slot, rows)[:spare]
    xe = xe.reshape(n_groups, e, cap, d).transpose(0, 1).reshape(e, n_groups * cap, d)
    ye = _expert_ffn(params, xe, activation)
    ye = ye.reshape(e, n_groups, cap, d).transpose(0, 1).reshape(spare, d)
    ye = torch.cat([ye, ye.new_zeros(1, d)])
    y = (ye[slot].float().reshape(-1, top_k, d)
         * gate.reshape(-1, top_k, 1)).sum(dim=1)
    y = y[:t].to(x.dtype).reshape(b, s, d)

    frac = onehot[:, :, 0, :].float().mean(dim=1)                # (G, E)
    pmean = probs.mean(dim=1)
    aux = torch.mean(e * torch.sum(frac * pmean, dim=-1))
    if num_shared_experts:
        y = y + mlp_lib.mlp(params["shared"], x, activation=activation)
    return y, aux
