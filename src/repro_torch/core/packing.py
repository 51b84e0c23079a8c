"""Flat-packed message layout: one (W, D) buffer for the whole federation
(port of ``repro/core/packing.py``, DESIGN.md Sec. 8).

A model's parameters are a flat ``{name: tensor}`` dict.  Its leaves are
laid out in sorted-name order -- the order ``jax.tree_util`` flattens a
dict in -- so a packed buffer here and in the reference hold the same
coordinates in the same places.

* :class:`PackSpec` -- built once per model from one message's leaf
  shapes/dtypes: flat sizes, offsets, the raveled dimension ``D`` and an
  optional pad to a multiple (``pad_to``).
* :meth:`PackSpec.pack` -- dict with any number of leading batch axes ->
  one ``(*batch, padded_dim)`` float32 buffer.
* :meth:`PackSpec.unpack` -- the inverse (padding dropped, leaf dtypes
  restored).

Only the ``float32`` wire is ported; the quantized and bfloat16 wires wait
for ROADMAP.md Queue A item 7d.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One on-wire message format (a :data:`WIRE_FORMATS` entry)."""

    name: str
    cast_dtype: Any
    bits_per_coord: int


WIRE_FORMATS: dict[str, WireFormat] = {
    "float32": WireFormat("float32", torch.float32, 32),
}

WIRE_FORMAT_NAMES = tuple(WIRE_FORMATS)

# The reference's formats that the port does not carry yet.
_UNPORTED_WIRES = ("bfloat16", "int8", "sign1")


def resolve_wire_format(name: str | WireFormat) -> WireFormat:
    """Map a ``RobustConfig.message_dtype`` name to its :class:`WireFormat`."""
    if isinstance(name, WireFormat):
        return name
    try:
        return WIRE_FORMATS[name]
    except KeyError:
        hint = (" (ported with the quantized wires, ROADMAP.md Queue A item 7d)"
                if name in _UNPORTED_WIRES else "")
        raise ValueError(
            f"message_dtype must be one of {sorted(WIRE_FORMATS)}, got "
            f"{name!r}{hint}") from None


def assemble(parts: Sequence[torch.Tensor], *, pad: int = 0,
             batch_shape: tuple[int, ...] = (), dtype=torch.float32,
             device: torch.device | str | None = None) -> torch.Tensor:
    """Concatenate pre-raveled per-leaf pieces (each ``(*batch, n_i)``)
    into one ``(*batch, sum(n_i) + pad)`` buffer, zero-filling the pad."""
    parts = list(parts)
    if parts:
        device = parts[0].device
    if pad:
        parts.append(torch.zeros(batch_shape + (pad,), dtype=dtype,
                                 device=device))
    if not parts:
        return torch.zeros(batch_shape + (0,), dtype=dtype, device=device)
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static layout of a packed message buffer.

    ``names``/``shapes``/``dtypes`` describe ONE message: leaf ``i``
    occupies coordinates ``offsets[i]:offsets[i] + sizes[i]``.  ``dim`` is
    the raveled dimension; ``padded_dim`` rounds it up to ``pad_to``.
    """

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    sizes: tuple[int, ...]
    offsets: tuple[int, ...]
    dim: int
    padded_dim: int
    message_dtype: torch.dtype = torch.float32
    wire: str = "float32"

    @property
    def num_leaves(self) -> int:
        return len(self.shapes)

    @property
    def boundaries(self) -> tuple[tuple[int, int], ...]:
        """Static (start, stop) coordinate range of every leaf."""
        return tuple((o, o + s) for o, s in zip(self.offsets, self.sizes))

    @property
    def pad(self) -> int:
        return self.padded_dim - self.dim

    def pack(self, tree: Params, *, batch_ndim: int = 1) -> torch.Tensor:
        """Ravel ``tree`` into one ``(*batch, padded_dim)`` buffer.  Every
        leaf carries ``batch_ndim`` leading batch axes, then its spec
        shape."""
        if sorted(tree) != list(self.names):
            raise ValueError(f"tree keys {sorted(tree)} do not match spec "
                             f"names {list(self.names)}")
        leaves = [tree[k] for k in self.names]
        if not leaves:
            return torch.zeros((self.padded_dim,), dtype=self.message_dtype)
        batch = tuple(leaves[0].shape[:batch_ndim])
        parts = []
        for leaf, shape in zip(leaves, self.shapes):
            if tuple(leaf.shape[batch_ndim:]) != shape:
                raise ValueError(
                    f"leaf shape {tuple(leaf.shape)} does not match spec "
                    f"message shape {shape} under batch_ndim={batch_ndim}")
            parts.append(leaf.reshape(batch + (-1,)).to(self.message_dtype))
        return assemble(parts, pad=self.pad, batch_shape=batch,
                        dtype=self.message_dtype)

    def unpack(self, buf: torch.Tensor, *, batch_ndim: int | None = None
               ) -> Params:
        """Inverse of :meth:`pack`: restore leaf shapes AND dtypes.
        ``batch_ndim`` defaults to ``buf.dim() - 1``."""
        if batch_ndim is None:
            batch_ndim = buf.dim() - 1
        batch = tuple(buf.shape[:batch_ndim])
        if buf.shape[batch_ndim] != self.padded_dim:
            raise ValueError(
                f"buffer coordinate axis {buf.shape[batch_ndim]} != "
                f"spec padded_dim {self.padded_dim}")
        return {name: buf.narrow(batch_ndim, a, b - a).reshape(
                    batch + shape).to(dtype)
                for name, (a, b), shape, dtype in zip(
                    self.names, self.boundaries, self.shapes, self.dtypes)}


def pack_spec(tree: Params, *, batch_ndim: int = 1, pad_to: int = 1,
              wire: str | WireFormat = "float32") -> PackSpec:
    """Build the :class:`PackSpec` of ``tree``; its first ``batch_ndim``
    axes are batch (worker/table axes), the rest the message shape."""
    fmt = resolve_wire_format(wire)
    names = tuple(sorted(tree))
    shapes = tuple(tuple(tree[k].shape[batch_ndim:]) for k in names)
    dtypes = tuple(tree[k].dtype for k in names)
    sizes = tuple(int(math.prod(s)) for s in shapes)
    offsets = tuple(sum(sizes[:i]) for i in range(len(sizes)))
    dim = int(sum(sizes))
    padded = dim + ((-dim) % max(pad_to, 1))
    return PackSpec(names=names, shapes=shapes, dtypes=dtypes, sizes=sizes,
                    offsets=offsets, dim=dim, padded_dim=padded,
                    message_dtype=fmt.cast_dtype, wire=fmt.name)
