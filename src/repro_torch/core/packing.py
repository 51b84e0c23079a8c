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

Wire formats (DESIGN.md Sec. 12), the :data:`WIRE_FORMATS` registry:
``float32``; ``bfloat16`` (the buffer itself is bf16: a pack-time cast that
halves the volume); ``int8`` (per-leaf-block symmetric ``amax / 127``
scales, :meth:`PackSpec.encode` / :meth:`PackSpec.decode`); ``sign1`` (one
bit a coordinate, a ``mean |v|`` scale per leaf block, and a per-client
error-feedback residual, :meth:`PackSpec.transmit`).  The quantized
formats keep the buffer in float32 and quantize at the wire;
:meth:`PackSpec.wire_roundtrip` is what the receiver sees.
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
    # Quantized formats keep the buffer in cast_dtype (float32) and cross
    # the wire as codes plus one float32 scale per leaf block.
    quantized: bool = False
    # Senders carry an O(D) residual of the quantization error (sign1).
    error_feedback: bool = False


WIRE_FORMATS: dict[str, WireFormat] = {
    "float32": WireFormat("float32", torch.float32, 32),
    "bfloat16": WireFormat("bfloat16", torch.bfloat16, 16),
    "int8": WireFormat("int8", torch.float32, 8, quantized=True),
    "sign1": WireFormat("sign1", torch.float32, 1, quantized=True,
                        error_feedback=True),
}

WIRE_FORMAT_NAMES = tuple(WIRE_FORMATS)


def resolve_wire_format(name: str | WireFormat | torch.dtype) -> WireFormat:
    """Map a ``RobustConfig.message_dtype`` value to its :class:`WireFormat`:
    a registry name, or a raw torch dtype (a plain cast format)."""
    if isinstance(name, WireFormat):
        return name
    if isinstance(name, torch.dtype):
        key = str(name).removeprefix("torch.")
        return WIRE_FORMATS.get(key, WireFormat(key, name, name.itemsize * 8))
    try:
        return WIRE_FORMATS[name]
    except KeyError:
        raise ValueError(
            f"message_dtype must be one of {sorted(WIRE_FORMATS)}, got "
            f"{name!r}") from None


def resolve_message_dtype(name: str | torch.dtype) -> torch.dtype:
    """The buffer dtype of a ``RobustConfig.message_dtype`` value: the
    format's ``cast_dtype`` (float32 for the quantized formats)."""
    return resolve_wire_format(name).cast_dtype


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
    def wire_format(self) -> WireFormat:
        fmt = WIRE_FORMATS.get(self.wire)
        return fmt if fmt is not None else resolve_wire_format(
            self.message_dtype)

    @property
    def quantized(self) -> bool:
        return self.wire_format.quantized

    @property
    def boundaries(self) -> tuple[tuple[int, int], ...]:
        """Static (start, stop) coordinate range of every leaf."""
        return tuple((o, o + s) for o, s in zip(self.offsets, self.sizes))

    @property
    def pad(self) -> int:
        return self.padded_dim - self.dim

    def pack(self, tree: Params, *, batch_ndim: int = 1,
             dtype: torch.dtype | None = None) -> torch.Tensor:
        """Ravel ``tree`` into one ``(*batch, padded_dim)`` buffer of
        ``dtype`` (default ``message_dtype``).  Every leaf carries
        ``batch_ndim`` leading batch axes, then its spec shape."""
        if sorted(tree) != list(self.names):
            raise ValueError(f"tree keys {sorted(tree)} do not match spec "
                             f"names {list(self.names)}")
        dtype = dtype or self.message_dtype
        leaves = [tree[k] for k in self.names]
        if not leaves:
            return torch.zeros((self.padded_dim,), dtype=dtype)
        batch = tuple(leaves[0].shape[:batch_ndim])
        parts = []
        for leaf, shape in zip(leaves, self.shapes):
            if tuple(leaf.shape[batch_ndim:]) != shape:
                raise ValueError(
                    f"leaf shape {tuple(leaf.shape)} does not match spec "
                    f"message shape {shape} under batch_ndim={batch_ndim}")
            parts.append(leaf.reshape(batch + (-1,)).to(dtype))
        return assemble(parts, pad=self.pad, batch_shape=batch, dtype=dtype)

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

    def encode(self, buf: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Quantize a ``(*batch, padded_dim)`` buffer -> (codes int8 of the
        same shape, scales float32 ``(*batch, num_leaves)``), one scale per
        leaf block.  ``int8``: scale ``amax / 127``, codes
        ``round(v / scale)`` (half to even) clipped to +-127 (an all-zero
        block has scale 0 and codes 0; a NaN code is 0, as XLA converts
        it).  ``sign1``: scale ``mean |v|``, codes +1 where ``v >= 0``,
        else -1 (NaN included).  Padding encodes to 0."""
        fmt = self.wire_format
        if not fmt.quantized:
            raise ValueError(f"wire format {fmt.name!r} is not quantized")
        v32 = buf.float()
        batch = tuple(buf.shape[:-1])

        def div(x, n: float):
            # A 0-dim device divisor: PyTorch's CUDA division by a host
            # scalar is a reciprocal multiply, an ulp off the reference's.
            return x / torch.tensor(n, device=x.device)

        code_parts, scales = [], []
        for a, b in self.boundaries:
            v = v32[..., a:b]
            if fmt.name == "int8":
                amax = torch.amax(torch.abs(v), dim=-1)
                scale = div(amax, 127.0)
                safe = torch.where(amax > 0.0, scale, 1.0)
                q = torch.clamp(torch.round(v / safe[..., None]), -127.0, 127.0)
                codes = torch.nan_to_num(q, nan=0.0).to(torch.int8)
            else:   # sign1: codes are exactly +-1, never 0
                scale = div(torch.sum(torch.abs(v), dim=-1), float(max(b - a, 1)))
                codes = torch.where(v >= 0.0, 1, -1).to(torch.int8)
            code_parts.append(codes)
            scales.append(scale)
        codes = assemble(code_parts, pad=self.pad, batch_shape=batch,
                         dtype=torch.int8, device=buf.device)
        if scales:
            return codes, torch.stack(scales, dim=-1)
        return codes, torch.zeros(batch + (0,), dtype=torch.float32,
                                  device=buf.device)

    def decode(self, codes: torch.Tensor, scales: torch.Tensor
               ) -> torch.Tensor:
        """Inverse of :meth:`encode`: the float32 ``(*batch, padded_dim)``
        buffer ``codes * scale`` of each block, padding 0."""
        parts = [codes[..., a:b].float() * scales[..., i:i + 1]
                 for i, (a, b) in enumerate(self.boundaries)]
        return assemble(parts, pad=self.pad, batch_shape=tuple(codes.shape[:-1]),
                        dtype=torch.float32, device=codes.device)

    def wire_roundtrip(self, buf: torch.Tensor) -> torch.Tensor:
        """What the receiver sees: ``decode(encode(buf))`` for a quantized
        format; ``buf`` itself (the same object, no copy) otherwise."""
        if not self.quantized:
            return buf
        return self.decode(*self.encode(buf))

    def transmit(self, buf: torch.Tensor,
                 residual: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The sender's wire step -> ``(wire, new residual)``.  Formats that
        are not quantized pass both through.  An error-feedback format
        (sign1) needs ``residual`` (float32, ``buf``'s shape): it sends
        ``t = buf + residual`` and keeps ``t - wire`` as the new residual,
        so the quantization error is sent later rather than lost."""
        fmt = self.wire_format
        if not fmt.quantized:
            return buf, residual
        if fmt.error_feedback:
            if residual is None:
                raise ValueError(
                    f"wire format {fmt.name!r} carries error feedback; "
                    "pass the per-client residual state")
            t = buf.float() + residual
            wire = self.wire_roundtrip(t)
            return wire, t - wire
        return self.wire_roundtrip(buf), residual

    def wire_bytes(self) -> int:
        """Bytes one message takes on the wire: codes, plus one float32
        scale per leaf block for a quantized format."""
        fmt = self.wire_format
        n = (fmt.bits_per_coord * self.padded_dim + 7) // 8
        if fmt.quantized:
            n += 4 * self.num_leaves
        return n


def dequantize_slice(codes: torch.Tensor, scales: torch.Tensor,
                     seg_ids: torch.Tensor) -> torch.Tensor:
    """Dequantize any coordinate slice of a packed buffer, per coordinate:
    ``codes`` (*batch, n) int8, ``scales`` (*batch, num_leaves) float32,
    ``seg_ids`` (n,) int leaf id of each coordinate (``num_leaves`` for
    padding, which decodes to 0) -> (*batch, n) float32."""
    zero = torch.zeros(tuple(scales.shape[:-1]) + (1,), dtype=scales.dtype,
                       device=scales.device)
    padded = torch.cat([scales, zero], dim=-1)
    return codes.float() * torch.index_select(padded, -1, seg_ids.long())


def pack_spec(tree: Params, *, batch_ndim: int = 1, pad_to: int = 1,
              wire: str | WireFormat | torch.dtype = "float32") -> PackSpec:
    """Build the :class:`PackSpec` of ``tree``; its first ``batch_ndim``
    axes are batch (worker/table axes), the rest the message shape.  The
    buffer dtype is the ``wire`` format's ``cast_dtype``."""
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
