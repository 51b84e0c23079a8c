"""Sharding specs of the parameters, batches and caches, and the cut of a
rank's model shard (port of ``repro/launch/sharding.py``).

A spec is a plain tuple with one entry a dimension: None (replicated), a
mesh axis name, or a tuple of names (sharded over their combined size,
row-major), as the reference's ``PartitionSpec`` entries; a missing
trailing entry is None.  :func:`fsdp_param_specs`, :func:`batch_specs`,
:func:`cache_batch_axis` and :func:`cache_specs_for` give the reference's
specs.  They take a :class:`repro_torch.launch.mesh.Mesh`, or a dict of
axis sizes in mesh order, since a spec depends on the sizes only.

The reference's ``named`` and ``replicated`` build ``NamedSharding`` s for
XLA to place arrays by; torch has no such placement, so they have no
counterpart.  A rank holds its shard itself: :func:`model_shard` cuts it
from a whole leaf and :func:`gather_model_shard` all-gathers it back, over
the model axes' handle (:meth:`repro_torch.launch.mesh.Mesh.axes`).  A
leaf that its spec does not shard over those axes (a norm's scale, or a
dimension the axes do not divide) is split flat into near-equal pieces
instead, one a rank, so that every coordinate of a message lies on
exactly one model rank: the aggregation sums its rows' distance partials
over the model axes, and a leaf held whole by every model rank would be
counted once a rank (the reference's sharded path counts such a leaf
once per model device; its gather path and the single-process rule once).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

from repro_torch import collectives as coll
from repro_torch.configs.base import BlockSpec, ModelConfig, ShapeConfig
from repro_torch.launch import mesh as mesh_lib

MeshLike = Union["mesh_lib.Mesh", dict]


def _sizes(mesh: MeshLike) -> dict[str, int]:
    return dict(mesh) if isinstance(mesh, dict) else mesh_lib.axis_sizes(mesh)


def _worker_axes(mesh: MeshLike) -> tuple[str, ...]:
    return tuple(a for a in _sizes(mesh) if a in mesh_lib.WORKER_AXIS_NAMES)


def _worker_spec(mesh: MeshLike):
    wa = _worker_axes(mesh)
    return wa if len(wa) > 1 else wa[0]


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def fsdp_param_specs(spec_tree: dict[str, tuple], mesh: MeshLike,
                     shapes: dict) -> dict[str, tuple]:
    """Upgrade each "model"-sharded dimension to the worker axes plus
    "model" where the dimension divides their combined size (the
    reference's FSDP-style serving sharding).  ``shapes``: each leaf's
    shape, or a tensor of it (:func:`~repro_torch.models.transformer.param_structs`).
    For serving only: robust training needs every worker's whole gradient,
    so the parameters stay replicated over the worker axes there."""
    szs = _sizes(mesh)
    combo = _worker_axes(mesh) + ("model",)
    total = math.prod(szs.get(a, 1) for a in combo)

    def fix(spec, shape):
        shape = tuple(getattr(shape, "shape", shape))
        dims = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(combo if names == "model" and dim % total == 0 else names
                     for names, dim in zip(dims, shape))

    return {k: fix(s, shapes[k]) for k, s in spec_tree.items()}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh: MeshLike) -> dict[str, tuple]:
    """Specs of the batch leaves of a step of ``shape.kind``: a train batch
    (W, per-worker batch, ...) sharded over the worker axes on its worker
    axis; a prefill batch on its batch axis; a decode batch on its batch
    axis when larger than 1."""
    waxes = _worker_spec(mesh)
    if shape.kind == "train":
        specs = {"tokens": (waxes, None, None), "labels": (waxes, None, None)}
        if cfg.family == "vlm":
            specs["image_emb"] = (waxes, None, None, None)
        if cfg.family == "audio":
            specs["audio_emb"] = (waxes, None, None, None)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": (waxes, None)}
        if cfg.family == "vlm":
            specs["image_emb"] = (waxes, None, None)
        if cfg.family == "audio":
            specs["audio_emb"] = (waxes, None, None)
        return specs
    if shape.kind == "decode":
        bspec = waxes if shape.global_batch > 1 else None
        return {"tokens": (bspec, None), "pos": ()}
    raise ValueError(shape.kind)


def cache_batch_axis(shape: ShapeConfig, mesh: MeshLike) -> tuple:
    """(batch sharding, sequence sharding) of the KV caches: the batch over
    the worker axes when it is larger than 1, else the sequence over
    "data" (the sequence-parallel cache of a single long prompt)."""
    if shape.global_batch > 1:
        return (_worker_spec(mesh), None)
    return (None, "data")


def cache_specs_for(cfg: ModelConfig, shape: ShapeConfig,
                    mesh: MeshLike) -> dict:
    """Specs of the decode cache, ``{"pos{i}": {leaf: spec}}``: each leaf
    stacked over the periods (a leading None), then (B, S, KV, hd) for
    attention (the KV heads over "model" where they divide it, else the
    head dimension) and the Mamba state for SSM blocks."""
    if cfg.family == "audio":
        # The encoder-decoder's pattern carries cross-attention caches.
        cfg = dataclasses.replace(cfg, pattern=(BlockSpec(kind="attn",
                                                          cross=True),))
    pat, _ = cfg.resolve_pattern()
    b_ax, s_ax = cache_batch_axis(shape, mesh)
    szs = _sizes(mesh)

    def div(dim, ax):
        if ax is None:
            return None
        total = math.prod(szs.get(a, 1) for a in _names(ax))
        return ax if dim % total == 0 else None

    hd = cfg.resolved_head_dim
    cache = {}
    for i, spec in enumerate(pat):
        c = {}
        if spec.kind == "attn":
            kv_ax = div(cfg.num_kv_heads, "model")
            kvspec = (b_ax, s_ax, kv_ax, None if kv_ax else div(hd, "model"))
            c["k"] = kvspec
            c["v"] = kvspec
        else:
            c["h"] = (b_ax, div(cfg.ssm_heads, "model"), None, None)
            c["conv_x"] = (b_ax, None, div(cfg.d_inner, "model"))
            c["conv_B"] = (b_ax, None, None)
            c["conv_C"] = (b_ax, None, None)
        if spec.cross:
            cs = (b_ax, None, div(cfg.num_kv_heads, "model"), None)
            c["cross_k"] = cs
            c["cross_v"] = cs
        cache[f"pos{i}"] = {k: (None,) + tuple(v) for k, v in c.items()}
    return cache


# ---------------------------------------------------------------------------
# A rank's model shard of a leaf
# ---------------------------------------------------------------------------

def sharded_dim(spec: tuple, axes) -> int | None:
    """The dimension ``spec`` shards over exactly the axes of the handle
    ``axes``, or None (replicated over them, or no axes)."""
    if not axes:
        return None
    for d, entry in enumerate(spec):
        if _names(entry) == tuple(axes.names):
            return d
    return None


def _flat_bounds(n: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of piece ``index`` of ``n`` coordinates split into
    ``parts`` near-equal pieces, the first ``n % parts`` one longer."""
    q, r = divmod(n, parts)
    start = index * q + min(index, r)
    return start, start + q + (1 if index < r else 0)


def model_shard(x: torch.Tensor, spec: tuple, axes) -> torch.Tensor:
    """This rank's shard of the whole leaf ``x`` over the handle ``axes``:
    block ``axes.index`` of the dimension ``spec`` shards over them, or,
    for a leaf replicated over them, piece ``axes.index`` of its
    coordinates split flat (1-D).  No axes (or one rank): ``x`` itself."""
    if not axes or axes.size == 1:
        return x
    d = sharded_dim(spec, axes)
    if d is not None:
        return torch.chunk(x, axes.size, dim=d)[axes.index]
    a, b = _flat_bounds(x.numel(), axes.size, axes.index)
    return x.reshape(-1)[a:b]


def gather_model_shard(local: torch.Tensor, spec: tuple, axes,
                       shape) -> torch.Tensor:
    """The whole leaf of ``shape`` from every rank's :func:`model_shard`
    over ``axes`` (an all-gather; every rank gets the leaf)."""
    if not axes or axes.size == 1:
        return local
    d = sharded_dim(spec, axes)
    if d is not None:
        return torch.cat(list(coll.all_gather(local, axes)), dim=d)
    n = math.prod(shape)
    width = -(-n // axes.size)
    pieces = coll.all_gather(
        torch.nn.functional.pad(local, (0, width - local.numel())), axes)
    parts = [pieces[i, :_flat_bounds(n, axes.size, i)[1]
                    - _flat_bounds(n, axes.size, i)[0]]
             for i in range(axes.size)]
    return torch.cat(parts).reshape(tuple(shape))
