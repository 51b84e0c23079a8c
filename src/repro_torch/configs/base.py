"""Config dataclasses: model architecture, input shapes, training (port of
``repro/configs/base.py``).

Every assigned architecture is expressed as a :class:`ModelConfig`; the
four benchmark input shapes are :data:`SHAPES` in ``shapes.py``.  The
fields, defaults and :meth:`ModelConfig.reduced` are the reference's;
:attr:`ModelConfig.dtype` returns a :class:`torch.dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One sublayer descriptor within a repeating layer period."""

    kind: str = "attn"       # attn | mamba
    moe: bool = False        # MoE FFN instead of dense FFN
    cross: bool = False      # add cross-attention (enc-dec decoder blocks)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0        # 0 -> d_model // num_heads
    activation: str = "swiglu"
    qkv_bias: bool = False
    rope_theta: Optional[float] = 1e4  # None -> no RoPE (whisper/jamba)
    sliding_window: Optional[int] = None
    norm: str = "rmsnorm"    # rmsnorm | layernorm
    tie_embeddings: bool = True
    scale_embeddings: bool = False   # gemma-style sqrt(D) embedding scale
    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # --- layer pattern (one period; empty -> uniform) ---
    pattern: Tuple[BlockSpec, ...] = ()
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0
    # --- VLM ---
    num_prefix_tokens: int = 0
    frontend: Optional[str] = None   # audio | vision (stubbed per brief)
    # --- numerics / long context ---
    param_dtype: str = "bfloat16"
    long_context_window: int = 8192  # SWA window used for long_500k on full-attn archs
    source: str = ""                 # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dtype(self) -> torch.dtype:
        dt = getattr(torch, self.param_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.name}: unknown param_dtype {self.param_dtype!r}")
        return dt

    def resolve_pattern(self) -> Tuple[Tuple[BlockSpec, ...], int]:
        """Return (pattern, num_periods)."""
        pat = self.pattern or (BlockSpec(kind="attn", moe=self.num_experts > 0),)
        if self.num_layers % len(pat):
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern length {len(pat)}")
        return pat, self.num_layers // len(pat)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 periods, d_model<=256, <=4 experts."""
        pat, _ = self.resolve_pattern()
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        hd = 64
        changes = dict(
            num_layers=len(pat) * min(2, self.num_layers // len(pat) or 1),
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            num_prefix_tokens=min(self.num_prefix_tokens, 16),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            param_dtype="float32",
        )
        if self.num_experts:
            changes.update(
                num_experts=min(self.num_experts, 4),
                num_shared_experts=min(self.num_shared_experts, 1),
                top_k=min(self.top_k, 2),
                moe_d_ff=min(self.moe_d_ff, 256),
            )
        if self.ssm_state:
            changes.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
                           ssm_chunk=16)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"   # paper-faithful update is plain SGD (eq. 11)
    lr: float = 1e-3
    remat: bool = True
    loss_chunk: int = 512
