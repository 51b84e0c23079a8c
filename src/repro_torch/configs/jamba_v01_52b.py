"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

32L d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=65536, MoE 16e top-2.
Period of 8 layers: attention at index 4, the rest Mamba; MoE replaces the
dense FFN on every other layer (odd indices).  Jamba attention uses no
positional embeddings (rope_theta=None).  SSM state 16 (Jamba uses Mamba-1
sized states); d_inner=8192, head_dim 64 -> 128 SSM heads.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

_M = lambda moe: BlockSpec(kind="mamba", moe=moe)
_A = lambda moe: BlockSpec(kind="attn", moe=moe)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    rope_theta=None,
    num_experts=16,
    top_k=2,
    moe_d_ff=14336,
    pattern=(_M(False), _M(True), _M(False), _M(True),
             _A(False), _M(True), _M(False), _M(True)),
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=False,
    source="arXiv:2403.19887",
)
