"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attn [arXiv:2401.04088].

56L d_model=6144, 48H (GQA kv=8), expert d_ff=16384, vocab=32768.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32768,
    rope_theta=1e6,
    sliding_window=4096,
    num_experts=8,
    top_k=2,
    moe_d_ff=16384,
    pattern=(BlockSpec(kind="attn", moe=True),),
    tie_embeddings=False,
    source="arXiv:2401.04088",
)
