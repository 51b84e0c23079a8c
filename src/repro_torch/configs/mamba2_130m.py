"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768, attention-free, d_ff=0, vocab=50280, ssm_state=128.
d_inner = 2*768 = 1536, head_dim 64 -> 24 SSM heads.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,          # unused (attention-free); kept for API uniformity
    num_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    pattern=(BlockSpec(kind="mamba"),),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
