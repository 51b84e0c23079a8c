"""paligemma-3b [vlm] — SigLIP vision tower STUB + gemma decoder [arXiv:2407.07726].

18L d_model=2048, 8H (GQA kv=1 = MQA), d_ff=16384, vocab=257216, head_dim=256.
256 image-patch embeddings form a bidirectional prefix (prefix-LM masking);
the SigLIP encoder + projector are stubbed per the brief — input_specs()
supplies (B, 256, d_model) patch embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    activation="geglu",
    rope_theta=1e4,
    scale_embeddings=True,
    tie_embeddings=True,
    num_prefix_tokens=256,
    frontend="vision",
    source="arXiv:2407.07726",
)
