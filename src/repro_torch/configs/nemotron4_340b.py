"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819].

96L d_model=18432, 96H (GQA kv=8), d_ff=73728, vocab=256000, head_dim=192.
Untied embeddings (separate input/output embedding matrices).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    rope_theta=1e4,
    tie_embeddings=False,
    source="arXiv:2402.16819",
)
