"""whisper-tiny [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356].

4L(enc)+4L(dec) d_model=384, 6H (kv=6), d_ff=1536, vocab=51865, LayerNorm,
GELU, learned positions (no RoPE), encoder over 1500 stubbed mel-frame
embeddings (the mel+conv frontend is stubbed per the brief).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope_theta=None,
    encoder_layers=4,
    encoder_seq=1500,
    frontend="audio",
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
