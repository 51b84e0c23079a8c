"""Architecture/config registry: ``get_config(name)`` / ``ARCH_NAMES`` (port
of ``repro/configs/__init__.py``; data only, the same names and values)."""
from repro_torch.configs.base import BlockSpec, ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs.shapes import SHAPES

from repro_torch.configs import (
    byrd_logreg,
    command_r_plus_104b,
    jamba_v01_52b,
    mamba2_130m,
    mistral_large_123b,
    mixtral_8x22b,
    nemotron4_340b,
    paligemma_3b,
    qwen2_7b,
    qwen2_moe_a2p7b,
    whisper_tiny,
)

_REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        mamba2_130m, qwen2_moe_a2p7b, qwen2_7b, nemotron4_340b, whisper_tiny,
        mixtral_8x22b, jamba_v01_52b, mistral_large_123b, command_r_plus_104b,
        paligemma_3b,
    )
}

ARCH_NAMES = tuple(_REGISTRY)
LOGREG_CONFIG = byrd_logreg.CONFIG


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
