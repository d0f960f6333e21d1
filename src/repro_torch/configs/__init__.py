"""Architecture registry: get_config("<arch-id>"[, smoke=True]).

The dense family is ported: ``smollm-360m``, ``qwen3-4b`` (qk-norm),
``qwen2.5-14b`` (qkv bias) and ``stablelm-1.6b`` (LayerNorm, qkv bias,
partial rotary); and the MoE family: ``mixtral-8x7b`` (top-2 of 8,
sliding window) and ``llama4-scout-17b-a16e`` (top-1 of 16 and a shared
expert); and the two modality-stub families: ``qwen2-vl-2b`` (M-RoPE and
a vision stub of precomputed patch embeddings) and ``musicgen-medium``
(gelu MLP, sinusoidal positions, 4 EnCodec codebooks); and the two
recurrent families: ``rwkv6-1.6b`` (RWKV6 blocks, a recurrent state cache)
and the hybrid ``zamba2-2.7b`` (Mamba2 blocks with a shared attention
block every 9th layer: a recurrent state and a K/V cache).
"""
from importlib import import_module

from .base import (  # noqa: F401
    MULTI_POD,
    SHAPES,
    SINGLE_POD,
    MeshConfig,
    ModelConfig,
    ShapeConfig,
    shapes_for,
)

_MODULES = {
    "smollm-360m": "smollm_360m",
    "qwen3-4b": "qwen3_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen2.5-14b": "qwen2_5_14b",
    "mixtral-8x7b": "mixtral_8x7b",
    "llama4-scout-17b-a16e": "llama4_scout",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "musicgen-medium": "musicgen_medium",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported so far: {list(_MODULES)}")
    mod = import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.FULL
