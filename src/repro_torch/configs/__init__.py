"""Architecture registry: get_config("<arch-id>"[, smoke=True]).

The dense family is ported: ``smollm-360m``, ``qwen3-4b`` (qk-norm),
``qwen2.5-14b`` (qkv bias) and ``stablelm-1.6b`` (LayerNorm, qkv bias,
partial rotary). The reference's other six architectures need blocks
(MoE, SSM, M-RoPE, gelu, codebooks) that wait.
"""
from importlib import import_module

from .base import ModelConfig  # noqa: F401

_MODULES = {
    "smollm-360m": "smollm_360m",
    "qwen3-4b": "qwen3_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "qwen2.5-14b": "qwen2_5_14b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported so far: {list(_MODULES)}")
    mod = import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.FULL
