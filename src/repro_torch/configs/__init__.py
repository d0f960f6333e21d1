"""Architecture registry: get_config("<arch-id>"[, smoke=True]).

Only ``smollm-360m`` is ported so far; the reference's other nine
architectures need blocks (MoE, SSM, M-RoPE, ...) that wait.
"""
from importlib import import_module

from .base import ModelConfig  # noqa: F401

_MODULES = {
    "smollm-360m": "smollm_360m",
}

ARCHS = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported so far: {list(_MODULES)}")
    mod = import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.FULL
