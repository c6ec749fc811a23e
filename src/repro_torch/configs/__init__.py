"""Architecture registry: the partner of ``repro/configs/__init__.py``.

Each module defines ``CONFIG`` (the published configuration, copied
from the reference) and ``reduced()`` (a tiny same-family variant for the
CPU tests), for all ten of the reference's architectures: the dense and
mixture-of-experts attention models, internvl2-2b (patch-embedding
inputs) and musicgen-medium (LayerNorm, GELU), falcon-mamba-7b (Mamba-1)
and the hybrid zamba2-1.2b (Mamba-2 layers and a shared attention block).
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

ARCHS = [
    "gemma2-9b",
    "stablelm-12b",
    "qwen3-32b",
    "yi-34b",
    "qwen2-moe-a2.7b",
    "mixtral-8x7b",
    "zamba2-1.2b",
    "internvl2-2b",
    "falcon-mamba-7b",
    "musicgen-medium",
]

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"{__name__}.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    """The published configuration of ``name``."""
    return _load(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    """The tiny same-family variant of ``name`` the CPU tests run."""
    return _load(name).reduced()


def all_configs() -> dict[str, ModelConfig]:
    """Every architecture's published configuration."""
    return {name: get(name) for name in ARCHS}


__all__ = ["ARCHS", "all_configs", "get", "get_reduced"]
