"""Architecture registry: ``--arch <id>`` resolution + shape sets.

Usage::

    from repro_torch.configs import get_config, get_smoke_config, ARCHS
    cfg = get_config("qwen3-32b")
"""
from __future__ import annotations

import importlib

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                   SHAPES_BY_NAME, TRAIN_4K, ModelConfig, RunConfig,
                   ShapeConfig)

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "minitron-4b": "minitron_4b",
    "qwen3-14b": "qwen3_14b",
    "granite-34b": "granite_34b",
    "whisper-large-v3": "whisper_large_v3",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "grok-1-314b": "grok_1_314b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2p7b",
}

ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


def shapes_for(arch: str) -> list[ShapeConfig]:
    """The assigned shape cells for an arch, applying the skip rules:

    * long_500k only for sub-quadratic archs (SSM/hybrid) — full-attention
      archs skip it (see DESIGN.md §5).
    """
    cfg = get_config(arch)
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.sub_quadratic:
        out.append(LONG_500K)
    return out


def skipped_shapes_for(arch: str) -> list[tuple[str, str]]:
    """(shape, reason) cells excluded for this arch."""
    cfg = get_config(arch)
    if not cfg.sub_quadratic:
        return [("long_500k", "skip(full-attn): 500k-token KV with full "
                              "attention is the quadratic regime this shape "
                              "excludes")]
    return []


__all__ = [
    "ARCHS", "get_config", "get_smoke_config", "shapes_for",
    "skipped_shapes_for", "ModelConfig", "RunConfig", "ShapeConfig",
    "ALL_SHAPES", "SHAPES_BY_NAME", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K",
]
