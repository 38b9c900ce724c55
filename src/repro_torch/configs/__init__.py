"""Assigned architecture configs (public-literature pool) + the paper's own.

Each module defines ``CONFIG``; ``get_config(arch_id)`` resolves by id.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "qwen2_vl_72b",
    "whisper_large_v3",
    "phi3_medium_14b",
    "grok_1_314b",
    "qwen1_5_110b",
    "deepseek_67b",
    "qwen2_1_5b",
    "deepseek_v2_236b",
    "mamba2_370m",
    "recurrentgemma_9b",
    # the paper's own evaluation models (Llama architecture, §7)
    "llama_32b",
    "llama_70b",
]


def canon(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(arch: str):
    name = canon(arch)
    if name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}
