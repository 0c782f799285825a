"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke_config``.

One module per assigned architecture; each exposes CONFIG (exact published
geometry) and SMOKE (reduced same-family config for CPU tests).

The port's copy of ``repro.configs`` (pure data, kept identical)."""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen2_vl_7b", "hymba_1_5b", "command_r_plus_104b", "gemma3_4b",
    "granite_20b", "qwen2_7b", "whisper_small", "mamba2_2_7b",
    "qwen2_moe_a2_7b", "granite_moe_3b_a800m",
]

def canonical(arch: str) -> str:
    """Accepts 'qwen2-moe-a2.7b', 'mamba2_2_7b', etc."""
    norm = arch.replace("-", "_").replace(".", "_")
    return norm if norm in ARCHS else arch


def get_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.SMOKE


def all_configs():
    return {a: get_config(a) for a in ARCHS}
