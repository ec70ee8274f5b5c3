"""Architecture registry: one module per assigned architecture.

Counterpart of ``repro/configs/``: the same ten shape-only configurations.

``get_config(arch_id)`` returns the full published config;
``get_smoke_config(arch_id)`` returns the reduced same-family config used by
CPU smoke tests (small width/layers/vocab, same layer pattern & features).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "granite_moe_1b_a400m",
    "grok_1_314b",
    "recurrentgemma_2b",
    "internvl2_1b",
    "rwkv6_7b",
    "gemma2_2b",
    "granite_20b",
    "llama3_8b",
    "qwen1_5_4b",
    "whisper_small",
)

# canonical external ids (with dashes/dots) -> module names
ALIASES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "grok-1-314b": "grok_1_314b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-1b": "internvl2_1b",
    "rwkv6-7b": "rwkv6_7b",
    "gemma2-2b": "gemma2_2b",
    "granite-20b": "granite_20b",
    "llama3-8b": "llama3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "whisper-small": "whisper_small",
}


def _module(arch_id: str):
    name = ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def all_arch_ids():
    return list(ARCH_IDS)
