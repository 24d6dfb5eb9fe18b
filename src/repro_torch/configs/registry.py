"""Architecture registry: --arch <id> -> (ModelConfig, parallelism prefs)
(a copy of repro.configs.registry; the arch modules load from
repro_torch.configs).

Every architecture with its exact geometry, sources and geometry notes in
each arch module's docstring.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    # parallelism preferences for the production mesh
    fsdp: bool = False             # shard "embed" over data (ZeRO-style)
    fsdp_over_pod: bool = False    # extend FSDP across the pod axis
    shard_experts: bool = True     # EP when experts divide the model axis
    sp: bool = True                # sequence-parallel residual activations
    microbatches: int = 1          # gradient-accumulation microbatches


_ARCH_MODULES = [
    "recurrentgemma_2b", "starcoder2_15b", "llama3_8b", "gemma2_27b",
    "minitron_4b", "phi35_moe", "grok1_314b", "pixtral_12b",
    "xlstm_350m", "whisper_medium",
]

_ALIASES = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "starcoder2-15b": "starcoder2_15b",
    "llama3-8b": "llama3_8b",
    "gemma2-27b": "gemma2_27b",
    "minitron-4b": "minitron_4b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "phi3.5-moe": "phi35_moe",
    "grok-1-314b": "grok1_314b",
    "pixtral-12b": "pixtral_12b",
    "xlstm-350m": "xlstm_350m",
    "whisper-medium": "whisper_medium",
}


def _load() -> Dict[str, ArchSpec]:
    out = {}
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        out[mod.ARCH.config.name] = mod.ARCH
    return out


_REGISTRY: Optional[Dict[str, ArchSpec]] = None


def registry() -> Dict[str, ArchSpec]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    return _REGISTRY


def get_arch(name: str) -> ArchSpec:
    reg = registry()
    if name in reg:
        return reg[name]
    key = _ALIASES.get(name)
    if key:
        for spec in reg.values():
            if spec.config.name in (name,) or key in spec.config.name.replace(
                    "-", "_").replace(".", ""):
                return spec
        mod = importlib.import_module(f"repro_torch.configs.{key}")
        return mod.ARCH
    raise KeyError(f"unknown arch {name!r}; known: {sorted(reg)}")


def arch_names():
    return sorted(registry().keys())
