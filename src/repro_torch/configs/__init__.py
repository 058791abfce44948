"""Assigned-architecture registry: ``get_config(name)`` /
``REGISTRY``. Every entry cites its source in the module docstring."""

from repro_torch.configs.base import reduced, with_sliding_window
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG as deepseek_v2_lite_16b
from repro_torch.configs.musicgen_medium import CONFIG as musicgen_medium
from repro_torch.configs.qwen2_5_3b import CONFIG as qwen2_5_3b
from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as jamba_1_5_large_398b
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from repro_torch.configs.llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from repro_torch.configs.gemma_2b import CONFIG as gemma_2b
from repro_torch.configs.falcon_mamba_7b import CONFIG as falcon_mamba_7b
from repro_torch.configs.mistral_nemo_12b import CONFIG as mistral_nemo_12b

REGISTRY = {
    c.name: c
    for c in (
        deepseek_v2_lite_16b,
        musicgen_medium,
        qwen2_5_3b,
        granite_34b,
        jamba_1_5_large_398b,
        granite_moe_3b_a800m,
        llava_next_mistral_7b,
        gemma_2b,
        falcon_mamba_7b,
        mistral_nemo_12b,
    )
}


def get_config(name: str):
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["REGISTRY", "get_config", "reduced", "with_sliding_window"]
