"""Model zoo: the config-driven decoder for every registry config —
attention (GQA/MQA, sliding window), MLA, MoE and Mamba-1 layers — with
its training forward, LM loss and single-token decode (``init_cache``,
``decode_step``); on a model mesh the partition specs (``param_pspecs``,
``models/sharding.py``) and the expert-parallel MoE (``models/moe_ep.py``).
"""

from repro_torch.models.config import ArchConfig, LayerSpec, MLAConfig, MambaConfig, MoEConfig
from repro_torch.models.init import (
    distribute_params, gather_params, init_params, param_pspecs, params_from_numpy, params_to_numpy,
)
from repro_torch.models.transformer import decode_step, forward, init_cache, lm_loss

__all__ = [
    "ArchConfig",
    "LayerSpec",
    "MLAConfig",
    "MambaConfig",
    "MoEConfig",
    "init_params",
    "param_pspecs",
    "distribute_params",
    "gather_params",
    "params_from_numpy",
    "params_to_numpy",
    "forward",
    "lm_loss",
    "init_cache",
    "decode_step",
]
