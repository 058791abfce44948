"""Model zoo: the config-driven decoder, dense-attention family.

Not in the port yet (ROADMAP.md Queue 1 item 13): MLA, MoE (and
``moe_ep``), Mamba, the decode forms (``init_cache``, ``decode_step``)
and the mesh partition specs (``models/sharding.py``); building such a
layer raises ``NotImplementedError``.
"""

from repro_torch.models.config import ArchConfig, LayerSpec, MLAConfig, MambaConfig, MoEConfig
from repro_torch.models.init import init_params, param_pspecs, params_from_numpy, params_to_numpy
from repro_torch.models.transformer import forward, lm_loss

__all__ = [
    "ArchConfig",
    "LayerSpec",
    "MLAConfig",
    "MambaConfig",
    "MoEConfig",
    "init_params",
    "param_pspecs",
    "params_from_numpy",
    "params_to_numpy",
    "forward",
    "lm_loss",
]
