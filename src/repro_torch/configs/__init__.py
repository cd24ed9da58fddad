"""Config registry: ``get_config(name, reduced=False)`` for the paper's
physics models and the JAX package's whole LM zoo: the dense GQA family
(``granite-8b``, ``minicpm-2b``, ``starcoder2-7b``), the MLA model
``minicpm3-4b``, ``mamba2-130m``, the MoE family (``granite-moe-3b-a800m``,
``dbrx-132b``), the hybrid ``zamba2-1.2b``, the VLM ``internvl2-1b`` and the
audio encoder ``hubert-xlarge``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    dbrx_132b,
    granite_8b,
    granite_moe_3b,
    hubert_xlarge,
    internvl2_1b,
    mamba2_130m,
    minicpm3_4b,
    minicpm_2b,
    physics,
    starcoder2_7b,
    zamba2_1_2b,
)
from repro_torch.configs.base import (  # noqa: F401
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ParallelismConfig,
    ServeConfig,
    SSMConfig,
    TrainConfig,
)

_PHYSICS = {
    "engine_anomaly": physics.engine_anomaly,
    "btagging": physics.btagging,
    "gw": physics.gw,
}

PHYSICS_NAMES = list(_PHYSICS)

_ARCH_MODULES = {
    "minicpm-2b": minicpm_2b,
    "minicpm3-4b": minicpm3_4b,
    "granite-8b": granite_8b,
    "starcoder2-7b": starcoder2_7b,
    "dbrx-132b": dbrx_132b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "mamba2-130m": mamba2_130m,
    "zamba2-1.2b": zamba2_1_2b,
    "internvl2-1b": internvl2_1b,
    "hubert-xlarge": hubert_xlarge,
}

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name in _PHYSICS:
        return _PHYSICS[name]()
    if name in _ARCH_MODULES:
        mod = _ARCH_MODULES[name]
        if reduced:  # reduced smoke configs run on the CPU in float32
            return dataclasses.replace(mod.reduced_config(), dtype="float32")
        return mod.config()
    raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES + PHYSICS_NAMES}")
