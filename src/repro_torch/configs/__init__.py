"""Config registry: ``get_config(name, reduced=False)`` for the paper's
physics models and the LM configs ported so far: the dense GQA family
(``granite-8b``, ``minicpm-2b``, ``starcoder2-7b``), the MLA model
``minicpm3-4b``, ``mamba2-130m`` and the MoE family
(``granite-moe-3b-a800m``, ``dbrx-132b``).

The rest of the LM zoo waits for its slices: ROADMAP queue 1, items 9.2-9.3
(the VLM and audio frontends: ``internvl2-1b``, ``hubert-xlarge``) and
item 10 (hybrid: ``zamba2-1.2b``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    dbrx_132b,
    granite_8b,
    granite_moe_3b,
    mamba2_130m,
    minicpm3_4b,
    minicpm_2b,
    physics,
    starcoder2_7b,
)
from repro_torch.configs.base import (  # noqa: F401
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
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
}

ARCH_NAMES = list(_ARCH_MODULES)

# the JAX package's other configs, by the ROADMAP queue 1 item that ports them
_UNPORTED = {
    "zamba2-1.2b": 10,
    "internvl2-1b": 9,
    "hubert-xlarge": 9,
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name in _PHYSICS:
        return _PHYSICS[name]()
    if name in _ARCH_MODULES:
        mod = _ARCH_MODULES[name]
        if reduced:  # reduced smoke configs run on the CPU in float32
            return dataclasses.replace(mod.reduced_config(), dtype="float32")
        return mod.config()
    if name in _UNPORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ROADMAP queue 1, item {_UNPORTED[name]}); "
            f"the port has the physics models {PHYSICS_NAMES} and {ARCH_NAMES}"
        )
    raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES + PHYSICS_NAMES}")
