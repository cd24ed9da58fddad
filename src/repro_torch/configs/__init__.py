"""Config registry: ``get_config(name, reduced=False)`` for the paper's
physics models and the LM configs ported so far (``mamba2-130m``).

The rest of the LM zoo waits for its slices (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import mamba2_130m, physics
from repro_torch.configs.base import (  # noqa: F401
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

_PHYSICS = {
    "engine_anomaly": physics.engine_anomaly,
    "btagging": physics.btagging,
    "gw": physics.gw,
}

PHYSICS_NAMES = list(_PHYSICS)

_ARCH_MODULES = {"mamba2-130m": mamba2_130m}

ARCH_NAMES = list(_ARCH_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name in _PHYSICS:
        return _PHYSICS[name]()
    if name in _ARCH_MODULES:
        mod = _ARCH_MODULES[name]
        if reduced:  # reduced smoke configs run on the CPU in float32
            return dataclasses.replace(mod.reduced_config(), dtype="float32")
        return mod.config()
    raise NotImplementedError(
        f"config {name!r} is not ported yet: the port has the physics models "
        f"{PHYSICS_NAMES} and {ARCH_NAMES}; the rest of the LM zoo comes with "
        "ROADMAP queue 1, item 4"
    )
