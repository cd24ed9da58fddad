"""Config registry: ``get_config(name)`` for the paper's physics models.

The LM zoo configs wait for the LM slice (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from repro_torch.configs import physics
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


def get_config(name: str) -> ModelConfig:
    if name in _PHYSICS:
        return _PHYSICS[name]()
    raise NotImplementedError(
        f"config {name!r} is not ported yet: the port has the physics models "
        f"{PHYSICS_NAMES}; the LM zoo comes with ROADMAP queue 1, item 4"
    )
