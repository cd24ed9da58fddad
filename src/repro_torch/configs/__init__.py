"""Config registry: ``get_config(name, reduced=False)`` for the paper's
physics models and the JAX package's whole LM zoo: the dense GQA family
(``granite-8b``, ``minicpm-2b``, ``starcoder2-7b``), the MLA model
``minicpm3-4b``, ``mamba2-130m``, the MoE family (``granite-moe-3b-a800m``,
``dbrx-132b``), the hybrid ``zamba2-1.2b``, the VLM ``internvl2-1b`` and the
audio encoder ``hubert-xlarge``; and which (arch x shape) dry-run cells
run (``cell_status``, ``dryrun_cells``).
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
    SHAPES,
    ServeConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
)

_PHYSICS = {
    "engine_anomaly": physics.engine_anomaly,
    "btagging": physics.btagging,
    "gw": physics.gw,
}

PHYSICS_NAMES = list(_PHYSICS)

_ARCH_MODULES = {  # the reference's order (the dry-run matrix's)
    "minicpm3-4b": minicpm3_4b,
    "minicpm-2b": minicpm_2b,
    "granite-8b": granite_8b,
    "starcoder2-7b": starcoder2_7b,
    "dbrx-132b": dbrx_132b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "zamba2-1.2b": zamba2_1_2b,
    "mamba2-130m": mamba2_130m,
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


# ---------------------------------------------------------------------------
# Dry-run cell applicability (the reference's)
# ---------------------------------------------------------------------------

# archs whose decode cost per token is sub-quadratic in context length:
# SSM (O(1) state), hybrid (SSM + O(L) shared-attn reads), sliding-window
# (O(window) rolling buffer).
_LONG_CONTEXT_OK = {"mamba2-130m", "zamba2-1.2b", "starcoder2-7b"}
_ENCODER_ONLY = {"hubert-xlarge"}


def cell_status(arch: str, shape_name: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch x shape) cell."""
    shape = SHAPES[shape_name]
    if arch in _ENCODER_ONLY and shape.kind == "decode":
        return False, "encoder-only: no decode step"
    if shape_name == "long_500k" and arch not in _LONG_CONTEXT_OK:
        return False, "pure full attention: 512k decode needs sub-quadratic attention"
    return True, ""


def dryrun_cells() -> list[tuple[str, str, bool, str]]:
    """All 40 (arch x shape) cells with runnability + skip reason."""
    return [(arch, shape_name, *cell_status(arch, shape_name))
            for arch in ARCH_NAMES for shape_name in SHAPES]
