"""Data (port of ``repro.data``): the paper's three synthetic physics
datasets and their AUC metrics, the synthetic LM token stream and the
prefetching loader; numpy generators, so a seed gives the reference's data."""

from repro_torch.data.loader import PrefetchLoader  # noqa: F401
from repro_torch.data.physics import (  # noqa: F401
    GENERATORS,
    auc_score,
    btagging_data,
    engine_anomaly_data,
    gw_data,
    multiclass_auc,
)
from repro_torch.data.synthetic import SyntheticLM, SyntheticLMConfig  # noqa: F401
