from repro_torch.data.physics import (  # noqa: F401
    GENERATORS,
    btagging_data,
    engine_anomaly_data,
    gw_data,
)
