"""Optimizer and learning-rate schedules (port of ``repro.optim``)."""

from repro_torch.optim.adamw import AdamW, global_norm  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    cosine_schedule,
    linear_schedule,
    make_schedule,
    warmup,
    wsd_schedule,
)
