"""Model definitions over the param-spec system (``params.py``): the
paper's three physics encoders (``physics.py``) on dense GQA blocks."""

from repro_torch.models import (  # noqa: F401
    attention,
    blocks,
    layers,
    mlp,
    params,
    physics,
)
