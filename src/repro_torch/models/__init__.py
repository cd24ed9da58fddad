"""Model definitions over the param-spec system (``params.py``): the
paper's three physics encoders (``physics.py``) on dense GQA blocks, and the
causal LMs (``lm.py``) of the dense and ``ssm`` families."""

from repro_torch.models import (  # noqa: F401
    attention,
    blocks,
    layers,
    mlp,
    params,
    physics,
)
