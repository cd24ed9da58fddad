"""Model definitions over the param-spec system (``params.py``): the
paper's three physics encoders (``physics.py``) on dense GQA blocks, and the
LM zoo (``lm.py``: dense, MoE, MLA, ``ssm`` and ``hybrid`` causal LMs, the
audio encoder and the VLM, re-exported by ``encoder.py`` and ``vlm.py``)."""

from repro_torch.models import (  # noqa: F401
    attention,
    blocks,
    layers,
    mlp,
    params,
    physics,
)
